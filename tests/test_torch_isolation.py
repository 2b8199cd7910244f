"""The port stands alone and never falls back to the CPU on its own.

- Every module of difacto_tpu_torch imports with ``jax`` and
  ``difacto_tpu`` poisoned in ``sys.meta_path`` (a fresh interpreter, so
  nothing is already cached).
- An entry point called without ``device=`` on a box with no CUDA raises
  instead of running on the CPU, ``task=train`` included.
- A CPU tensor takes the plain gather and the plain push, and the CUDA
  kernels' launch counters stay 0, also through the replay cache.
- The JAX package's default training (the dictionary store, the replay
  cache with the chunked backward, the flat table), its checkpoints and
  task=pred run in an interpreter where jax cannot be imported; so do
  task=convert, training from the rec cache on worker processes and
  task=dump, and the convert and producer worker processes import
  neither jax nor torch, and load the native parsers.
- The batch learners (BCD, L-BFGS, their tile cache and checkpoints) run
  there too, launch no kernel, and raise without a device on a box with
  no CUDA.
- The capacity levers (admission on worker processes that still import
  neither torch nor jax, the cold tier, eviction) and the durability legs
  (the WAL with bf16 rows, replicas, the recovery ladder) run there too.
- The router, the autoscaler and the fleet tools import and run there
  too, with the repo's ``launch.py`` poisoned as well: a router round
  trip, the load generator, a rolling restart, a ``#backends`` nudge and
  an autoscaler step.
``ml_dtypes`` is poisoned beside jax: the card machine need not have it.
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from difacto_tpu_torch.ops import fused
from difacto_tpu_torch.updaters.sgd_updater import SGDUpdaterParam

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)


def test_port_imports_without_jax_or_reference_package():
    code = textwrap.dedent("""
        import importlib, pkgutil, sys

        class Poison:
            def find_spec(self, name, path=None, target=None):
                top = name.split(".")[0]
                if top in ("jax", "jaxlib", "difacto_tpu", "ml_dtypes"):
                    raise ImportError(f"poisoned import: {name}")
                return None

        sys.meta_path.insert(0, Poison())
        import difacto_tpu_torch
        names = [m.name for m in pkgutil.walk_packages(
            difacto_tpu_torch.__path__, "difacto_tpu_torch.")]
        for n in names:
            importlib.import_module(n)
        bad = [m for m in sys.modules
               if m.split(".")[0] in ("jax", "jaxlib", "difacto_tpu", "ml_dtypes")]
        assert not bad, bad
        print(len(names))
    """)
    env = dict(os.environ, PYTHONPATH=_ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=_ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 20   # every module was walked


def test_entry_points_without_device_raise_on_a_box_without_cuda(
        monkeypatch, tmp_path):
    from difacto_tpu_torch.__main__ import main
    from difacto_tpu_torch.serve import open_serving_store
    from difacto_tpu_torch.store.convert import state_from_numpy
    from difacto_tpu_torch.store.local import SlotStore

    param = SGDUpdaterParam(V_dim=2, hash_capacity=64)
    path = str(tmp_path / "m_part-0")
    SlotStore(param, device="cpu").save(path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SlotStore(param)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        open_serving_store(path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        state_from_numpy(param, {"w": np.zeros(64, np.float32)})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["task=pred", f"model_in={path}", "data_in=unused"])
    # the explicit CPU request runs
    store, _, _ = open_serving_store(path, device="cpu")
    assert store.device.type == "cpu"


def test_cpu_tensor_takes_plain_gather_and_counts_no_launch():
    before = fused.gather_rows_cuda.launches
    table = torch.arange(64 * 8, dtype=torch.float32).reshape(64, 8)
    slots = torch.tensor([1, 7, 64, 65], dtype=torch.int32)
    out = fused.gather_rows(table, slots)
    torch.testing.assert_close(out, fused.gather_rows_ref(table, slots),
                               rtol=0, atol=0)
    assert torch.count_nonzero(out[2:]) == 0
    assert fused.gather_rows_cuda.launches == before == 0
    # the kernel wrapper refuses a CPU table instead of copying it over
    with pytest.raises(ValueError, match="CUDA"):
        fused.gather_rows_cuda(table, slots)
    assert fused.gather_rows_cuda.launches == 0


_RCV1 = os.path.join(_ROOT, "tests", "data", "rcv1_100.libsvm")


def test_train_without_device_raises_on_a_box_without_cuda(monkeypatch,
                                                           tmp_path):
    from difacto_tpu_torch.__main__ import main
    from difacto_tpu_torch.learners.sgd import SGDLearner
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["task=train", f"data_in={_RCV1}", "V_dim=2",
            "hash_capacity=4096", f"model_out={tmp_path / 'm'}"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(argv)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SGDLearner().init([("data_in", _RCV1), ("V_dim", "2"),
                           ("hash_capacity", "4096")])
    assert not (tmp_path / "m_part-0").exists()
    # the explicit CPU request trains
    assert main(argv + ["device=cpu", "max_num_epochs=1"]) == 0
    assert (tmp_path / "m_part-0").exists()


def test_cpu_table_takes_plain_push_and_counts_no_launch():
    from difacto_tpu_torch.updaters import sgd_updater as T
    param = T.SGDUpdaterParam(V_dim=4, hash_capacity=64)
    state = T.init_state(param, 64, torch.device("cpu"))
    fns = T.make_fns(param)
    slots = torch.tensor([1, 5, 64, 65], dtype=torch.int32)
    counters = (fused.scatter_rows_cuda, fused.fm_update_rows_cuda,
                fused.gather_rows_cuda)
    launched = [c.launches for c in counters]
    before = state.VVg.clone()
    state = fns.apply_count(state, slots, torch.ones(4))
    rows = fns.pull_rows(state, slots)
    state = fns.apply_grad_rows(state, slots, rows, torch.full((4,), 0.5),
                                torch.full((4, 4), 0.1), torch.ones(4))
    changed = (state.VVg != before).any(dim=1).nonzero().flatten().tolist()
    assert changed == [1, 5]
    assert [c.launches for c in counters] == launched
    # the kernel wrappers refuse a CPU table instead of copying it over
    with pytest.raises(ValueError, match="CUDA"):
        fused.scatter_rows_cuda(state.VVg, slots, rows)
    with pytest.raises(ValueError, match="CUDA"):
        fused.fm_update_rows_cuda(state.VVg, slots, rows, torch.zeros(4),
                                  torch.zeros(4, 4), torch.ones(4),
                                  T.epilogue_spec(param, 64))
    assert [c.launches for c in counters] == launched


def test_default_training_runs_with_jax_poisoned(tmp_path):
    """The slice's paths in an interpreter that cannot import jax or
    difacto_tpu: the dictionary store growing from a small table, the
    replay cache with its chunked panel backward, the flat V_dim=0 table,
    checkpoints and task=pred, all on the CPU."""
    from chip_smoke import synthetic_criteo
    data = tmp_path / "criteo.txt"
    data.write_bytes(synthetic_criteo(300, 3))
    code = textwrap.dedent(f"""
        import sys

        class Poison:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in ("jax", "jaxlib", "difacto_tpu", "ml_dtypes"):
                    raise ImportError(f"poisoned import: {{name}}")
                return None

        sys.meta_path.insert(0, Poison())
        from difacto_tpu_torch.__main__ import main
        from difacto_tpu_torch.learners.sgd import SGDLearner
        ln = SGDLearner(device="cpu")
        ln.init([("data_in", {str(data)!r}), ("data_format", "criteo"),
                 ("V_dim", "4"), ("batch_size", "50"),
                 ("init_capacity", "64"), ("max_num_epochs", "2"),
                 ("report_interval", "0"),
                 ("model_out", {str(tmp_path / 'm')!r})])
        ln.run()
        info = ln.device_cache_info()
        assert info[3]["complete"], info
        assert ln.store.state.capacity > 64
        assert main(["task=pred", "device=cpu", "data_format=criteo",
                     "model_in={tmp_path / 'm'}",
                     "data_in={data}"]) == 0
        assert main(["examples/local.conf", "device=cpu",
                     "max_num_epochs=2"]) == 0
        bad = [m for m in sys.modules
               if m.split(".")[0] in ("jax", "jaxlib", "difacto_tpu", "ml_dtypes")]
        assert not bad, bad
        print("ok")
    """)
    env = dict(os.environ, PYTHONPATH=_ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=_ROOT, env=env,
                         capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.split()[-1] == "ok"


def test_cpu_replay_run_counts_no_launch(tmp_path):
    """A CPU run through the replay cache and the dictionary's growth
    takes the plain versions only: every kernel counter stays 0."""
    from difacto_tpu_torch.learners.sgd import SGDLearner
    counters = (fused.gather_rows_cuda, fused.scatter_rows_cuda,
                fused.fm_update_rows_cuda)
    before = [c.launches for c in counters]
    ln = SGDLearner(device="cpu")
    ln.init([("data_in", _RCV1), ("V_dim", "2"), ("init_capacity", "32"),
             ("max_num_epochs", "3"), ("report_interval", "0")])
    ln.run()
    assert ln.device_cache_info()[3]["complete"]
    assert [c.launches for c in counters] == before == [0, 0, 0]


_PROBE = '''
import sys


class Poison:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "difacto_tpu", "ml_dtypes"):
            raise ImportError(f"poisoned import: {name}")
        return None


sys.meta_path.insert(0, Poison())


def probe(spec, part):
    from difacto_tpu_torch.data.pack_stream import spec_iter
    n = sum(1 for _ in spec_iter(spec, part))
    yield ("batches", n)
    yield ("modules", sorted({m.split(".")[0] for m in sys.modules
                              if m.split(".")[0] in ("jax", "jaxlib",
                                                     "difacto_tpu",
                                                     "ml_dtypes",
                                                     "torch")}))


def probe_convert(spec, part):
    from difacto_tpu_torch.data.converter import convert_part_iter
    from difacto_tpu_torch.native import get_lib
    n = sum(1 for _ in convert_part_iter(spec, part))
    yield ("members", n)
    yield ("native", get_lib() is not None)
    yield ("modules", sorted({m.split(".")[0] for m in sys.modules
                              if m.split(".")[0] in ("jax", "jaxlib",
                                                     "difacto_tpu",
                                                     "ml_dtypes",
                                                     "torch")}))
'''


def test_spawned_producer_workers_import_no_jax(tmp_path):
    """A producer worker process runs the hashed pack pipeline
    (``spec_iter``) with jax and difacto_tpu poisoned in its own
    interpreter, and imports neither, nor torch: it packs with numpy and
    never opens a CUDA context. The learner's process mode runs in a
    parent where jax is poisoned as well."""
    from chip_smoke import synthetic_criteo
    data = tmp_path / "criteo.txt"
    data.write_bytes(synthetic_criteo(300, 5))
    (tmp_path / "worker_probe.py").write_text(_PROBE)
    code = textwrap.dedent(f"""
        import functools, sys
        sys.path.insert(0, {str(tmp_path)!r})
        import worker_probe  # poisons jax in this parent too
        from difacto_tpu_torch.data.pack_stream import StreamSpec
        from difacto_tpu_torch.data.producer_pool import ProcessProducerPool

        if __name__ == "__main__":   # spawn re-runs this file in workers
            from difacto_tpu_torch.learners.sgd import SGDLearner
            spec = StreamSpec(parts=(0, 1), n_jobs=2, data_in={str(data)!r},
                              data_format="criteo", batch_size=50,
                              shuffle=10, neg_sampling=1.0, epoch=1,
                              hash_capacity=4096, want_counts=False,
                              fill_counts=False, dim_min=8, job="train",
                              b_cap=56, device_dedup=True)
            got = [item for _, item in ProcessProducerPool(
                2, functools.partial(worker_probe.probe, spec), n_workers=2,
                slot_bytes=1 << 20, join_timeout=60.0)]
            assert [k for k, _ in got] == ["batches", "modules"] * 2, got
            assert all(n > 0 for k, n in got if k == "batches"), got
            assert all(m == [] for k, m in got if k == "modules"), got
            ln = SGDLearner(device="cpu")
            ln.init([("data_in", {str(data)!r}), ("data_format", "criteo"),
                     ("V_dim", "2"), ("hash_capacity", "4096"),
                     ("batch_size", "50"), ("num_jobs_per_epoch", "2"),
                     ("max_num_epochs", "2"), ("device_cache_mb", "0"),
                     ("device_dedup", "1"), ("num_producers", "2"),
                     ("producer_mode", "process"),
                     ("report_interval", "0")])
            ln.run()
            assert ln.stage_stats()["producer_mode"] == "process"
            bad = [m for m in sys.modules
                   if m.split(".")[0] in ("jax", "jaxlib", "difacto_tpu", "ml_dtypes")]
            assert not bad, bad
            print("ok")
    """)
    script = tmp_path / "run_probe.py"
    script.write_text(code)
    env = dict(os.environ, PYTHONPATH=_ROOT)
    out = subprocess.run([sys.executable, str(script)], cwd=_ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.split()[-1] == "ok"


def test_convert_cache_and_dump_run_with_jax_poisoned(tmp_path):
    """The slice's new paths in a parent that cannot import jax or
    difacto_tpu: convert workers (``convert_part_iter``) and producer
    workers reading the cache (``spec_iter`` with ``cached_uri``) import
    neither, nor torch, and load the native parsers; the learner trains
    from the cache on worker processes; task=convert (two workers) and
    task=dump run."""
    from chip_smoke import synthetic_criteo
    data = tmp_path / "criteo.txt"
    data.write_bytes(synthetic_criteo(300, 6))
    (tmp_path / "worker_probe.py").write_text(_PROBE)
    cache, model = str(tmp_path / "c.rec"), str(tmp_path / "m")
    code = textwrap.dedent(f"""
        import dataclasses, functools, os, sys
        sys.path.insert(0, {str(tmp_path)!r})
        import worker_probe  # poisons jax in this parent too
        from difacto_tpu_torch.data.converter import _ConvertSpec
        from difacto_tpu_torch.data.pack_stream import StreamSpec
        from difacto_tpu_torch.data.producer_pool import ProcessProducerPool

        def run(fn, spec):
            return [item for _, item in ProcessProducerPool(
                2, functools.partial(fn, spec), n_workers=2,
                slot_bytes=1 << 20, join_timeout=60.0)]

        if __name__ == "__main__":   # spawn re-runs this file in workers
            from difacto_tpu_torch.__main__ import main
            from difacto_tpu_torch.learners.sgd import SGDLearner
            os.makedirs({cache!r})
            got = run(worker_probe.probe_convert, _ConvertSpec(
                data_in={str(data)!r}, data_format="criteo",
                out_dir={cache!r}, member_suffix=".rec2", member_rows=50,
                rec_localize=True, rec_compress=False,
                chunk_bytes=1 << 20, n_parts=2))
            assert [k for k, _ in got] == ["members", "native",
                                           "modules"] * 2, got
            assert all(v for k, v in got if k in ("members", "native"))
            assert all(m == [] for k, m in got if k == "modules"), got
            spec = StreamSpec(parts=(0, 1), n_jobs=2, data_in="",
                              data_format="rec", batch_size=50,
                              shuffle=10, neg_sampling=1.0, epoch=0,
                              hash_capacity=4096, want_counts=True,
                              fill_counts=True, dim_min=8, job="train",
                              b_cap=56, cached_uri={cache!r})
            got = run(worker_probe.probe, spec)
            assert all(n > 0 for k, n in got if k == "batches"), got
            assert all(m == [] for k, m in got if k == "modules"), got
            assert main(["task=convert", "data_in={data}",
                         "data_format=criteo", "data_out={cache}2",
                         "data_out_format=rec", "convert_procs=2",
                         "batch_size=50"]) == 0
            ln = SGDLearner(device="cpu")
            ln.init([("data_in", {cache + "2"!r}), ("data_format", "rec"),
                     ("V_dim", "2"), ("hash_capacity", "4096"),
                     ("batch_size", "50"), ("num_jobs_per_epoch", "2"),
                     ("max_num_epochs", "2"), ("device_cache_mb", "0"),
                     ("num_producers", "2"), ("producer_mode", "process"),
                     ("report_interval", "0"), ("has_aux", "1"),
                     ("model_out", {model!r})])
            ln.run()
            assert ln.stage_stats()["producer_mode"] == "process"
            assert main(["task=dump", "device=cpu", "model_in={model}_part-0",
                         "hash_capacity=4096",
                         "name_dump={model}.tsv"]) == 0
            assert os.path.getsize({model + ".tsv"!r}) > 0
            bad = [m for m in sys.modules
                   if m.split(".")[0] in ("jax", "jaxlib", "difacto_tpu", "ml_dtypes")]
            assert not bad, bad
            print("ok")
    """)
    script = tmp_path / "run_cache_probe.py"
    script.write_text(code)
    env = dict(os.environ, PYTHONPATH=_ROOT)
    out = subprocess.run([sys.executable, str(script)], cwd=_ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.split()[-1] == "ok"


def test_batch_learners_run_with_jax_poisoned_and_count_no_launch(
        tmp_path):
    """The batch learners (examples/bcd.conf, examples/lbfgs.conf, an FM
    L-BFGS warm-started from its own checkpoint, the tile builder and
    cache, logit_delta, kv, twoloop) in an interpreter that cannot import
    jax or difacto_tpu, on the CPU; neither path launches a kernel of the
    port."""
    m = str(tmp_path / "fm")
    code = textwrap.dedent(f"""
        import sys

        class Poison:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in ("jax", "jaxlib", "difacto_tpu", "ml_dtypes"):
                    raise ImportError(f"poisoned import: {{name}}")
                return None

        sys.meta_path.insert(0, Poison())
        from difacto_tpu_torch.__main__ import main
        from difacto_tpu_torch.ops import fused
        assert main(["examples/bcd.conf", "device=cpu",
                     "max_num_epochs=3"]) == 0
        assert main(["examples/lbfgs.conf", "device=cpu",
                     "max_num_epochs=3"]) == 0
        fm = ["examples/lbfgs.conf", "device=cpu", "V_dim=3", "l2=0.1",
              "max_num_epochs=2", "tile_cache_mb=1"]
        assert main(fm + ["model_out={m}"]) == 0
        assert main(fm + ["model_in={m}"]) == 0
        assert (fused.gather_rows_cuda.launches
                + fused.fm_update_rows_cuda.launches
                + fused.scatter_rows_cuda.launches) == 0
        bad = [m for m in sys.modules
               if m.split(".")[0] in ("jax", "jaxlib", "difacto_tpu", "ml_dtypes")]
        assert not bad, bad
        print("ok")
    """)
    env = dict(os.environ, PYTHONPATH=_ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=_ROOT, env=env,
                         capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.split()[-1] == "ok"


@pytest.mark.parametrize("learner", ["bcd", "lbfgs"])
def test_batch_learner_without_device_raises_on_a_box_without_cuda(
        monkeypatch, learner):
    from difacto_tpu_torch.__main__ import main
    from difacto_tpu_torch.learners.base import Learner
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    conf = os.path.join(_ROOT, "examples", f"{learner}.conf")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main([conf])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Learner.create(learner).init([("data_in", _RCV1), ("V_dim", "0")])
    assert main([conf, "device=cpu", "max_num_epochs=1"]) == 0


def test_capacity_and_durability_run_with_jax_poisoned(tmp_path):
    """Admission on worker processes (which import neither torch nor jax),
    the cold tier with eviction, then a bf16 table with the WAL and a peer
    replica, resumed through the recovery ladder after a disk loss, in an
    interpreter where jax, difacto_tpu and ml_dtypes cannot be imported;
    no kernel launches on the CPU."""
    from chip_smoke import synthetic_criteo
    data = tmp_path / "criteo.txt"
    data.write_bytes(synthetic_criteo(300, 9))
    (tmp_path / "worker_probe.py").write_text(_PROBE)
    code = textwrap.dedent(f"""
        import functools, glob, json, os, shutil, sys
        sys.path.insert(0, {str(tmp_path)!r})
        import worker_probe  # poisons jax in this parent too
        from difacto_tpu_torch.data.pack_stream import StreamSpec
        from difacto_tpu_torch.data.producer_pool import ProcessProducerPool

        if __name__ == "__main__":   # spawn re-runs this file in workers
            from difacto_tpu_torch.learners.sgd import SGDLearner
            from difacto_tpu_torch.ops import fused
            spec = StreamSpec(parts=(0, 1), n_jobs=2, data_in={str(data)!r},
                              data_format="criteo", batch_size=50,
                              shuffle=10, neg_sampling=1.0, epoch=1,
                              hash_capacity=4096, want_counts=False,
                              fill_counts=False, dim_min=8, job="train",
                              b_cap=56, admit_min_count=2, admit_seed=3)
            got = [item for _, item in ProcessProducerPool(
                2, functools.partial(worker_probe.probe, spec), n_workers=2,
                slot_bytes=1 << 20, join_timeout=60.0)]
            assert all(m == [] for k, m in got if k == "modules"), got
            common = [("data_in", {str(data)!r}), ("data_format", "criteo"),
                      ("V_dim", "4"), ("hash_capacity", "4096"),
                      ("batch_size", "50"), ("num_jobs_per_epoch", "2"),
                      ("max_num_epochs", "2"), ("report_interval", "0")]
            ln = SGDLearner(device="cpu")
            ln.init(common + [("cold_tier_rows", "2048"),
                              ("admit_min_count", "2"),
                              ("evict_occupancy", "0.2"),
                              ("producer_mode", "process"),
                              ("num_producers", "2")])
            ln.run()
            assert ln.store.tier.calls["evict"] > 0, ln.store.tier.calls
            m = os.path.join({str(tmp_path)!r}, "m")
            peer = os.path.join({str(tmp_path)!r}, "peer")
            args = common + [("slot_dtype", "bf16"), ("model_out", m),
                             ("wal_flush_batches", "2"),
                             ("ckpt_interval", "1"), ("auto_resume", "1"),
                             ("replica_peers", peer)]
            ln = SGDLearner(device="cpu")
            ln.init(args)
            ln.run()
            ref = open(m + "_part-0", "rb").read()
            shutil.rmtree(m + ".wal")
            for f in glob.glob(m + "*"):
                os.remove(f)
            ln = SGDLearner(device="cpu")
            ln.init(args)
            ln.run()
            stamp = json.load(open(m + ".recovery.json"))
            assert "peer" in stamp["rungs"], stamp
            assert [c.launches for c in (fused.gather_rows_cuda,
                                         fused.scatter_rows_cuda,
                                         fused.fm_update_rows_cuda)] == [0] * 3
            bad = [m for m in sys.modules if m.split(".")[0] in
                   ("jax", "jaxlib", "difacto_tpu", "ml_dtypes")]
            assert not bad, bad
            print("ok")
    """)
    script = tmp_path / "run_probe.py"
    script.write_text(code)
    env = dict(os.environ, PYTHONPATH=_ROOT)
    out = subprocess.run([sys.executable, str(script)], cwd=_ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.split()[-1] == "ok"


_LIFECYCLE = ("difacto_tpu_torch.serve.reload", "difacto_tpu_torch.serve.client",
              "difacto_tpu_torch.serve.fleet",
              "difacto_tpu_torch.serve.fleethealth",
              "difacto_tpu_torch.online", "difacto_tpu_torch.online.log",
              "difacto_tpu_torch.online.tail",
              "difacto_tpu_torch.online.loop",
              "difacto_tpu_torch.online.trainer",
              "difacto_tpu_torch.utils.reporter")


def test_serve_lifecycle_and_online_loop_run_with_jax_poisoned(tmp_path):
    """The serve lifecycle and the online loop in an interpreter that
    cannot import jax or difacto_tpu: every new module imports; a server
    with an online log scores ``#score`` rows and joins ``#label``s, the
    tailing trainer trains the sealed log on the CPU and pushes its
    generation back as ``#reload``; a blue/green ``#reload``, ``#metrics``
    and a drain follow, and no kernel launches."""
    code = textwrap.dedent(f"""
        import importlib, json, socket, sys, threading

        class Poison:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in ("jax", "jaxlib", "difacto_tpu", "ml_dtypes"):
                    raise ImportError(f"poisoned import: {{name}}")
                return None

        sys.meta_path.insert(0, Poison())
        for n in {_LIFECYCLE!r}:
            importlib.import_module(n)
        from difacto_tpu_torch.ops import fused
        from difacto_tpu_torch.online import (OnlineLog, OnlineParam,
                                              OnlineTrainer)
        from difacto_tpu_torch.serve import (ModelReloader, ServeClient,
                                             ServeServer, open_serving_store)
        from difacto_tpu_torch.store.local import SlotStore
        from difacto_tpu_torch.updaters.sgd_updater import SGDUpdaterParam
        d = {str(tmp_path)!r}
        SlotStore(SGDUpdaterParam(V_dim=2, hash_capacity=512),
                  device="cpu").save(d + "/start_part-0")
        SlotStore(SGDUpdaterParam(V_dim=4, hash_capacity=256),
                  device="cpu").save(d + "/green_part-0")
        olog = OnlineLog(d + "/olog", segment_rows=10, label_delay_s=3600)
        store, _, _ = open_serving_store(d + "/start", device="cpu")
        srv = ServeServer(store, batch_size=8, max_delay_ms=1.0,
                          online_log=olog).start()
        srv.reloader = ModelReloader(srv.executor, d + "/start",
                                     server=srv)
        rows = [open({_RCV1!r}, "rb").read().splitlines()[i]
                for i in range(30)]
        with socket.create_connection((srv.host, srv.port)) as c:
            f = c.makefile("rb")
            for i, r in enumerate(rows):
                c.sendall(b"#score %d %s\\n#label %d %s\\n"
                          % (i, r, i, r.split()[0]))
                assert not f.readline().startswith(b"!")
                assert json.loads(f.readline()) == {{"ok": True}}
        olog.end()
        tr = OnlineTrainer(OnlineParam(
            online_log_dir=d + "/olog", online_ckpt_interval_s=0,
            online_endpoints=f"{{srv.host}}:{{srv.port}}"),
            [("V_dim", "2"), ("hash_capacity", "512"),
             ("batch_size", "10"), ("model_out", d + "/m")],
            device="cpu")
        assert tr.run() == 2
        assert srv.executor.generation == 2
        with ServeClient(srv.host, srv.port) as c:
            assert c.reload(d + "/green")["model_generation"] == 3
            assert None not in c.predict(rows[:5])
            assert "difacto_serve_model_generation 3" in c.metrics()
        assert srv.drain() >= 0
        assert fused.gather_rows_cuda.launches == 0
        assert fused.fm_update_rows_cuda.launches == 0
        bad = [m for m in sys.modules
               if m.split(".")[0] in ("jax", "jaxlib", "difacto_tpu", "ml_dtypes")]
        assert not bad, bad
        print("ok")
    """)
    env = dict(os.environ, PYTHONPATH=_ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=_ROOT, env=env,
                         capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.split()[-1] == "ok"


def test_serve_and_online_without_device_raise_on_a_box_without_cuda(
        monkeypatch, tmp_path):
    """task=serve and task=online called without ``device=`` refuse to
    run on the CPU of a box without CUDA, and so does a takeover's
    successor command line (it names the caller's device)."""
    from difacto_tpu_torch.__main__ import main
    from difacto_tpu_torch.serve import fleet
    from difacto_tpu_torch.store.local import SlotStore

    path = str(tmp_path / "m_part-0")
    SlotStore(SGDUpdaterParam(V_dim=2, hash_capacity=64),
              device="cpu").save(path)
    (tmp_path / "olog").mkdir()
    (tmp_path / "olog" / "log.end").write_text("end\n")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["task=serve", f"model_in={path}", "serve_max_seconds=1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["task=online", f"online_log_dir={tmp_path / 'olog'}",
              f"model_out={tmp_path / 'o'}", "V_dim=2",
              "hash_capacity=64"])
    seen = {}
    monkeypatch.setattr(fleet.subprocess, "Popen",
                        lambda args, **kw: seen.setdefault("args", args))
    fleet.spawn_successor(path, 1, str(tmp_path / "ready"))
    assert "device=cuda" in seen["args"]
    assert seen["args"][1:3] == ["-m", "difacto_tpu_torch"]


_FLEET = ("difacto_tpu_torch.serve.router", "difacto_tpu_torch.serve.autoscale",
          "difacto_tpu_torch.serve.fleet", "difacto_tpu_torch.tools",
          "difacto_tpu_torch.tools.fleet", "difacto_tpu_torch.tools.loadgen",
          "difacto_tpu_torch.tools.takeover")


def test_fleet_runs_with_jax_poisoned(tmp_path):
    """The router, the autoscaler and the fleet tools in an interpreter
    that cannot import jax, difacto_tpu or the repo's ``launch.py``: every
    module imports; a router over two CPU replicas answers a round trip
    and the load generator, a rolling restart with an in-process
    successor passes the health gate, ``notify_backends`` reaches the
    router, an autoscaler step measures the fleet, and no kernel
    launches."""
    code = textwrap.dedent(f"""
        import importlib, json, sys

        class Poison:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in ("jax", "jaxlib", "difacto_tpu",
                                          "ml_dtypes", "launch"):
                    raise ImportError(f"poisoned import: {{name}}")
                return None

        sys.meta_path.insert(0, Poison())
        for n in {_FLEET!r}:
            importlib.import_module(n)
        from difacto_tpu_torch.ops import fused
        from difacto_tpu_torch.serve import (Autoscaler, RouterServer,
                                             ServeClient, ServeServer,
                                             notify_backends,
                                             open_serving_store,
                                             run_rolling_restart)
        from difacto_tpu_torch.store.local import SlotStore
        from difacto_tpu_torch.tools.loadgen import run_loadgen
        from difacto_tpu_torch.updaters.sgd_updater import SGDUpdaterParam
        d = {str(tmp_path)!r}
        SlotStore(SGDUpdaterParam(V_dim=2, hash_capacity=512),
                  device="cpu").save(d + "/m_part-0")

        def serve(**kw):
            store, _, _ = open_serving_store(d + "/m", device="cpu")
            return ServeServer(store, takeover=True, **kw).start()

        reps = [serve(), serve()]
        eps = [(s.host, s.port) for s in reps]
        router = RouterServer(eps).start()
        rows = open({_RCV1!r}, "rb").read().splitlines()[:40]
        with ServeClient(router.host, router.port) as c:
            got = c.score_lines(rows)
            assert len(got) == 40 and not any(g.startswith(b"!")
                                              for g in got)
            assert c.health()["replicas_live"] == 2
        rep = run_loadgen(router.host, router.port, rows, qps=50,
                          duration_s=1.0)
        assert rep["err"] == 0 and rep["ok"] > 0, rep

        def spawn(i, host, port, ready_file):
            s = serve(host=host, port=port)
            s.ready_file = ready_file
            open(ready_file, "w").write(f"{{host}} {{port}}\\n")
            reps.append(s)

        roll = run_rolling_restart(eps[:1], spawn_fn=spawn, wait_s=30.0)
        assert roll["ok"], roll
        ack = notify_backends(router.host, router.port, "remove",
                              f"{{eps[1][0]}}:{{eps[1][1]}}")
        assert ack["ok"] and len(list(ack["routers"].values())[0][
            "backends"]) == 1, ack
        scaler = Autoscaler(eps[:1], lambda i: None, min_replicas=1)
        m = scaler.step()
        assert m["reachable"] == 1 and m["action"] is None, m
        router.close()
        for s in reps:
            s.close()
        assert fused.gather_rows_cuda.launches == 0
        bad = [m for m in sys.modules
               if m.split(".")[0] in ("jax", "jaxlib", "difacto_tpu",
                                      "ml_dtypes", "launch")]
        assert not bad, bad
        print("ok")
    """)
    env = dict(os.environ, PYTHONPATH=_ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=_ROOT, env=env,
                         capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.split()[-1] == "ok"
