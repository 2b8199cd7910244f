"""The port's run-time tracer (difacto_tpu_torch/utils/devtrace.py) and
``python -m difacto_tpu_torch.tools.devmap``, against the JAX package's
jaxtrace (tests/test_jaxflow.py's cases, written once for the port):

- off, every wrapper is the function it was given and nothing is
  recorded; on, signatures count per shape, Python scalars by type and
  statics by value, kernels count their launches, traced methods bind,
  and a dump survives a dump and a load;
- the CUDA sync classifier: a sync under a declared copy is declared, an
  undeclared one is charged to its innermost port frame and flagged when
  it ran under a serve dispatch;
- the serve gate side by side: tests/test_jaxflow.py:309-380's scenario
  (13 four-row blocks through MicroBatcher and PredictExecutor, a dump
  after 3) through both packages, each in a subprocess under
  ``DIFACTO_JAXTRACE=1``: a traced site in serve/executor.py, signatures
  (compiles) frozen after the warm-up while the calls grew, every copy
  at a declared point and ``serve.scores`` counted 13 times; the port's
  dumps pass ``devmap --check --warm``;
- the fetch points across the learners: a 2-epoch SGD train with the
  replay cache, BCD and L-BFGS on rcv1 under both tracers give the same
  point names and counts. The port's two extra points are JAX's
  undeclared syncs (Queue 3, "Found in the reference"): BCD's progress
  copy of the predictions and L-BFGS's two-loop Gram matrix, which the
  JAX learners fetch with a bare ``np.asarray``. The port's tables and
  objectives with tracing on equal tracing off bit for bit;
- ``to_local_numpy``/``local_rows`` against the JAX package's on one
  process, with the ``multihost.local_rows`` point counted on both;
- the AST inventory finds every devtrace call in the port, and
  ``devmap --check`` fails on a planted unknown site, an undeclared
  fetch, a signature after the warm-up and a serve sync.
"""

import collections
import json
import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from difacto_tpu.utils import jaxtrace
from difacto_tpu_torch.tools import devmap
from difacto_tpu_torch.utils import devtrace

REPO = pathlib.Path(__file__).resolve().parent.parent
RCV1 = str(REPO / "tests" / "data" / "rcv1_100.libsvm")
THIS = "tests/test_torch_devtrace.py:"


@pytest.fixture
def on(monkeypatch):
    monkeypatch.setenv("DIFACTO_JAXTRACE", "1")
    devtrace.reset()
    yield
    devtrace.reset()


def _called(sites: dict) -> dict:
    return {s: r for s, r in sites.items() if r["calls"]}


# ------------------------------------------------------------ the tracer
def test_off_every_wrapper_is_the_function_itself(monkeypatch):
    monkeypatch.delenv("DIFACTO_JAXTRACE", raising=False)
    monkeypatch.delenv("DIFACTO_HLOSCAN", raising=False)
    devtrace.reset()

    def f(x):
        return x + 1

    assert devtrace.traced(f) is f
    assert devtrace.traced(f, statics=(1,)) is f
    assert devtrace.kernel(f) is f
    t = devtrace.fetch(f(torch.ones(3)), point="unit")
    assert isinstance(t, torch.Tensor) and t.device.type == "cpu"
    d = devtrace.to_device(np.ones(2, np.float32), "cpu", point="unit")
    assert d.dtype == torch.float32
    assert _called(devtrace.sites()) == {}
    assert devtrace.fetches() == {} and devtrace.puts() == {}


WIRING = """
import json
from difacto_tpu_torch.learners.lbfgs import LBFGSLearner
from difacto_tpu_torch.ops import fused
from difacto_tpu_torch.utils import devtrace
print(json.dumps({
    "method": type(LBFGSLearner.__dict__["_tile_grad"]).__name__,
    "kernels": [hasattr(getattr(fused, c), "__wrapped__") for c in
                ("gather_rows_cuda", "scatter_rows_cuda",
                 "fm_update_rows_cuda")],
    "launches": fused.gather_rows_cuda.launches,
    "sites": sorted(r["label"] for r in devtrace.sites().values())}))
"""


@pytest.mark.parametrize("mode", ["off", "on"])
def test_the_port_wires_raw_functions_off_and_wrappers_on(mode):
    env = dict(os.environ, PYTHONPATH=str(REPO))
    env.pop("DIFACTO_HLOSCAN", None)
    env.pop("DIFACTO_JAXTRACE", None)
    if mode == "on":
        env["DIFACTO_JAXTRACE"] = "1"
    r = subprocess.run([sys.executable, "-c", WIRING], cwd=str(REPO),
                       env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    got = json.loads(r.stdout.splitlines()[-1])
    assert got["launches"] == 0
    if mode == "off":
        assert got == {"method": "function", "kernels": [False] * 3,
                       "launches": 0, "sites": []}
    else:
        assert got["method"] == "_Traced" and got["kernels"] == [True] * 3
        assert {"gather_rows_cuda", "_tile_grad", "_gram"} <= set(
            got["sites"])


def test_counts_signatures_per_shape(on):
    f = devtrace.traced(lambda x: x + 1)
    f(torch.ones(3))
    f(torch.ones(3))
    f(torch.ones(4))             # a new shape: a new signature
    rec = devtrace.sites()[f.site]
    assert f.site.startswith(THIS) and rec["kind"] == "program"
    assert rec["calls"] == 3 and rec["compiles"] == 2


def test_python_scalars_count_by_type(on):
    g = devtrace.traced(lambda x, a: x * a)
    arr = torch.ones(3)
    g(arr, 2.0)
    g(arr, 3.0)                  # a new float value: the same signature
    assert devtrace.sites()[g.site]["compiles"] == 1
    g(arr, 3)                    # an int: another type
    assert devtrace.sites()[g.site]["compiles"] == 2


def test_statics_key_by_value(on):
    def pad(x, n):
        return torch.nn.functional.pad(x, (0, n - x.shape[0]))

    h = devtrace.traced(pad, statics=(1,))
    arr = torch.ones(3)
    h(arr, 8)
    h(arr, 8)
    h(arr, 16)                   # a new static value: a new signature
    rec = devtrace.sites()[h.site]
    assert rec["calls"] == 3 and rec["compiles"] == 2
    assert len(rec["keys"]) == 2


def test_namedtuples_and_devices_key_leaf_by_leaf(on):
    from difacto_tpu_torch.learners.sgd import _Staged
    f = devtrace.traced(lambda st: st.nrows)
    a = _Staged("panel", torch.zeros(8, dtype=torch.int32), torch.zeros(8),
                2, 4, 8, 0, True, 2)
    f(a)
    f(a._replace(nrows=3))
    f(a._replace(i32=torch.zeros(16, dtype=torch.int32)))
    assert devtrace.sites()[f.site]["compiles"] == 2


def _fake_kernel(x, launch=True):
    if launch:
        _fake_kernel.launches += 1
    return x


_fake_kernel.launches = 0


def test_kernel_counts_its_launches(on, monkeypatch):
    wrapped = devtrace.kernel(_fake_kernel)
    assert wrapped is not _fake_kernel and wrapped.launches == 0
    # the entry point counts on its module-level name: the wrapper
    monkeypatch.setitem(globals(), "_fake_kernel", wrapped)
    wrapped(torch.ones(2))
    wrapped(torch.ones(2), launch=False)
    wrapped(torch.ones(5))
    (rec,) = (r for r in devtrace.sites().values()
              if r["label"] == "_fake_kernel")
    assert rec["kind"] == "kernel" and rec["calls"] == 3
    assert rec["launches"] == wrapped.launches == 2
    assert rec["compiles"] == 3      # a kwarg and a shape make new ones


def test_traced_methods_bind(on):
    class Learner:
        def __init__(self):
            self.k = 2

        @devtrace.traced
        def step(self, x):
            return x * self.k

    ln = Learner()
    assert torch.equal(ln.step(torch.ones(2)), torch.full((2,), 2.0))
    ln.step(torch.ones(2))
    (site, rec), = ((s, r) for s, r in devtrace.sites().items()
                    if r["label"] == "step")
    assert rec["calls"] == 2 and rec["compiles"] == 1
    assert isinstance(Learner.__dict__["step"], devtrace._Traced)


def test_fetch_and_put_dump_survive_a_round_trip(on, tmp_path):
    t = torch.arange(6, dtype=torch.float32)
    for _ in range(3):
        got = devtrace.fetch(t, point="unit.scores")
    assert torch.equal(got, t)
    out = torch.empty(6)
    assert devtrace.fetch(t, point="unit.out", out=out) is out
    devtrace.to_device(np.zeros(3, np.int32), "cpu", point="unit.stage")
    f = devtrace.traced(lambda x: x)
    f(t)
    path = tmp_path / "trace.json"
    devtrace.dump(path)
    doc = devtrace.load(path)
    assert doc["fetches"] == devtrace.fetches()
    assert sorted(r["point"] for r in doc["fetches"].values()) == [
        "unit.out", "unit.scores"]
    assert [r["count"] for r in doc["fetches"].values()
            if r["point"] == "unit.scores"] == [3]
    assert list(doc["puts"].values()) == [{"point": "unit.stage",
                                           "count": 1}]
    assert doc["sites"][f.site]["calls"] == 1
    assert doc["syncs"] == {} and doc["declared_syncs"] == 0
    # jaxtrace reads the same shape
    assert jaxtrace.load(path)["fetches"] == doc["fetches"]
    path.write_text(json.dumps({"version": 2}))
    with pytest.raises(ValueError):
        devtrace.load(path)


# --------------------------------------------------------- the sync detector
class _SyncingTensor:
    """Stands in for a card tensor whose copy reports a sync."""
    device = torch.device("cpu")

    def cpu(self):
        devtrace.record_sync(sys._getframe())
        return torch.zeros(1)


def test_a_sync_under_a_declared_copy_is_declared(on):
    devtrace.fetch(_SyncingTensor(), point="unit")
    assert devtrace.declared_syncs() == 1 and devtrace.syncs() == {}


def test_an_undeclared_sync_is_charged_to_its_innermost_port_frame(on):
    # code compiled under a port file name stands for a port frame
    fake = str(REPO / "difacto_tpu_torch" / "serve" / "fake_dispatch.py")
    src = "def dispatch(t):\n    return t.cpu()\n"
    ns: dict = {}
    exec(compile(src, fake, "exec"), ns)
    ns["dispatch"](_SyncingTensor())
    ns["dispatch"](_SyncingTensor())
    _SyncingTensor().cpu()           # outside the port
    got = devtrace.syncs()
    assert got["difacto_tpu_torch/serve/fake_dispatch.py:2"] == {
        "count": 2, "serve": 2, "in_program": 0}
    assert got["<outside the port>"]["serve"] == 0
    assert devtrace.declared_syncs() == 0
    # inside a traced program the sync says so
    f = devtrace.traced(lambda t: ns["dispatch"](t))
    f(_SyncingTensor())
    assert devtrace.syncs()[
        "difacto_tpu_torch/serve/fake_dispatch.py:2"]["in_program"] == 1


# ------------------------------------------------------- the serve gate
SERVE_SCENARIO = """
import sys
import numpy as np
from {pkg}.updaters.sgd_updater import SGDUpdaterParam
from {pkg}.store.local import SlotStore
from {pkg}.serve.batcher import MicroBatcher
from {pkg}.serve.executor import PredictExecutor
from {pkg}.data.rowblock import RowBlock
from {pkg}.utils import {tracer} as tracer

store = SlotStore(SGDUpdaterParam(V_dim=4, hash_capacity=1024){dev})
ex = PredictExecutor(store)
# batch_size == rows per request: each submit flushes one 4-row batch
bat = MicroBatcher(ex.predict_scores, batch_size=4, queue_cap=64)
bat.start()

def blk():
    idx = (np.arange(16, dtype=np.uint32) * 7) % 97
    off = np.arange(0, 17, 4, dtype=np.int64)
    return RowBlock(offset=off, label=np.zeros(4, np.float32),
                    index=idx, value=None, weight=None)

for _ in range(3):
    bat.submit(blk()).result(60)
tracer.dump(sys.argv[1])
for _ in range(10):
    bat.submit(blk()).result(60)
bat.close()
assert ex.stats()["dispatches"] == 13
tracer.dump(sys.argv[2])
"""


@pytest.fixture(scope="module")
def serve_dumps(tmp_path_factory):
    d = tmp_path_factory.mktemp("serve_gate")
    out = {}
    for pkg, tracer, dev in (("difacto_tpu", "jaxtrace", ""),
                             ("difacto_tpu_torch", "devtrace",
                              ', device="cpu"')):
        warm, final = d / f"{pkg}-warm.json", d / f"{pkg}-final.json"
        env = dict(os.environ, DIFACTO_JAXTRACE="1", JAX_PLATFORMS="cpu",
                   PYTHONPATH=str(REPO))
        r = subprocess.run(
            [sys.executable, "-c", SERVE_SCENARIO.format(
                pkg=pkg, tracer=tracer, dev=dev), str(warm), str(final)],
            cwd=str(REPO), env=env, capture_output=True, text=True,
            timeout=300)
        assert r.returncode == 0, r.stderr[-2000:]
        load = jaxtrace.load if pkg == "difacto_tpu" else devtrace.load
        out[pkg] = (load(warm), load(final), warm, final)
    return out


@pytest.mark.parametrize("pkg", ["difacto_tpu", "difacto_tpu_torch"])
def test_serve_gate_side_by_side(serve_dumps, pkg):
    warm, final, _, _ = serve_dumps[pkg]
    serve = [s for s in final["sites"]
             if s.startswith(f"{pkg}/serve/executor.py:")]
    assert len(serve) == 1, final["sites"]
    for site, rec in final["sites"].items():
        if not rec["calls"]:
            continue
        w = warm["sites"].get(site)
        assert w is not None and w["calls"], f"{site} first ran after warm"
        assert rec["compiles"] == w["compiles"], \
            f"{site}: {w['compiles']} -> {rec['compiles']} after warm-up"
        assert rec["calls"] > w["calls"]
    assert final["sites"][serve[0]]["calls"] == 13
    points = collections.Counter()
    for rec in final["fetches"].values():
        points[rec["point"]] += rec["count"]
    assert points == {"serve.scores": 13}


def test_serve_gate_port_dumps_pass_devmap(serve_dumps, capsys):
    _, _, warm, final = serve_dumps["difacto_tpu_torch"]
    assert devmap.main(["--root", str(REPO), "--dynamic", str(final),
                        "--warm", str(warm), "--check"]) == 0
    out = capsys.readouterr().out
    assert "serve.scores" in out and "[13x serve.scores]" in out
    puts = devtrace.load(final)["puts"]
    assert sorted(r["count"] for r in puts.values()) == [13, 13]


# ----------------------------------------- fetch points across learners
PORT_RUNS = """
import json, sys
import numpy as np
from difacto_tpu_torch.learners.base import Learner
from difacto_tpu_torch.utils import devtrace

out, confs = sys.argv[1], json.loads(sys.argv[2])
for name, kw in confs.items():
    devtrace.reset()
    ln = Learner.create(name, device="cpu")
    ln.init([tuple(x) for x in kw])
    objv = []
    if name == "sgd":
        ln.add_epoch_end_callback(
            lambda e, t, v: objv.append([t.loss, t.auc, v.loss, v.auc]))
    else:
        ln.add_epoch_end_callback(lambda e, p: objv.append(p.objv))
    ln.run()
    table = {"sgd": lambda: ln.store.state.VVg.numpy(),
             "bcd": lambda: np.asarray(ln.w),
             "lbfgs": lambda: ln.weights.numpy()}[name]()
    np.save(f"{out}/{name}-table.npy", table)
    with open(f"{out}/{name}.json", "w") as f:
        json.dump({"objv": objv, "fetches": devtrace.fetches(),
                   "sites": devtrace.sites()}, f)
"""

SGD_KW = [("data_in", RCV1), ("data_val", RCV1), ("V_dim", "2"),
          ("hash_capacity", "4096"), ("batch_size", "10"),
          ("num_jobs_per_epoch", "2"), ("max_num_epochs", "2"),
          ("stop_rel_objv", "0"), ("report_interval", "0"),
          ("num_producers", "1"), ("producer_mode", "thread")]
CONFS = {
    "sgd": SGD_KW,
    "bcd": [("data_in", RCV1), ("l1", ".1"), ("lr", ".05"),
            ("block_ratio", "0.001"), ("tail_feature_filter", "0"),
            ("max_num_epochs", "3")],
    "lbfgs": [("data_in", RCV1), ("m", "5"), ("V_dim", "0"), ("l2", "0"),
              ("init_alpha", "1"), ("tail_feature_filter", "0"),
              ("max_num_epochs", "5")],
}
# the port's declared copies where the JAX learners sync undeclared
PORT_ONLY = {"bcd": {"bcd.progress": 3}, "lbfgs": {"lbfgs.gram": 4},
             "sgd": {}}


def _points(fetches: dict) -> dict:
    out = collections.Counter()
    for rec in fetches.values():
        out[rec["point"]] += rec["count"]
    return dict(out)


@pytest.fixture(scope="module")
def port_runs(tmp_path_factory):
    """The three port learners in a fresh interpreter with tracing on
    (every wrapper created traced) and one with it off."""
    out = {}
    for mode in ("on", "off"):
        d = tmp_path_factory.mktemp(f"learners_{mode}")
        env = dict(os.environ, PYTHONPATH=str(REPO))
        env.pop("DIFACTO_HLOSCAN", None)
        if mode == "on":
            env["DIFACTO_JAXTRACE"] = "1"
        else:
            env.pop("DIFACTO_JAXTRACE", None)
        r = subprocess.run([sys.executable, "-c", PORT_RUNS, str(d),
                            json.dumps(CONFS)], cwd=str(REPO), env=env,
                           capture_output=True, text=True, timeout=300)
        assert r.returncode == 0, r.stderr[-3000:]
        out[mode] = d
    return out


def _jax_points(name, monkeypatch) -> dict:
    from difacto_tpu.learners import Learner as JLearner
    monkeypatch.setenv("DIFACTO_JAXTRACE", "1")
    jaxtrace.reset()
    kw = list(CONFS[name])
    if name == "sgd":
        kw += [("fused_kernel", "jnp")]
    ln = JLearner.create(name)
    ln.init(kw)
    ln.run()
    got = _points(jaxtrace.fetches())
    jaxtrace.reset()
    return got


@pytest.mark.parametrize("name", ["sgd", "bcd", "lbfgs"])
def test_fetch_points_equal_jax(port_runs, name, monkeypatch):
    port = json.loads((port_runs["on"] / f"{name}.json").read_text())
    got = _points(port["fetches"])
    want = _jax_points(name, monkeypatch)
    extra = {p: n for p, n in got.items() if p not in want}
    assert extra == PORT_ONLY[name], (got, want)
    assert {p: n for p, n in got.items() if p in want} == want
    assert want, "the JAX learner declared no fetch"


@pytest.mark.parametrize("name", ["sgd", "bcd", "lbfgs"])
def test_tracing_leaves_tables_and_objectives_bit_for_bit(port_runs, name):
    on = json.loads((port_runs["on"] / f"{name}.json").read_text())
    off = json.loads((port_runs["off"] / f"{name}.json").read_text())
    assert on["objv"] == off["objv"] and on["objv"]
    a = np.load(port_runs["on"] / f"{name}-table.npy")
    b = np.load(port_runs["off"] / f"{name}-table.npy")
    assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    # off recorded nothing; on, every learner ran traced programs
    assert off["fetches"] == {} and not _called(off["sites"])
    assert _called(on["sites"])


def test_sgd_signatures_and_the_replay(port_runs):
    on = json.loads((port_runs["on"] / "sgd.json").read_text())
    sites = _called(on["sites"])
    train = [s for s in sites if sites[s]["label"] == "train_step"]
    (train,) = train
    # 11 batches an epoch over 2 epochs: a few signatures, many calls
    assert sites[train]["calls"] == 22
    assert sites[train]["compiles"] <= 3
    count = [s for s in sites if sites[s]["label"].endswith("apply_count")]
    assert [sites[s]["calls"] for s in count] == [11]   # epoch 0 only


# --------------------------------------------------- to_local_numpy/rows
def test_to_local_numpy_and_local_rows_match_jax(on, monkeypatch):
    import jax.numpy as jnp

    from difacto_tpu.parallel import multihost as jmh
    from difacto_tpu_torch.parallel import multihost as tmh
    rng = np.random.RandomState(5)
    a = rng.randn(37, 3).astype(np.float32)
    t, j = torch.from_numpy(a.copy()), jnp.asarray(a)
    np.testing.assert_array_equal(tmh.to_local_numpy(t),
                                  jmh.to_local_numpy(j))
    jaxtrace.reset()
    for lo, hi in ((0, 37), (5, 11), (30, 37), (4, 4)):
        got = tmh.local_rows(t, lo, hi)
        assert isinstance(got, np.ndarray)
        np.testing.assert_array_equal(got, jmh.local_rows(j, lo, hi))
    np.testing.assert_array_equal(tmh.local_rows(a, 2, 6), a[2:6])
    assert _points(devtrace.fetches())["multihost.local_rows"] == 4
    assert _points(jaxtrace.fetches()) == {"multihost.local_rows": 4}
    jaxtrace.reset()
    bf = tmh.to_local_numpy(t.to(torch.bfloat16))
    assert bf.dtype == np.float32 and bf.shape == a.shape


# -------------------------------------------------- the inventory, devmap
_CALL = re.compile(r"(?<![\w.])devtrace\.(traced|kernel|fetch|to_device)\(|"
                   r"^\s*@devtrace\.traced\s*$")


def test_inventory_finds_every_devtrace_call_in_the_port():
    inv = devmap.inventory(REPO)
    static = set(inv["sites"]) | set(inv["fetch_sites"]) \
        | set(inv["put_sites"])
    seen = set()
    for path in sorted((REPO / "difacto_tpu_torch").rglob("*.py")):
        rel = path.relative_to(REPO).as_posix()
        if rel.endswith("utils/devtrace.py"):
            continue
        for i, line in enumerate(path.read_text().splitlines(), 1):
            if _CALL.search(line):
                seen.add(f"{rel}:{i}")
    assert seen == static
    kinds = collections.Counter(r["kind"] for r in inv["sites"].values())
    assert kinds["kernel"] == 4 and kinds["program"] >= 13
    labels = {r["label"] for r in inv["sites"].values()}
    assert {"gather_rows_cuda", "scatter_rows_cuda", "fm_update_rows_cuda",
            "fm_chunk_grad_cuda", "train_step", "eval_step", "_tile_grad",
            "delta_grad"} <= labels
    for point in ("serve.scores", "sgd.metrics", "sgd.spmd_metrics",
                  "bcd.grad_gh", "lbfgs.tile_metrics", "lbfgs.grad",
                  "lbfgs.linesearch", "lbfgs.val_auc", "lbfgs.nnz",
                  "capacity.fence", "multihost.local_rows", "serve.stage",
                  "sgd.stage"):
        assert point in inv["points"], point


def _dump(tmp_path, name, **over) -> str:
    doc = {"version": 1, "sites": {}, "fetches": {}, "puts": {},
           "syncs": {}, "declared_syncs": 0}
    doc.update(over)
    p = tmp_path / name
    p.write_text(json.dumps(doc))
    return str(p)


def test_devmap_check_fails_on_planted_faults(tmp_path, capsys):
    inv = devmap.inventory(REPO)
    scores = next(s for s, p in inv["fetch_sites"].items()
                  if p == "serve.scores")
    step = next(s for s, r in inv["sites"].items()
                if s.startswith("difacto_tpu_torch/serve/executor.py:"))
    ok_site = {step: {"label": "predict_step", "kind": "program",
                      "calls": 5, "compiles": 1, "keys": ["k1"]}}
    ok_fetch = {scores: {"point": "serve.scores", "count": 5}}
    clean = _dump(tmp_path, "clean.json", sites=ok_site, fetches=ok_fetch)
    args = ["--root", str(REPO), "--check", "--dynamic"]
    assert devmap.main(args + [clean, "--warm", clean]) == 0
    cases = {
        "unknown site": dict(sites=dict(ok_site, **{
            "difacto_tpu_torch/nowhere.py:3": ok_site[step]})),
        "undeclared fetch site": dict(fetches=dict(ok_fetch, **{
            "difacto_tpu_torch/serve/executor.py:1": {
                "point": "serve.scores", "count": 1}})),
        "wrong point": dict(fetches={scores: {"point": "serve.other",
                                              "count": 1}}),
        "serve sync": dict(syncs={"difacto_tpu_torch/serve/batcher.py:9": {
            "count": 2, "serve": 2, "in_program": 0}}),
    }
    for what, over in cases.items():
        path = _dump(tmp_path, "bad.json", **dict(
            dict(sites=ok_site, fetches=ok_fetch), **over))
        assert devmap.main(args + [path]) == 1, what
    grown = _dump(tmp_path, "grown.json", sites={step: dict(
        ok_site[step], compiles=2, keys=["k1", "k2"])}, fetches=ok_fetch)
    assert devmap.main(args + [grown, "--warm", clean]) == 1
    # an undeclared sync outside serve is reported, not failed: the
    # evaluate's float()s (SlotStore.evaluate), wherever the line is
    src = (REPO / "difacto_tpu_torch" / "store" / "local.py").read_text()
    line = src.splitlines().index(
        "        return float(penalty), float(nnz)") + 1
    site = f"difacto_tpu_torch/store/local.py:{line}"
    other = _dump(tmp_path, "other.json", sites=ok_site, fetches=ok_fetch,
                  syncs={site: {"count": 4, "serve": 0, "in_program": 0}})
    assert devmap.main(args + [other]) == 0
    assert f"local.py:{line}" in capsys.readouterr().out


def test_devmap_json_output(tmp_path):
    out = tmp_path / "devmap.json"
    assert devmap.main(["--root", str(REPO), "--json", str(out)]) == 0
    graph = json.loads(out.read_text())
    assert graph["unknown_sites"] == [] and graph["sites"]
