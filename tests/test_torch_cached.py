"""The port's pre-localized cached reader and its training path against
the JAX package's, on the CPU.

Caches are written by the port's converter with ``convert_procs=1``: the
auto rule splits the input over one worker per core (up to 8), so a
cache's member layout, and the batches it cuts, would depend on the
machine.

Reader parity (tolerance 0, byte for byte): ``CachedBatchReader`` yields
JAX's batches, uniq lanes and counts for whole members, sliced members
(re-compacted per batch), shuffle, negative sampling and member
sharding; ``prepare_from_uniq`` packs JAX's payload and, for the same
rows, ``prepare_hashed``'s, also when colliding uniq lanes share a slot
(``hash_capacity`` 61). Then training:

- from rec2, producer threads, worker processes and the replay cache
  leave one table bit for bit (rcv1: COO batches, which the replay cache
  steps as streamed);
- text and rec2 at one part leave one table bit for bit, also under
  heavy collisions;
- the port on a rec2 cache against JAX on the same cache, at the JAX
  defaults (replay cache, shuffle, validation from a cache), on the
  hashed and the dictionary store: per-epoch loss, AUC, nnz and penalty
  within 1e-5 relative, the final arrays within 1e-5 of each one's
  max|jax| (tests/test_torch_replay.py ``assert_runs_agree``).
"""

import logging
import os
import sys

import numpy as np
import pytest
import torch

from difacto_tpu.data import cached as jcached
from difacto_tpu.data import pack_stream as jps
from difacto_tpu_torch.data import cached as tcached
from difacto_tpu_torch.data import pack_stream as tps
from difacto_tpu_torch.data.batch_reader import BatchReader
from difacto_tpu_torch.data.converter import Converter
from difacto_tpu_torch.data.rec import read_rec_block_ex, rec_members
from difacto_tpu_torch.data.reader import expand_uri
from difacto_tpu_torch.learners.sgd import K_TRAINING, SGDLearner

_TESTS = os.path.dirname(os.path.abspath(__file__))
_ROOT = os.path.dirname(_TESTS)
sys.path.insert(0, _TESTS)
sys.path.insert(0, _ROOT)
from chip_smoke import synthetic_criteo  # noqa: E402
from test_torch_replay import (assert_runs_agree,  # noqa: E402
                               defaults_kwargs)

RCV1 = os.path.join(_ROOT, "tests", "data", "rcv1_100.libsvm")


def convert(src, out, fmt="libsvm", **kw):
    conv = Converter()
    args = [("data_in", src), ("data_format", fmt), ("data_out", out),
            ("data_out_format", "rec"), ("convert_procs", "1")]
    remain = conv.init(args + [(k, str(v)) for k, v in kw.items()])
    assert remain == []
    conv.run()
    return out


@pytest.fixture(scope="module")
def caches(tmp_path_factory):
    """rcv1 as one 100-row member ("one"), as 25-row members
    ("aligned"), not localized ("raw"); synthetic Criteo train and
    validation rows as text and as 50-row caches."""
    d = tmp_path_factory.mktemp("cached")
    (d / "train.txt").write_bytes(synthetic_criteo(400, 31))
    (d / "val.txt").write_bytes(synthetic_criteo(200, 32))
    return {
        "one": convert(RCV1, str(d / "one.rec")),
        "aligned": convert(RCV1, str(d / "aligned.rec"), rec_batch_size=25),
        "raw": convert(RCV1, str(d / "raw.rec"), rec_localize=0,
                       rec_batch_size=25),
        "criteo": (str(d / "train.txt"), str(d / "val.txt")),
        "criteo_rec": (
            convert(str(d / "train.txt"), str(d / "train.rec"), "criteo",
                    batch_size=50),
            convert(str(d / "val.txt"), str(d / "val.rec"), "criteo",
                    batch_size=50)),
    }


def _same(a, b, what):
    if a is None or b is None:
        assert a is None and b is None, what
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), what


def _same_batches(got, want):
    got, want = list(got), list(want)
    assert len(got) == len(want) > 0
    for i, ((s, u, c), (js, ju, jc)) in enumerate(zip(got, want)):
        for f in ("offset", "label", "index", "value", "weight"):
            _same(getattr(s, f), getattr(js, f), (i, f))
        _same(u, ju, (i, "uniq"))
        _same(c, jc, (i, "counts"))


# ------------------------------------------------------------- reader
def test_cache_probe_matches_jax(caches):
    for name, rows in (("one", 100), ("aligned", 25), ("raw", 25)):
        got = tcached.cache_probe(caches[name])
        assert got == jcached.cache_probe(caches[name])
        assert got == (name != "raw", rows)
    assert tcached.cache_is_localized(caches["aligned"])


READER_CASES = {
    "whole member": ("aligned", dict(batch_size=25)),
    "whole member, counts": ("aligned", dict(batch_size=25,
                                             need_counts=True)),
    "sliced member": ("one", dict(batch_size=25, need_counts=True)),
    "sliced member, ragged": ("one", dict(batch_size=30)),
    "shuffle": ("aligned", dict(batch_size=17, shuffle=True, seed=5,
                                need_counts=True)),
    "neg sampling": ("one", dict(batch_size=20, neg_sampling=0.5, seed=3)),
    "part 1 of 3": ("aligned", dict(part_idx=1, num_parts=3,
                                    batch_size=25)),
    "part 2 of 3, shuffle": ("aligned", dict(part_idx=2, num_parts=3,
                                             batch_size=10, shuffle=True,
                                             seed=8)),
}


@pytest.mark.parametrize("case", list(READER_CASES))
def test_reader_yields_the_jax_batches(caches, case):
    name, kw = READER_CASES[case]
    _same_batches(tcached.CachedBatchReader(caches[name], **kw),
                  jcached.CachedBatchReader(caches[name], **kw))


def test_shuffle_permutes_rows_and_repeats_per_seed(caches):
    def rowset(seed, shuffle):
        rows = []
        for sub, uniq, _ in tcached.CachedBatchReader(
                caches["one"], batch_size=17, shuffle=shuffle, seed=seed):
            for i in range(sub.size):
                feats = sub.index[sub.offset[i]:sub.offset[i + 1]]
                rows.append((float(sub.label[i]),
                             tuple(np.sort(uniq[feats]).tolist())))
        return rows

    plain, shuf = rowset(0, False), rowset(1, True)
    assert plain != shuf and sorted(plain) == sorted(shuf)
    assert rowset(1, True) == shuf


def test_negative_sampling_keeps_every_positive(tmp_path):
    """Negatives kept iff u <= 1 - neg_sampling: binomial(n_neg, 0.7)
    within 5 sigma; every positive kept (npz member, the legacy
    encoding)."""
    from difacto_tpu_torch.data.rec import write_rec_block
    from difacto_tpu_torch.data.rowblock import RowBlock
    n = 4000
    labels = (np.random.RandomState(3).rand(n) < 0.5).astype(np.float32)
    write_rec_block(str(tmp_path / "part-0.npz"),
                    RowBlock(offset=np.arange(n + 1, dtype=np.int64),
                             label=labels,
                             index=np.arange(n, dtype=np.uint32)),
                    uniq=np.arange(n, dtype=np.uint64))
    got = np.concatenate([s.label for s, _, _ in tcached.CachedBatchReader(
        str(tmp_path), batch_size=512, neg_sampling=0.3, seed=7)])
    n_pos, n_neg = int(labels.sum()), int((1 - labels).sum())
    assert int((got > 0).sum()) == n_pos
    mu, sd = 0.7 * n_neg, np.sqrt(0.3 * 0.7 * n_neg)
    assert abs(int((got == 0).sum()) - mu) < 5 * sd


def test_member_sharding_covers_the_cache_once(caches):
    whole = [tuple(u.tolist()) for _, u, _ in tcached.CachedBatchReader(
        caches["aligned"], batch_size=25)]
    parts = [tuple(u.tolist()) for p in range(3)
             for _, u, _ in tcached.CachedBatchReader(
                 caches["aligned"], p, 3, batch_size=25)]
    assert sorted(parts) == sorted(whole) and len(whole) == 4


def test_counts_are_per_uniq_lane(caches):
    for sub, uniq, cnts in tcached.CachedBatchReader(
            caches["one"], batch_size=30, need_counts=True):
        np.testing.assert_array_equal(
            cnts, np.bincount(sub.index.astype(np.int64),
                              minlength=len(uniq)))
        assert cnts.min() > 0   # re-compaction ships used lanes only


def test_a_cache_that_is_not_localized_is_refused(caches):
    with pytest.raises(ValueError, match="rec_localize"):
        list(tcached.CachedBatchReader(caches["raw"], batch_size=25))


# ------------------------------------------------------ prepare_from_uniq
@pytest.mark.parametrize("hash_capacity", [61, 4096])
@pytest.mark.parametrize("name,batch", [("aligned", 25), ("one", 25),
                                        ("criteo", 50)])
@pytest.mark.parametrize("fill", [False, True])
def test_prepare_from_uniq_packs_jax_and_text_payloads(caches, name, batch,
                                                       hash_capacity, fill):
    if name == "criteo":
        uri, text, fmt = caches["criteo_rec"][0], caches["criteo"][0], \
            "criteo"
    else:
        uri, text, fmt = caches[name], RCV1, "libsvm"
    shapes, jshapes, hshapes = (tps.ShapeSchedule(), jps.ShapeSchedule(),
                                tps.ShapeSchedule())
    texts = BatchReader(text, fmt, batch_size=batch)
    collided = False
    for (sub, uniq, cnts), blk in zip(tcached.CachedBatchReader(
            uri, batch_size=batch, need_counts=fill), texts):
        got = tps.prepare_from_uniq(shapes, hash_capacity, sub, uniq, cnts,
                                    fill, fill, 8, "train")
        want = jps.prepare_from_uniq(jshapes, hash_capacity, sub, uniq,
                                     cnts, fill, fill, 8, "train")
        text_p = tps.prepare_hashed(hshapes, hash_capacity, blk, fill, fill,
                                    8, "train")
        assert got.layout == want[0] == text_p.layout
        assert (got.binary, got.b_cap, got.d2, got.u_cap) == \
            tuple(want[3:7]) == (text_p.binary, text_p.b_cap, text_p.d2,
                                 text_p.u_cap)
        for a, b in ((got, want[1:3]), (got, (text_p.i32, text_p.f32))):
            assert a.i32.tobytes() == b[0].tobytes()
            assert a.f32.tobytes() == b[1].tobytes()
        slots = uniq % np.uint64(hash_capacity - 1)
        collided |= len(np.unique(slots)) < len(uniq)
    # 61 slots: colliding lanes really share a slot (else it proves nothing)
    assert collided or hash_capacity != 61


def test_spec_iter_reads_the_cache_as_the_threads_do(caches):
    """The worker's make_iter over a cache packs what the learner's
    thread make_iter packs: prepare_from_uniq over the same reader."""
    uri = caches["criteo_rec"][0]
    spec = tps.StreamSpec(
        parts=(0, 1), n_jobs=2, data_in="unused", data_format="rec",
        batch_size=50, shuffle=2, neg_sampling=1.0, epoch=1,
        hash_capacity=4096, want_counts=True, fill_counts=True, dim_min=8,
        job="train", b_cap=56, cached_uri=uri)
    got = list(tps.spec_iter(spec, 1))
    shapes = tps.ShapeSchedule()
    want = [tps.prepare_from_uniq(shapes, 4096, s, u, c, True, True, 8,
                                  "train", 56)
            for s, u, c in tcached.CachedBatchReader(
                uri, 1, 2, 50, shuffle=True, seed=1 * 2 + 1,
                need_counts=True)]
    assert len(got) == len(want) > 0
    for (kind, info, g), w in zip(got, want):
        assert kind == "ready" and info.size == int(w.i32[-2])
        assert g.i32.tobytes() == w.i32.tobytes()
        assert g.f32.tobytes() == w.f32.tobytes()


def test_a_full_width_member_fits_the_default_ring_slot(tmp_path):
    """Epoch 0's payload of a 1000-row Criteo member at the full width of
    examples/criteo_hashed.conf (4,194,304 hashed rows, counts filled)
    fits the ring slot the learner sizes at batch_size 1000
    (ring_slot_mb=0: max(1, 1000 * 320 >> 20) MB), so process mode never
    falls back to the pickled channel."""
    from difacto_tpu_torch.data.shm_ring import ShmRing
    (tmp_path / "t.txt").write_bytes(synthetic_criteo(2000, 33))
    uri = convert(str(tmp_path / "t.txt"), str(tmp_path / "t.rec"),
                  "criteo", batch_size=1000)
    ring = ShmRing(1, 1 << 20)
    try:
        for sub, uniq, cnts in tcached.CachedBatchReader(
                uri, batch_size=1000, shuffle=True, need_counts=True):
            pl = tps.prepare_from_uniq(tps.ShapeSchedule(), 1 << 22, sub,
                                       uniq, cnts, True, True, 8, "train",
                                       1024)
            assert sub.size == 1000 and pl.layout == "panel"
            ring.write(0, ("ready", tps.BlkInfo(size=sub.size), pl), 0, 0,
                       0)
    finally:
        ring.close()
        ring.unlink()


def test_oversized_members_warn_once(caches, caplog):
    def probe(uri, batch):
        ln = SGDLearner(device="cpu")
        ln.init([("data_in", uri), ("data_format", "rec"),
                 ("batch_size", str(batch)), ("hash_capacity", "4096")])
        with caplog.at_level(logging.WARNING, logger="difacto_tpu_torch"):
            caplog.clear()
            got = ln._cached_uri(K_TRAINING)
            assert ln._cached_uri(K_TRAINING) == got
        return got, [r for r in caplog.records if "re-convert" in r.message]

    got, warned = probe(caches["one"], 10)   # one 100-row member
    assert got == caches["one"] and len(warned) == 1
    got, warned = probe(caches["aligned"], 25)
    assert got == caches["aligned"] and not warned
    got, warned = probe(caches["raw"], 25)   # read as rows, not cached
    assert got is None and not warned


# ------------------------------------------------------------- training
def _train(data_in, fmt, **kw):
    ln = SGDLearner(device="cpu")
    args = dict(data_in=data_in, data_format=fmt, V_dim=2, V_threshold=0,
                lr=0.1, l1=0.1, l2=0, batch_size=25, shuffle=0,
                max_num_epochs=3, num_jobs_per_epoch=2, report_interval=0,
                stop_rel_objv=0, hash_capacity=4096, device_cache_mb=0,
                num_producers=2, producer_mode="thread")
    args.update(kw)
    ln.init([(k, str(v)) for k, v in args.items()])
    rows = []
    ln.add_epoch_end_callback(lambda e, t, v: rows.append(
        (t.nrows, t.loss, t.auc, t.nnz_w, t.penalty)))
    ln.run()
    return rows, ln.store.state.VVg.view(torch.int32).clone(), ln


def test_rec2_threads_processes_and_replay_leave_one_table(caches):
    uri = caches["aligned"]
    rows, bits, ln = _train(uri, "rec")
    assert ln.stage_stats()["producer_mode"] == "thread"
    for extra in (dict(producer_mode="process"),
                  dict(device_cache_mb=64)):
        r, b, ln = _train(uri, "rec", **extra)
        assert r == rows and torch.equal(b, bits), extra
    assert ln.device_cache_info()[K_TRAINING]["complete"]
    # shuffled member and row orders: both transports, one table
    rows, bits, _ = _train(uri, "rec", shuffle=2)
    r, b, ln = _train(uri, "rec", shuffle=2, producer_mode="process")
    assert r == rows and torch.equal(b, bits)
    assert ln.stage_stats()["producer_mode"] == "process"


@pytest.mark.parametrize("data,hash_capacity", [("rcv1", 4096),
                                                ("rcv1", 61),
                                                ("criteo", 4096)])
def test_text_and_rec2_at_one_part_leave_one_table(caches, data,
                                                   hash_capacity):
    if data == "criteo":
        text, fmt, uri, bs = caches["criteo"][0], "criteo", \
            caches["criteo_rec"][0], 50
    else:
        text, fmt, uri, bs = RCV1, "libsvm", caches["aligned"], 25
    kw = dict(num_jobs_per_epoch=1, hash_capacity=hash_capacity,
              batch_size=bs)
    rows, bits, _ = _train(text, fmt, **kw)
    r, b, _ = _train(uri, "rec", **kw)
    assert r == rows and torch.equal(b, bits)


@pytest.mark.parametrize("store", ["hashed", "dictionary"])
def test_port_on_rec2_matches_jax_on_the_same_cache(tmp_path, caches,
                                                    store):
    train, val = caches["criteo_rec"]
    extra = [("hash_capacity", "4096")] if store == "hashed" \
        else [("init_capacity", "512")]
    kw = [(k, v) for k, v in defaults_kwargs((train, val), *extra)
          if k != "data_format"] + [("data_format", "rec")]
    port, jax_ln = assert_runs_agree(tmp_path, kw, f"rec2 {store}")
    info = port.device_cache_info()
    assert info == jax_ln.device_cache_info()
    assert info[K_TRAINING]["complete"]
    if store == "dictionary":
        assert port.store.state.capacity == jax_ln.store.state.capacity \
            > 512


def test_cache_members_hold_the_text_rows(caches):
    """What convert wrote: the 100 rcv1 rows in 25-row members; read back
    in the original id space, they are the text's rows."""
    from difacto_tpu_torch.data.reader import Reader
    from difacto_tpu_torch.data.rowblock import RowBlock
    members = rec_members(*expand_uri(caches["aligned"], with_sizes=True))
    assert [read_rec_block_ex(m)[0].size for m, _ in members] == [25] * 4
    got = RowBlock.concat(list(Reader(caches["aligned"], "rec")))
    want = RowBlock.concat(list(Reader(RCV1, "libsvm")))
    for f in ("offset", "label", "index", "value"):
        _same(getattr(got, f), getattr(want, f), f)
