"""The port's rec/rec2 binary cache against the JAX package's, byte for
byte (tolerance 0).

- rec2 members the two packages write for the same arrays are the same
  file, and each package reads the other's to the same arrays, as
  zero-copy views of page-aligned sections;
- npz members too (with the write clock pinned: a zip entry carries its
  write time), compressed and not, and both read either;
- truncation at every length and a bit flip at every byte raise a typed
  ``RecCorrupt``, never a wrong read;
- the ``rec.read`` fault point: ``truncate`` is rejected by the CRCs,
  ``err`` surfaces as an OSError, and both actually fire;
- ``Reader(data_format="rec")`` and ``RecWriter`` match JAX's.
"""

import os
import time

import numpy as np
import pytest

from difacto_tpu.data import rec as jrec
from difacto_tpu.data import rec2 as jrec2
from difacto_tpu.data.reader import Reader as JReader
from difacto_tpu.data.rowblock import RowBlock as JRowBlock
from difacto_tpu_torch.data import rec as trec
from difacto_tpu_torch.data import rec2 as trec2
from difacto_tpu_torch.data.reader import Reader
from difacto_tpu_torch.data.rowblock import RowBlock
from difacto_tpu_torch.utils import faultinject

FIELDS = ("offset", "label", "index", "value", "weight")


def _arrays(seed, n=37, nnz=211, localized=True, value=True, weight=True):
    rng = np.random.RandomState(seed)
    off = np.sort(rng.randint(0, nnz, n - 1))
    a = {"offset": np.concatenate(([0], off, [nnz])).astype(np.int64),
         "label": (rng.rand(n) > 0.5).astype(np.float32)}
    if localized:
        a["uniq"] = np.unique(rng.randint(0, 1 << 62, 97).astype(
            np.uint64))
        a["index"] = rng.randint(0, len(a["uniq"]), nnz).astype(np.uint32)
    else:
        a["index"] = rng.randint(0, 1 << 62, nnz).astype(np.uint64)
    if value:
        a["value"] = rng.randn(nnz).astype(np.float32)
    if weight:
        a["weight"] = rng.rand(n).astype(np.float32)
    return a


def _block(cls, a):
    return cls(offset=a["offset"], label=a["label"], index=a["index"],
               value=a.get("value"), weight=a.get("weight"))


def assert_same_block(a, b, what):
    for f in FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        if x is None or y is None:
            assert x is None and y is None, (what, f)
            continue
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), (what, f)


ARRAY_CASES = [
    dict(seed=1), dict(seed=2, value=False), dict(seed=3, weight=False),
    dict(seed=4, localized=False), dict(seed=5, n=1, nnz=0, value=False),
]


@pytest.mark.parametrize("case", range(len(ARRAY_CASES)))
def test_rec2_members_are_byte_identical_both_ways(tmp_path, case):
    a = _arrays(**ARRAY_CASES[case])
    port, ref = str(tmp_path / "p.rec2"), str(tmp_path / "j.rec2")
    trec2.write_rec2(port, a)
    jrec2.write_rec2(ref, a)
    with open(port, "rb") as f, open(ref, "rb") as g:
        assert f.read() == g.read()
    for reader, path in ((trec2.read_rec2, ref), (jrec2.read_rec2, port)):
        got = reader(path)
        assert list(got) == list(a)
        for k, v in a.items():
            assert got[k].dtype == v.dtype and got[k].tobytes() == \
                v.tobytes(), k
            assert not got[k].flags["OWNDATA"]   # a view of the mapping
            assert not got[k].flags["WRITEABLE"]
    raw = open(port, "rb").read()
    n = trec2._HEAD.unpack_from(raw, 0)[2]
    for i in range(n):
        off = trec2._SECT.unpack_from(raw, trec2._HEAD.size + 32 * i)[2]
        assert off % trec2.PAGE == 0


@pytest.mark.parametrize("compress", [False, True])
@pytest.mark.parametrize("localized", [False, True])
def test_npz_members_are_byte_identical_both_ways(tmp_path, monkeypatch,
                                                  compress, localized):
    a = _arrays(6, localized=localized)
    uniq = a.pop("uniq", None)
    port, ref = str(tmp_path / "p.npz"), str(tmp_path / "j.npz")
    # a zip entry stamps its write time: pin the clock for both writers
    monkeypatch.setattr(time, "time", lambda: 1.7e9)
    trec.write_rec_block(port, _block(RowBlock, a), compress=compress,
                         uniq=uniq)
    jrec.write_rec_block(ref, _block(JRowBlock, a), compress=compress,
                         uniq=uniq)
    with open(port, "rb") as f, open(ref, "rb") as g:
        assert f.read() == g.read()
    tb, tu = trec.read_rec_block_ex(ref)
    jb, ju = jrec.read_rec_block_ex(port)
    assert_same_block(tb, jb, "npz cross read")
    if localized:
        assert tu.tobytes() == ju.tobytes() == uniq.tobytes()
    else:
        assert tu is None and ju is None


def test_rec_block_writers_agree_on_rec2_and_delocalize(tmp_path):
    a = _arrays(7)
    uniq = a.pop("uniq")
    port, ref = str(tmp_path / "p.rec2"), str(tmp_path / "j.rec2")
    trec.write_rec_block(port, _block(RowBlock, a), uniq=uniq)
    jrec.write_rec_block(ref, _block(JRowBlock, a), uniq=uniq)
    assert open(port, "rb").read() == open(ref, "rb").read()
    # the original-id view of a localized member
    assert_same_block(trec.read_rec_block(port), jrec.read_rec_block(ref),
                      "delocalized")


def test_rec_members_skip_stray_files_and_dispatch(tmp_path):
    a = _arrays(8, localized=False)
    d = tmp_path / "cache.rec"
    d.mkdir()
    trec.write_rec_block(str(d / "part-00000.rec2"), _block(RowBlock, a))
    trec.write_rec_block(str(d / "part-00001.npz"), _block(RowBlock, a))
    (d / "part-00002.rec2.tmp").write_bytes(b"junk")
    (d / "README").write_bytes(b"junk")
    got = trec.rec_members([str(d)])
    assert got == jrec.rec_members([str(d)])
    assert [os.path.basename(m) for m, _ in got] == \
        ["part-00000.rec2", "part-00001.npz"]
    b2, u2 = trec.read_rec_block_ex(str(d / "part-00000.rec2"))
    b1, u1 = trec.read_rec_block_ex(str(d / "part-00001.npz"))
    assert u1 is None and u2 is None
    assert_same_block(b1, b2, "npz vs rec2")


def test_rec2_truncation_is_always_typed(tmp_path):
    path = str(tmp_path / "t.rec2")
    jrec2.write_rec2(path, _arrays(9))    # the JAX package's file
    raw = open(path, "rb").read()
    bad = str(tmp_path / "bad.rec2")
    for cut in list(range(0, 200, 7)) + list(range(4096, len(raw), 997)):
        with open(bad, "wb") as f:
            f.write(raw[:cut])
        with pytest.raises(trec2.RecCorrupt):
            trec2.read_rec2(bad)


def test_rec2_bit_flips_are_never_a_silent_wrong_read(tmp_path):
    path = str(tmp_path / "f.rec2")
    a = _arrays(10, n=9, nnz=40)
    trec2.write_rec2(path, a)
    raw = bytearray(open(path, "rb").read())
    bad = str(tmp_path / "bad.rec2")
    used = [i for i in range(len(raw)) if raw[i] or i < 4096]
    for pos in used[::3]:
        flipped = bytearray(raw)
        flipped[pos] ^= 0x10
        with open(bad, "wb") as f:
            f.write(flipped)
        try:
            got = trec2.read_rec2(bad)
        except trec2.RecCorrupt:
            continue
        # a flip the checks let through (header padding) reads right
        for k, v in a.items():
            assert got[k].tobytes() == v.tobytes(), (pos, k)


def test_rec_read_fault_point(tmp_path):
    path = str(tmp_path / "f.rec2")
    trec2.write_rec2(path, _arrays(11))
    try:
        faultinject.configure("rec.read:truncate@1")
        with pytest.raises(trec2.RecCorrupt):
            trec2.read_rec2(path)
        assert faultinject.stats()["rec.read"] == 1
        faultinject.configure("rec.read:err@1")
        with pytest.raises(OSError):
            trec2.read_rec2(path)
        assert faultinject.stats()["rec.read"] == 1
        faultinject.configure("rec.read:err@1:1")   # skip one, then fire
        trec2.read_rec2(path)
        with pytest.raises(faultinject.FaultInjected):
            trec2.read_rec2(path)
    finally:
        faultinject.configure("")
    assert trec2.read_rec2(path)


def test_fault_spec_grammar_matches_jax():
    from difacto_tpu.utils import faultinject as jfi
    spec = "rec.read:delay_ms=20@0.5:3,ckpt.write:truncate@1"
    got = {p: [(f.kind, f.arg, f.prob, f.after) for f in fs]
           for p, fs in faultinject.parse(spec).items()}
    want = {p: [(f.kind, f.arg, f.prob, f.after) for f in fs]
            for p, fs in jfi.parse(spec).items()}
    assert got == want
    # malformed specs (on a point no code fires)
    for bad in ("no.point:err", "no.point:boom@1", "no.point:err@0"):
        with pytest.raises(ValueError):
            faultinject.parse(bad)


@pytest.mark.parametrize("num_parts", [1, 3])
def test_reader_over_a_cache_matches_jax(tmp_path, num_parts):
    d = str(tmp_path / "c.rec")
    for i in range(5):
        a = _arrays(20 + i, localized=i % 2 == 0)
        uniq = a.pop("uniq", None)
        trec.write_rec_block(f"{d}/part-{i:05d}.rec2", _block(RowBlock, a),
                             uniq=uniq)
    for part in range(num_parts):
        got = list(Reader(d, "rec", part, num_parts))
        want = list(JReader(d, "rec", part, num_parts))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert_same_block(g, w, ("part", part))


def test_rec_writer_matches_jax(tmp_path):
    blocks = [_arrays(30 + i, localized=False) for i in range(3)]
    tw = trec.RecWriter(str(tmp_path / "p.rec"))
    jw = jrec.RecWriter(str(tmp_path / "j.rec"))
    for a in blocks:
        tw.write(_block(RowBlock, a))
        jw.write(_block(JRowBlock, a))
    assert tw.num_blocks == jw.num_blocks == 3
    names = sorted(os.listdir(tmp_path / "j.rec"))
    assert sorted(os.listdir(tmp_path / "p.rec")) == names
    for n in names:
        assert (tmp_path / "p.rec" / n).read_bytes() == \
            (tmp_path / "j.rec" / n).read_bytes()
