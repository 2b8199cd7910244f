"""The batch learners' host layer in the port against the JAX package, on
the CPU: the sorted KV algebra (``ops/kv``, all five functions, exact),
the tile builder (exact), the tile cache (LRU, the byte budget, and the
same evictions as JAX's on the same tiles), ``pad_batch`` field for field,
and the feature-group id helpers. Inputs are numpy draws from a seed or
tests/data/rcv1_100.libsvm.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from difacto_tpu import base as jbase
from difacto_tpu.data import Reader as JReader
from difacto_tpu.data import tile_store as jstore
from difacto_tpu.data.tile_builder import TileBuilder as JTileBuilder
from difacto_tpu.ops import batch as jbatch
from difacto_tpu.ops import kv as jkv
from difacto_tpu_torch import base as tbase
from difacto_tpu_torch.data import tile_store as tstore
from difacto_tpu_torch.data.reader import Reader
from difacto_tpu_torch.data.tile_builder import TileBuilder
from difacto_tpu_torch.ops import batch as tbatch
from difacto_tpu_torch.ops import kv as tkv

RCV1 = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                    "rcv1_100.libsvm")


def _keys(rng, n, hi=1000):
    return np.unique(rng.randint(0, hi, n).astype(np.uint64))


# ------------------------------------------------------------------ ops/kv
@pytest.mark.parametrize("seed", range(4))
def test_find_position_and_expand_ranges_equal_jax(seed):
    rng = np.random.RandomState(seed)
    src, dst = _keys(rng, 300), _keys(rng, 200)
    np.testing.assert_array_equal(tkv.find_position(src, dst),
                                  jkv.find_position(src, dst))
    empty = np.array([], dtype=np.uint64)
    np.testing.assert_array_equal(tkv.find_position(empty, dst),
                                  jkv.find_position(empty, dst))
    starts = rng.randint(0, 100, 20)
    lens = rng.randint(0, 5, 20)
    got = tkv.expand_ranges(starts, lens)
    np.testing.assert_array_equal(got, jkv.expand_ranges(starts, lens))
    assert got.dtype == np.int64
    assert len(tkv.expand_ranges(starts, np.zeros(20, np.int64))) == 0


@pytest.mark.parametrize("op", ["assign", "add"])
@pytest.mark.parametrize("val_len", [1, 3])
def test_kv_match_and_union_equal_jax(op, val_len):
    rng = np.random.RandomState(val_len)
    for _ in range(3):
        sk, dk = _keys(rng, 100), _keys(rng, 80)
        sv = rng.randn(len(sk) * val_len).astype(np.float32)
        dv0 = rng.randn(len(dk) * val_len).astype(np.float32)
        dj, dt = dv0.copy(), dv0.copy()
        nj = jkv.kv_match(sk, sv, dk, dj, op=op, val_len=val_len)
        nt = tkv.kv_match(sk, sv, dk, dt, op=op, val_len=val_len)
        assert nj == nt
        np.testing.assert_array_equal(dt, dj)
        kj, vj = jkv.kv_union(sk, sv, dk, dv0, op=op, val_len=val_len)
        kt, vt = tkv.kv_union(sk, sv, dk, dv0, op=op, val_len=val_len)
        np.testing.assert_array_equal(kt, kj)
        np.testing.assert_array_equal(vt, vj)


@pytest.mark.parametrize("op", ["assign", "add"])
def test_kv_match_varlen_equals_jax(op):
    rng = np.random.RandomState(7)
    sk, dk = _keys(rng, 60, 150), _keys(rng, 60, 150)
    sl = rng.randint(1, 4, len(sk))
    # matched keys must agree on length: give dst the src's lengths
    pos = jkv.find_position(sk, dk)
    dl = np.where(pos >= 0, sl[np.maximum(pos, 0)], rng.randint(1, 4, len(dk)))
    sv = rng.randn(int(sl.sum())).astype(np.float32)
    dv0 = rng.randn(int(dl.sum())).astype(np.float32)
    dj, dt = dv0.copy(), dv0.copy()
    assert (jkv.kv_match_varlen(sk, sv, sl, dk, dj, dl, op=op)
            == tkv.kv_match_varlen(sk, sv, sl, dk, dt, dl, op=op))
    np.testing.assert_array_equal(dt, dj)
    bad = dl.copy()
    bad[pos >= 0] += 1
    for mod in (jkv, tkv):
        with pytest.raises(ValueError, match="lengths"):
            mod.kv_match_varlen(sk, sv, sl, dk, dv0.copy(), bad)


def test_kv_rejects_unsorted_and_unknown_ops():
    a = np.array([3, 1], dtype=np.uint64)
    b = np.array([1, 2], dtype=np.uint64)
    v = np.zeros(2, np.float32)
    with pytest.raises(ValueError, match="sorted"):
        tkv.find_position(a, b)
    with pytest.raises(ValueError, match="sorted"):
        tkv.kv_union(b, v, a, v)
    with pytest.raises(ValueError, match="op"):
        tkv.kv_match(b, v, b, v.copy(), op="mul")
    with pytest.raises(ValueError, match="op"):
        tkv.kv_union(b, v, b, v, op="mul")


# --------------------------------------------------------------- base ids
def test_fea_grp_id_helpers_equal_jax():
    rng = np.random.RandomState(0)
    x = rng.randint(0, 1 << 40, 100).astype(np.uint64)
    for nbits in (0, 4, 8):
        for gid in (0, (1 << nbits) - 1):
            enc = tbase.encode_fea_grp_id(x, gid, nbits)
            np.testing.assert_array_equal(
                enc, jbase.encode_fea_grp_id(x, gid, nbits))
            np.testing.assert_array_equal(
                tbase.decode_fea_grp_id(enc, nbits),
                jbase.decode_fea_grp_id(enc, nbits))
            assert (tbase.decode_fea_grp_id(enc, nbits) == gid).all()
    assert tbase.encode_fea_grp_id(5, 3, 4) == \
        jbase.encode_fea_grp_id(5, 3, 4) == (5 << 4) | 3
    with pytest.raises(ValueError, match="out of range"):
        tbase.encode_fea_grp_id(1, 16, 4)


# ------------------------------------------------------------ tile builder
@pytest.mark.parametrize("chunk,threshold", [(1 << 20, 0), (3000, 2),
                                             (1500, 4)])
def test_tile_builder_equals_jax(chunk, threshold):
    tb, jb = TileBuilder(), JTileBuilder()
    for blk in Reader(RCV1, chunk_bytes=chunk):
        tb.add(blk, is_train=True)
    for blk in JReader(RCV1, chunk_bytes=chunk):
        jb.add(blk, is_train=True)
    for blk in Reader(RCV1, chunk_bytes=chunk):   # the same rows as val
        tb.add(blk, is_train=False)
    for blk in JReader(RCV1, chunk_bytes=chunk):
        jb.add(blk, is_train=False)
    assert len(tb.tiles) == len(jb.tiles) > (1 if chunk < 1 << 20 else 0)
    assert (tb.nrows_train, tb.nrows_val, tb.nnz_train) == \
        (jb.nrows_train, jb.nrows_val, jb.nnz_train)
    for (tc, tu, tt), (jc, ju, jt) in zip(tb.tiles, jb.tiles):
        assert tt == jt
        np.testing.assert_array_equal(tu, ju)
        np.testing.assert_array_equal(tc.index, jc.index)
        np.testing.assert_array_equal(tc.offset, jc.offset)
        np.testing.assert_array_equal(tc.label, jc.label)
    np.testing.assert_array_equal(tb.filter_tail(threshold),
                                  jb.filter_tail(threshold))
    np.testing.assert_array_equal(tb.cnts, jb.cnts)
    for t in range(len(tb.tiles)):
        np.testing.assert_array_equal(tb.colmap(t), jb.colmap(t))


# --------------------------------------------------------------- pad_batch
def test_pad_batch_equals_jax_field_for_field():
    tb = TileBuilder()
    blocks = list(Reader(RCV1, chunk_bytes=4000))
    for blk in blocks:
        tb.add(blk)
    for cblk, uniq, _ in tb.tiles:
        caps = dict(batch_cap=jbatch.bucket(cblk.size),
                    nnz_cap=jbatch.bucket(cblk.nnz))
        j = jbatch.pad_batch(cblk, len(uniq), **caps)
        t = tbatch.pad_batch(cblk, len(uniq), device="cpu", **caps)
        for f in j._fields:
            got, want = getattr(t, f).numpy(), np.asarray(getattr(j, f))
            np.testing.assert_array_equal(got, want, f)
            assert got.dtype == want.dtype, f
        assert t.row_cap == tbatch.max_row_nnz(cblk)
        # the rows ascend, pads included, so the segment sum applies
        assert (t.rows[1:] >= t.rows[:-1]).all()
        assert tstore.tensor_nbytes(t) == jstore._leaf_nbytes(j)
    cblk, uniq, _ = tb.tiles[0]
    with pytest.raises(ValueError, match="exceeds caps"):
        tbatch.pad_batch(cblk, len(uniq), nnz_cap=cblk.nnz - 1)


# -------------------------------------------------------------- tile cache
def test_tilecache_lru_and_byte_budget():
    built = []

    def build(r, c):
        built.append((r, c))
        return torch.zeros(256, dtype=torch.float32)  # 1 KB

    c = tstore.TileCache(build, max_bytes=3 << 10)
    for i in range(5):
        c.fetch(0, i)
    assert len(c) == 3 and c.nbytes == 3 << 10
    c.fetch(0, 2)
    assert c.hits == 1
    c.fetch(0, 0)                 # evicted -> rebuilt
    assert built.count((0, 0)) == 2
    n = tstore.TileCache(lambda r, f: None, max_bytes=1 << 10)
    for i in range(8):
        n.fetch(0, i)
    assert len(n) == 8 and n.nbytes == 0     # None counts nothing
    it = tstore.TileCache(lambda r, f: (r, f), max_items=2)
    for f in (0, 1, 0, 2, 1):
        it.fetch(0, f)
    assert len(it) == 2 and it.hits == 1 and it.misses == 4
    one = tstore.TileCache(build, max_bytes=1)
    one.fetch(1, 1)
    one.fetch(1, 2)
    assert len(one) == 1 and one.nbytes == 1024   # one entry always stays


def test_tilecache_evicts_as_jax_on_the_same_tiles():
    """Tiles of mixed sizes (NamedTuples of arrays, None) in a random
    fetch order: the port's byte count and evictions follow JAX's."""
    rng = np.random.RandomState(3)
    sizes = {(r, f): int(rng.randint(0, 6)) * 64 for r in range(3)
             for f in range(6)}

    def tile(key, mk):
        n = sizes[key]
        if n == 0:
            return None
        return tbatch.DeviceBatch(*([mk(np.zeros(n, np.float32))] * 6),
                                  num_rows=mk(np.int32(n)),
                                  num_uniq=mk(np.int32(1)), row_cap=3) \
            if mk is torch.from_numpy else jbatch.DeviceBatch(
                *([mk(np.zeros(n, np.float32))] * 6),
                num_rows=mk(np.int32(n)), num_uniq=mk(np.int32(1)))

    tc = tstore.TileCache(lambda r, f: tile(
        (r, f), lambda a: torch.from_numpy(np.asarray(a))),
        max_bytes=4000)
    jc = jstore.TileCache(lambda r, f: tile((r, f), jnp.asarray),
                          max_bytes=4000)
    keys = list(sizes)
    for i in rng.randint(0, len(keys), 200):
        tc.fetch(*keys[i])
        jc.fetch(*keys[i])
        assert (tc.nbytes, len(tc), tc.hits) == (jc.nbytes, len(jc), jc.hits)
        assert list(tc._cache) == list(jc._cache)
    assert tc.misses > len(tc)


def test_datastore_roundtrip_and_spill(tmp_path):
    ds = tstore.DataStore(max_mem_bytes=100, spill_dir=str(tmp_path))
    a = np.arange(20, dtype=np.float32)
    b = np.arange(10, dtype=np.float32)
    ds.store("a", a)
    ds.store("b", b)
    assert ds._spilled
    np.testing.assert_array_equal(ds.fetch("a"), a)
    np.testing.assert_array_equal(ds.fetch("b", 1, 3), [1, 2])
    assert ds.size("a") == 20 and sorted(ds.keys()) == ["a", "b"]
    ds.remove("a")
    with pytest.raises(KeyError):
        ds.fetch("a")
    with pytest.raises(ValueError):
        tstore.DataStore(max_mem_bytes=10)
