"""The port's FM forward, objective and AUC against the JAX package's.

Both take the SAME host buffers (the JAX package's ``pack_batch``, whose
layout the port's ``unpack_batch`` reads) and the same parameter rows.
The port sums every row left to right (ops/segment.py) while XLA's
segment_sum and reductions take their own order, so the results agree
within rtol 1e-5 / atol 1e-6 — float32 summation-order noise — rather
than bit for bit. A row's score in the port does not depend on the other
rows of its batch; the last test holds it to that bit for bit.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from difacto_tpu.losses import FMParams as JFM, fm as jfm
from difacto_tpu.losses.metrics import auc_times_n_jnp
from difacto_tpu.ops import segment as jseg
from difacto_tpu.ops.batch import pack_batch as jpack, unpack_batch as junpack
from difacto_tpu_torch.data.rowblock import RowBlock
from difacto_tpu_torch.losses import FMParams as TFM, fm as tfm
from difacto_tpu_torch.losses.metrics import auc_times_n
from difacto_tpu_torch.ops import segment as tseg
from difacto_tpu_torch.ops.batch import (bucket, max_row_nnz, pack_batch,
                                         unpack_batch)

RTOL, ATOL = 1e-5, 1e-6


def _block(rows: int, U: int, seed: int, binary: bool) -> RowBlock:
    rng = np.random.RandomState(seed)
    counts = rng.randint(1, 12, rows)
    counts[rng.rand(rows) < 0.1] = 0          # empty rows
    offset = np.zeros(rows + 1, np.int64)
    np.cumsum(counts, out=offset[1:])
    nnz = int(offset[-1])
    idx = np.concatenate([np.sort(rng.choice(U, c, replace=False))
                          for c in counts]).astype(np.uint32)
    return RowBlock(offset=offset,
                    label=rng.choice([-1.0, 1.0], rows).astype(np.float32),
                    index=idx,
                    value=None if binary
                    else rng.rand(nnz).astype(np.float32) * 2)


def _both(blk: RowBlock, U: int):
    b_cap, nnz_cap, u_cap = bucket(blk.size), bucket(blk.nnz), bucket(U)
    slots = np.arange(u_cap, dtype=np.int32)
    i32, f32, binary = jpack(blk, U, slots, b_cap, nnz_cap, u_cap)
    ti32, tf32, tbin = pack_batch(blk, U, slots, b_cap, nnz_cap, u_cap)
    np.testing.assert_array_equal(ti32, i32)   # one host layout
    np.testing.assert_array_equal(tf32, f32)
    jb, _, _ = junpack(jnp.asarray(i32), jnp.asarray(f32), b_cap, nnz_cap,
                       u_cap, binary=binary)
    tb, _, _ = unpack_batch(torch.from_numpy(i32), torch.from_numpy(f32),
                         b_cap, nnz_cap, u_cap, max_row_nnz(blk),
                         binary=binary)
    return jb, tb, u_cap


def _rows(u_cap: int, k: int, seed: int):
    rng = np.random.RandomState(seed)
    w = (rng.randn(u_cap) * 0.5).astype(np.float32)
    V = (rng.randn(u_cap, k) * 0.3).astype(np.float32) if k else None
    vm = (rng.rand(u_cap) < 0.7).astype(np.float32) if k else None
    return w, V, vm


def _fm(params_np, jb, tb):
    w, V, vm = params_np
    jp = JFM(w=jnp.asarray(w), V=None if V is None else jnp.asarray(V),
             v_mask=None if vm is None else jnp.asarray(vm))
    tp = TFM(w=torch.from_numpy(w),
             V=None if V is None else torch.from_numpy(V),
             v_mask=None if vm is None else torch.from_numpy(vm))
    return jfm.fm_predict_xv(jp, jb), tfm.fm_predict_xv(tp, tb)


@pytest.mark.parametrize("k", [0, 2, 16])
@pytest.mark.parametrize("binary", [True, False])
def test_fm_predict_xv_matches_jax(k, binary):
    blk = _block(50, 200, seed=k + 3, binary=binary)
    jb, tb, u_cap = _both(blk, 200)
    (jpred, jxv), (tpred, txv) = _fm(_rows(u_cap, k, seed=1), jb, tb)
    np.testing.assert_allclose(tpred.numpy(), np.asarray(jpred), rtol=RTOL,
                               atol=ATOL)
    if k:
        np.testing.assert_allclose(txv.numpy(), np.asarray(jxv), rtol=RTOL,
                                   atol=ATOL)
    else:
        assert jxv is None and txv is None


@pytest.mark.parametrize("binary", [True, False])
def test_spmv_spmm_match_jax(binary):
    blk = _block(40, 100, seed=13, binary=binary)
    jb, tb, u_cap = _both(blk, 100)
    w, V, _ = _rows(u_cap, 5, seed=3)
    B = jb.labels.shape[0]
    jv = jseg.spmv(jb.vals, jb.rows, jb.cols, jnp.asarray(w), B)
    tv = tseg.spmv(tb.vals, tb.rows, tb.cols, torch.from_numpy(w), B,
                   tb.row_cap)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=RTOL,
                               atol=ATOL)
    jm = jseg.spmm(jb.vals, jb.rows, jb.cols, jnp.asarray(V), B)
    tm = tseg.spmm(tb.vals, tb.rows, tb.cols, torch.from_numpy(V), B,
                   tb.row_cap)
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("binary", [True, False])
def test_logit_objv_and_auc_match_jax(binary):
    blk = _block(60, 150, seed=9, binary=binary)
    jb, tb, u_cap = _both(blk, 150)
    (jpred, _), (tpred, _) = _fm(_rows(u_cap, 4, seed=2), jb, tb)
    np.testing.assert_allclose(float(tfm.logit_objv(tpred, tb)),
                               float(jfm.logit_objv(jpred, jb)), rtol=RTOL,
                               atol=ATOL)
    # AUC on the same scores: rank statistics, equal up to float32 sums
    ja = auc_times_n_jnp(jb.labels, jnp.asarray(tpred.numpy()), jb.row_mask)
    ta = auc_times_n(tb.labels, tpred, tb.row_mask)
    np.testing.assert_allclose(float(ta), float(ja), rtol=RTOL, atol=ATOL)


def test_auc_degenerate_and_padded():
    lab = torch.tensor([1.0, 1.0, 1.0, 0.0])
    pred = torch.tensor([0.1, 0.2, 0.3, 0.4])
    mask = torch.tensor([1.0, 1.0, 1.0, 0.0])   # only positives are real
    assert float(auc_times_n(lab, pred, mask)) == 1.0
    mask = torch.ones(4)
    ja = auc_times_n_jnp(jnp.asarray(lab.numpy()), jnp.asarray(pred.numpy()),
                         jnp.asarray(mask.numpy()))
    np.testing.assert_allclose(float(auc_times_n(lab, pred, mask)),
                               float(ja), rtol=RTOL)


def test_row_scores_do_not_depend_on_the_batch():
    """A row scores the same bits alone, in a small batch, or in a large
    padded one — what lets task=serve equal task=pred whatever the
    micro-batch."""
    blk = _block(40, 120, seed=5, binary=False)
    w, V, vm = _rows(bucket(120), 8, seed=4)

    def score(sub: RowBlock, extra_cap: int):
        b_cap = bucket(sub.size) * extra_cap
        nnz_cap = bucket(max(sub.nnz, 1)) * extra_cap
        u_cap = bucket(120)
        i32, f32, binary = pack_batch(sub, 120, np.arange(u_cap, dtype=
                                                          np.int32),
                                      b_cap, nnz_cap, u_cap)
        tb, _, _ = unpack_batch(torch.from_numpy(i32), torch.from_numpy(f32),
                             b_cap, nnz_cap, u_cap,
                             max(max_row_nnz(sub), 1) + extra_cap,
                             binary=binary)
        p = TFM(w=torch.from_numpy(w), V=torch.from_numpy(V),
                v_mask=torch.from_numpy(vm))
        return tfm.fm_predict(p, tb)[:sub.size].numpy()

    full = score(blk, 1)
    big = score(blk, 4)
    np.testing.assert_array_equal(big.view(np.uint32), full.view(np.uint32))
    for r in (0, 17, 39):
        one = score(blk.slice(r, r + 1), 1)
        assert one.view(np.uint32)[0] == full.view(np.uint32)[r]
