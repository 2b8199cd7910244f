"""The port's push against the JAX package's, bit for bit, on the CPU.

``row_epilogue`` (the plain version of the CUDA scatter kernel's
epilogue), ``fm_update_rows_ref``, ``scatter_rows_ref`` and
``apply_count`` are held to the JAX package's ``row_epilogue``,
``fused.fm_update_rows(..., backend="jnp")``, ``fused.scatter_rows(...,
"jnp")`` and ``make_fns(...).apply_count`` on uint views, over every
container (fp32, bf16, int8 codes, fp8 codes) and the three row layouts:
in-pad (V_dim 16, padded halves, scalars inside the Vg pad), appended
with a gap (V_dim 16 unpadded, the full-width Criteo row [V | Vg | gap |
scal]) and appended V_dim 64 (Wx 256). Slot vectors carry ascending
out-of-bounds pad lanes; ``vmask`` is 0 and 1, ``z`` lands on both sides
of ``l1`` and ``cnt`` around ``V_threshold``.

The scatters and the count push run jitted. The FTRL/AdaGrad epilogue is
compared with JAX run op by op (eager): jitted on the CPU, XLA contracts
``a*b + c`` into an FMA and divides by a constant through its reciprocal,
which moves some results by an ulp (test_jitted_jax_contracts_the_
epilogue measures it). The port, like the CUDA kernel, rounds every
operation of the JAX source on its own.

JAX on the CPU canonicalizes bf16 NaN patterns in concatenates, and the
f32 scalars ride bf16 containers as two 16-bit halves, so inputs are made
without such halves and an output half that forms one is compared as
"both NaN patterns".
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from difacto_tpu.ops import fused as jfused
from difacto_tpu.store.local import pad_slots_oob
from difacto_tpu.updaters import sgd_updater as J
from difacto_tpu_torch.ops import fused as tfused
from difacto_tpu_torch.updaters import sgd_updater as T

C = 512
HYPER = dict(l1=0.5, l2=0.1, lr=0.05, lr_beta=1.0, V_l2=0.01, V_lr=0.02,
             V_lr_beta=1.0, V_threshold=2)
LAYOUTS = {
    "in_pad": dict(V_dim=16),
    "appended_gap": dict(V_dim=16, pad_v_rows=False),
    "appended_v64": dict(V_dim=64, pad_v_rows=False),
}
KINDS = ["fp32", "bf16", "int8", "fp8"]
_UINT = {4: np.uint32, 2: np.uint16, 1: np.uint8}
_JNP = {"fp32": jnp.float32, "bf16": jnp.bfloat16, "int8": jnp.int8,
        "fp8": jnp.int8}


def _params(kind, layout):
    kw = dict(slot_dtype=kind, hash_capacity=C, **LAYOUTS[layout], **HYPER)
    return J.SGDUpdaterParam(**kw), T.SGDUpdaterParam(**kw)


def bits(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.contiguous().view({4: torch.int32, 2: torch.int16,
                                 1: torch.int8}[x.element_size()]).numpy()
    x = np.asarray(x)
    return x.view(_UINT[x.dtype.itemsize])


def assert_same_bits(port, jax_out, kind):
    p, j = bits(port), bits(jax_out)
    differ = p != j
    if kind == "bf16":
        def nan(u):
            return ((u & 0x7F80) == 0x7F80) & ((u & 0x7F) != 0)
        differ &= ~(nan(p) & nan(j))
    assert not differ.any(), (f"{int(differ.sum())} of {differ.size} "
                              "lanes differ")


def _no_nan_halves(a: np.ndarray) -> np.ndarray:
    """f32 values whose two 16-bit halves are not bf16 NaN patterns."""
    u = a.view(np.uint32)
    for shift in (0, 16):
        h = (u >> shift) & 0xFFFF
        bad = ((h & 0x7F80) == 0x7F80) & ((h & 0x7F) != 0)
        u[bad] ^= np.uint32(0x4000 << shift)
    return a


def make_rows(tp, n, seed):
    """[n, Wx] fused rows (the port's build_rows, bit-exact with JAX's)
    plus the step inputs gw, gV, vmask."""
    k = tp.V_dim
    rng = np.random.RandomState(seed)
    V = (rng.randn(n, k) * 0.1).astype(np.float32)
    Vg = np.abs(rng.randn(n, k)).astype(np.float32)
    V[::7] = 0.0                              # all-zero halves: scale 1.0
    w = (rng.randn(n) * 0.5).astype(np.float32)
    w[::3] = 0.0
    z = (rng.randn(n) * 0.6).astype(np.float32)   # |z| around l1 = 0.5
    sg = np.abs(rng.randn(n)).astype(np.float32)
    cnt = rng.randint(0, 5, n).astype(np.float32)  # around V_threshold 2
    live = rng.rand(n) < 0.5
    for a in (w, z, sg):
        _no_nan_halves(a)
    rows = T.build_rows(tp, C, *(torch.from_numpy(a)
                                 for a in (V, Vg, w, z, sg, cnt, live)))
    gw = (rng.randn(n) * 0.3).astype(np.float32)
    gV = (rng.randn(n, k) * 0.1).astype(np.float32)
    vmask = (rng.rand(n) < 0.6).astype(np.float32)
    return rows, gw, gV, vmask


def to_jax(t: torch.Tensor, kind: str):
    return jnp.asarray(bits(t).view(
        {"fp32": np.float32, "bf16": jnp.bfloat16, "int8": np.int8,
         "fp8": np.int8}[kind]))


def _slots(n_real, u, seed):
    rng = np.random.RandomState(seed)
    real = np.sort(rng.choice(C, n_real, replace=False)).astype(np.int32)
    return pad_slots_oob(real, u, C)


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("kind", KINDS)
def test_row_epilogue_matches_jax(kind, layout):
    jp, tp = _params(kind, layout)
    rows, gw, gV, vm = make_rows(tp, 256, seed=1)
    got = T.row_epilogue(tp, C, rows, torch.from_numpy(gw),
                         torch.from_numpy(gV), torch.from_numpy(vm))
    want = J.row_epilogue(jp, C, to_jax(rows, kind), jnp.asarray(gw),
                          jnp.asarray(gV), jnp.asarray(vm))
    assert got.dtype == rows.dtype and got.shape == rows.shape
    assert_same_bits(got, want, kind)
    # rows with vmask 0 keep their embedding lanes bit for bit
    _, h, _, off = T.row_layout(tp, C)
    keep = vm == 0
    np.testing.assert_array_equal(bits(got)[keep, :min(2 * h, off)],
                                  bits(rows)[keep, :min(2 * h, off)])


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("kind", KINDS)
def test_fm_update_rows_ref_matches_jax(kind, layout):
    jp, tp = _params(kind, layout)
    table, _, _, _ = make_rows(tp, C, seed=2)
    slots = _slots(60, 96, seed=3)           # 36 OOB pad lanes
    rows = tfused.gather_rows_ref(table, torch.from_numpy(slots))
    _, gw, gV, vm = make_rows(tp, 96, seed=4)
    got = tfused.fm_update_rows(table.clone(), torch.from_numpy(slots), rows,
                                torch.from_numpy(gw), torch.from_numpy(gV),
                                torch.from_numpy(vm), T.epilogue_spec(tp, C),
                                functools.partial(T.row_epilogue, tp, C))

    def jepi(r, g, gv, v):
        return J.row_epilogue(jp, C, r, g, gv, v)
    want = jfused.fm_update_rows(to_jax(table, kind), jnp.asarray(slots),
                                 to_jax(rows, kind), jnp.asarray(gw),
                                 jnp.asarray(gV), jnp.asarray(vm), jepi,
                                 backend="jnp")
    assert_same_bits(got, want, kind)
    untouched = np.setdiff1d(np.arange(C), slots)
    np.testing.assert_array_equal(bits(got)[untouched],
                                  bits(table)[untouched])


@pytest.mark.parametrize("case", ["mixed", "all_oob"])
@pytest.mark.parametrize("kind", ["fp32", "bf16", "int8"])
def test_scatter_rows_ref_matches_jax(kind, case):
    _, tp = _params(kind, "appended_gap")
    table, _, _, _ = make_rows(tp, C, seed=5)
    slots = _slots(40 if case == "mixed" else 0, 64, seed=6)
    new, _, _, _ = make_rows(tp, 64, seed=7)
    got = tfused.scatter_rows(table.clone(), torch.from_numpy(slots), new)
    want = jax.jit(lambda t, s, r: jfused.scatter_rows(t, s, r, "jnp"))(
        to_jax(table, kind), jnp.asarray(slots), to_jax(new, kind))
    assert_same_bits(got, want, kind)
    if case == "all_oob":
        np.testing.assert_array_equal(bits(got), bits(table))


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("kind", KINDS)
def test_apply_count_matches_jax(kind, layout):
    jp, tp = _params(kind, layout)
    table, _, _, _ = make_rows(tp, C, seed=8)
    slots = _slots(70, 96, seed=9)
    counts = np.zeros(96, np.float32)
    counts[:70] = np.random.RandomState(10).randint(1, 4, 70)
    got = T.make_fns(tp).apply_count(
        T.SGDState(*([torch.zeros(0)] * 4), VVg=table.clone(),
                   v_live=torch.zeros(0, dtype=torch.bool)),
        torch.from_numpy(slots), torch.from_numpy(counts)).VVg
    jstate = J.SGDState(*([jnp.zeros(0, jnp.float32)] * 4),
                        VVg=to_jax(table, kind),
                        v_live=jnp.zeros(0, bool))
    want = jax.jit(J.make_fns(jp).apply_count)(
        jstate, jnp.asarray(slots), jnp.asarray(counts)).VVg
    assert_same_bits(got, want, kind)


def test_jitted_jax_contracts_the_epilogue():
    """Jitted on the CPU, XLA fuses the epilogue's multiply-adds into FMAs
    and divides by lr through its reciprocal, so some lanes move by an
    ulp against the op-by-op result the port (and the CUDA kernel)
    computes. z' = z - (g - ...) cancels, so the relative error there
    reaches 8e-5; everything stays within 1e-4 relative or 1e-5
    absolute."""
    jp, tp = _params("fp32", "appended_gap")
    rows, gw, gV, vm = make_rows(tp, 256, seed=1)
    got = T.row_epilogue(tp, C, rows, torch.from_numpy(gw),
                         torch.from_numpy(gV), torch.from_numpy(vm)).numpy()
    jit = np.asarray(jax.jit(lambda r, g, gv, v: J.row_epilogue(
        jp, C, r, g, gv, v))(rows.numpy(), gw, gV, vm))
    assert (bits(got) != bits(jit)).any()
    np.testing.assert_allclose(got, jit, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("kind", KINDS)
def test_apply_grad_matches_jax(kind):
    """The push that gathers its own rows: the gather, then the epilogue
    and the scatter, as JAX's ``apply_grad`` (run op by op)."""
    jp, tp = _params(kind, "appended_gap")
    table, _, _, _ = make_rows(tp, C, seed=11)
    slots = _slots(50, 64, seed=12)
    _, gw, gV, vm = make_rows(tp, 64, seed=13)
    got = T.make_fns(tp).apply_grad(
        T.SGDState(*([torch.zeros(0)] * 4), VVg=table.clone(),
                   v_live=torch.zeros(0, dtype=torch.bool)),
        torch.from_numpy(slots), torch.from_numpy(gw), torch.from_numpy(gV),
        torch.from_numpy(vm)).VVg
    jstate = J.SGDState(*([jnp.zeros(0, jnp.float32)] * 4),
                        VVg=to_jax(table, kind), v_live=jnp.zeros(0, bool))
    want = J.make_fns(jp).apply_grad(jstate, jnp.asarray(slots),
                                     jnp.asarray(gw), jnp.asarray(gV),
                                     jnp.asarray(vm)).VVg
    assert_same_bits(got, want, kind)


def _kernel_fp8_codes(y: np.ndarray) -> np.ndarray:
    """``f32_to_fp8e4m3fn`` of ops/csrc/scatter_epilogue.cu, step for step
    in numpy: c10's fp8e4m3fn_from_fp32_value, NaN (0x7F) for values at
    and above 480, for those that round up to it, and for +-Inf and NaN."""
    bits = y.astype(np.float32).view(np.uint32)
    sign = bits & np.uint32(0x80000000)
    f = bits ^ sign
    out = np.zeros(f.shape, np.uint32)
    big = f >= np.uint32(1087 << 20)
    small = ~big & (f < np.uint32(121 << 23))
    mid = ~big & ~small
    out[big] = 0x7F
    denorm = np.uint32(141 << 23).view(np.float32)
    added = (f[small].view(np.float32) + denorm).view(np.uint32)
    out[small] = added - np.uint32(141 << 23)
    m = f[mid]
    m = m + np.uint32(((7 - 127) << 23) % (1 << 32)) + np.uint32(0x7FFFF) \
        + ((m >> np.uint32(20)) & np.uint32(1))
    out[mid] = (m >> np.uint32(20)) & np.uint32(0xFF)
    return ((out & np.uint32(0xFF)) | (sign >> np.uint32(24))).astype(
        np.uint8)


def test_kernel_fp8_rule_matches_jax():
    """The fp8 requant codes of the CUDA kernel follow the JAX reference's
    cast (ml_dtypes' float8_e4m3fn): round to nearest even, subnormals
    included, and NaN past the finite range (from 464, which rounds up to
    480, and for +-Inf) rather than the saturation to 448 of newer c10.
    Every fp8 value, the midpoints between neighbours and a wide seeded
    sample of f32 values, both signs."""
    fp8 = np.arange(256, dtype=np.uint8).view(jnp.float8_e4m3fn)
    vals = np.asarray(fp8, np.float32)
    vals = np.sort(vals[np.isfinite(vals) & (vals >= 0)])
    mids = (vals[:-1] + vals[1:]) / 2
    rng = np.random.RandomState(0)
    wide = (rng.rand(20000) * 2 - 1).astype(np.float32) \
        * np.exp2(rng.randint(-30, 30, 20000)).astype(np.float32)
    edge = np.array([447.9, 448.0, 463.9, 464.0, 464.1, 479.9, 480.0, 1e10,
                     3e38, np.inf, np.nan, 1e-30, 2.0 ** -10, 2.0 ** -9.5],
                    np.float32)
    y = np.concatenate([vals, mids, np.nextafter(mids, 0),
                        np.nextafter(mids, np.inf), wide, edge])
    y = np.concatenate([y, -y]).astype(np.float32)
    want = np.asarray(jax.lax.bitcast_convert_type(
        jnp.asarray(y).astype(jnp.float8_e4m3fn), jnp.uint8))
    got = _kernel_fp8_codes(y)
    bad = np.flatnonzero(got != want)
    assert bad.size == 0, [(float(y[i]), int(got[i]), int(want[i]))
                           for i in bad[:10]]
    past = np.array([448.0, 464.0, 464.1, 480.0, 1e10, np.inf], np.float32)
    assert _kernel_fp8_codes(past).tolist() == [0x7E, 0x7E, 0x7F, 0x7F,
                                                0x7F, 0x7F]
