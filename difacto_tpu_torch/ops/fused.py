"""Fused-row table ops (counterpart of difacto_tpu/ops/fused.py).

- :func:`gather_rows` — ONE gather of the batch's sorted-unique slot rows
  of the fused table, the pull of every step. On a CUDA table it
  launches the hand-written kernel ``csrc/gather_rows.cu`` (the port of
  the TPU kernel ``_pallas_gather``, difacto_tpu/ops/fused.py:254); on a
  CPU table it runs the plain version :func:`gather_rows_ref`.
- :func:`fm_update_rows` — the push of every train step: the per-row
  FTRL/AdaGrad epilogue and ONE scatter of the new rows into the table,
  in place. The kernel reads the epilogue's :class:`Epilogue` spec; the
  plain version calls the epilogue it is given
  (``updaters.sgd_updater.row_epilogue`` with its param bound, as the
  JAX package passes it), so this layer does not import the updater.
  :func:`scatter_rows`
  is the same write with the epilogue off (the epoch-0 count push). On a
  CUDA table both launch ``csrc/scatter_epilogue.cu`` (the port of the
  TPU kernel ``_scatter_epilogue``, difacto_tpu/ops/fused.py:337); on a
  CPU table they run :func:`fm_update_rows_ref` / :func:`scatter_rows_ref`.
- :func:`fm_chunk_grad_cuda` — the chunked-run FM backward of a step
  (``gw``, ``gV`` of the batch's lanes) as ``csrc/fm_chunk_grad.cu``,
  which ports no TPU kernel (the JAX package's is jnp). The loss
  (losses/fm.py) decides when it runs and keeps the plain version.

There is no fallback between kernel and plain version: a CUDA table that
a kernel cannot take raises. The four ``*_cuda`` entry points go through
``utils/devtrace.kernel`` (the counterpart of ``jaxtrace.pallas_call``):
the same functions with tracing off, launch-counting wrappers per entry
point with it on.
- :func:`dedup_tokens` — the device-dedup step's sort and run-length
  dedup of a batch's raw hashed tokens (torch ops, as the JAX package's
  is jnp: it is not a kernel of its own).
- :func:`quant_half` / :func:`dequant_half` — the per-row symmetric
  int8/fp8 quantization of the embedding halves (fp8 codes are
  ``torch.float8_e4m3fn`` bit patterns viewed as int8), bit-exact with
  the JAX package's jnp versions on rows whose amax and scale are normal
  f32 values (XLA on the CPU flushes subnormals, torch does not).

The JAX package's ``fused_kernel`` knob (auto|pallas|jnp|off) is parsed
by :class:`~difacto_tpu_torch.updaters.sgd_updater.SGDUpdaterParam` so its
configs load, and selects nothing here: the device of the table decides.
"""

from __future__ import annotations

import ctypes
from typing import Callable, NamedTuple, Optional, Tuple

import torch

from ..obs import trace
from ..utils import devtrace
from . import build
from .batch import CHUNK_L

# ------------------------------------------------------------------ dedup
def dedup_tokens(tok: torch.Tensor, u_cap: int, capacity: int):
    """The device twin of the producer's ``np.unique`` + ``pad_slots_oob``
    (the JAX package's ``dedup_tokens``): stable-sort the batch's raw
    int32 tokens, mark run starts, and the running count of starts gives
    each token its segment, the inverse map. Returns ``(slots, inverse,
    n_uniq)``:

    - ``slots`` int32[u_cap]: the sorted unique tokens, then ascending
      out-of-bounds pads ``capacity + j`` (the pad_slots_oob layout, so
      the table kernels' sorted-unique contract holds);
    - ``inverse`` int32[len(tok)]: each token's position in ``slots``;
    - ``n_uniq`` int32[]: the count of real slots, on the device.

    Each run's first token is written to its segment once; the other
    tokens aim at lane ``u_cap`` of a ``u_cap + 1`` buffer that is sliced
    off (torch has no drop mode), so there are no conflicting writes to a
    kept lane and no atomics. The caller guarantees ``n_uniq <= u_cap``
    (pack_stream.prepare_hashed sizes the cap)."""
    dev = tok.device
    cells = tok.shape[0]
    st, order = torch.sort(tok, stable=True)
    start = torch.ones(cells, dtype=torch.bool, device=dev)
    start[1:] = st[1:] != st[:-1]
    seg = torch.cumsum(start, dim=0, dtype=torch.int32) - 1
    n = seg[-1] + 1
    inverse = torch.empty(cells, dtype=torch.int32, device=dev)
    inverse[order] = seg
    first = torch.where(start, seg, u_cap).to(torch.int64)
    slots = torch.zeros(u_cap + 1, dtype=torch.int32, device=dev)
    slots[first] = st
    j = torch.arange(u_cap, dtype=torch.int32, device=dev)
    return torch.where(j < n, slots[:u_cap], capacity + j), inverse, n


# ------------------------------------------------------- quantized slots
_Q_MAX = {"int8": 127.0, "fp8": 448.0}  # fp8 = float8_e4m3fn finite max


def quant_half(x: torch.Tensor, kind: str):
    """f32 [n, m] half -> (int8 codes [n, m], f32 scale [n]).

    ``scale = max|row| / qmax`` (1.0 for all-zero rows); int8 codes round
    half-to-even and clip to [-127, 127], fp8 codes are float8_e4m3fn bit
    patterns (:func:`fp8_e4m3fn_codes`) viewed as int8."""
    amax = x.abs().amax(dim=1)
    # divide by a tensor on x's device: CUDA divides by a Python scalar as
    # a multiply by its reciprocal, which is not the IEEE quotient
    qmax = torch.full_like(amax, _Q_MAX[kind])
    scale = torch.where(amax > 0, amax / qmax, torch.ones_like(amax))
    y = x / scale[:, None]
    if kind == "int8":
        codes = torch.clamp(torch.round(y), -127.0, 127.0).to(torch.int8)
    else:
        codes = fp8_e4m3fn_codes(y)
    return codes, scale


def fp8_e4m3fn_codes(y: torch.Tensor) -> torch.Tensor:
    """f32 -> float8_e4m3fn bit patterns (as int8) by the JAX reference's
    rule (ml_dtypes): round to nearest even, subnormals included, and NaN
    (0x7F, with the sign) for values that round to 480 or beyond, for
    +-Inf and for NaN. c10's own cast saturates such values to +-448 in
    some torch versions, so the rule is written out here, step for step
    as the scatter kernel's ``f32_to_fp8e4m3fn`` (csrc/scatter_epilogue.cu)
    computes it, in int64 lanes."""
    bits = y.to(torch.float32).view(torch.int32).to(torch.int64) \
        & 0xFFFFFFFF
    sign = bits & 0x80000000
    f = bits ^ sign
    big = f >= (1087 << 20)                       # |y| >= 480, Inf, NaN
    small = f < (121 << 23)                       # below fp8's normals
    denorm = 141 << 23                            # the f32 bits of 2^14
    # subnormal codes: the f32 add of 2^14 rounds the mantissa for us
    sub = (f.to(torch.int32).view(torch.float32)
           + torch.full_like(y, 2.0 ** 14, dtype=torch.float32)
           ).view(torch.int32).to(torch.int64) - denorm
    mid = (f + (((7 - 127) << 23) + 0x7FFFF) + ((f >> 20) & 1)) >> 20
    code = torch.where(big, torch.full_like(f, 0x7F),
                       torch.where(small, sub, mid)) & 0xFF
    return (code | (sign >> 24)).to(torch.uint8).view(torch.int8)


def dequant_half(codes: torch.Tensor, scale: torch.Tensor, kind: str
                 ) -> torch.Tensor:
    """Inverse of :func:`quant_half`: int8 container codes + per-row scale
    -> f32 values."""
    if kind == "int8":
        f = codes.to(torch.float32)
    else:
        f = codes.view(torch.float8_e4m3fn).to(torch.float32)
    return f * scale[:, None]


# ----------------------------------------------------------------- gather
def gather_rows_ref(table: torch.Tensor, slots: torch.Tensor,
                    out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of the gather: ``index_select`` on clamped slots, then
    the out-of-bounds lanes zeroed (``out[j] = table[slots[j]]`` for
    ``0 <= slots[j] < C``, else 0). Copies move bits, never values, so the
    f32 scalar bits riding bf16/int8 lanes survive exactly. ``out`` (a
    [u, W] tensor, e.g. a slice of a larger output) receives the rows."""
    C = table.shape[0]
    s = slots.to(torch.int64)
    ok = (s >= 0) & (s < C)
    rows = table.index_select(0, torch.where(ok, s, torch.zeros_like(s)))
    rows = rows.masked_fill_(~ok.view(-1, *([1] * (rows.dim() - 1))), 0)
    if out is None:
        return rows
    return out.copy_(rows)


def gather_rows(table: torch.Tensor, slots: torch.Tensor,
                out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The fused-row gather: the CUDA kernel for a table on the card, the
    plain version for a table on the CPU. ``out`` is written in place
    when given (the sharded pull writes each shard's lanes into its
    slice of one output, parallel/sharded.py). Each call runs in the
    ``kernels.gather`` span (obs/trace.py)."""
    with trace.span("kernels.gather"):
        if table.device.type == "cuda":
            return gather_rows_cuda(table, slots, out)
        if table.device.type == "cpu":
            return gather_rows_ref(table, slots, out)
    raise ValueError(f"gather_rows: unsupported device {table.device}")


def _gather_fn():
    lib = build.library("gather_rows")
    fn = lib.difacto_gather_rows
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def gather_rows_cuda(table: torch.Tensor, slots: torch.Tensor,
                     out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch ``csrc/gather_rows.cu`` on the current stream. Checks what
    the kernel assumes and raises on anything else; allocates the output
    unless ``out`` (a contiguous [u, W] tensor of the table's dtype on its
    device, 16-byte aligned) is given, never synchronises.
    ``gather_rows_cuda.launches`` counts launches."""
    if table.device.type != "cuda" or slots.device != table.device:
        raise ValueError(f"gather_rows_cuda: table on {table.device} and "
                         f"slots on {slots.device}; both must be on one "
                         "CUDA device")
    if table.dim() != 2 or slots.dim() != 1:
        raise ValueError("gather_rows_cuda: want a [C, W] table and 1-D "
                         f"slots, got {tuple(table.shape)} and "
                         f"{tuple(slots.shape)}")
    if slots.dtype != torch.int32:
        raise TypeError(f"gather_rows_cuda: slots must be int32, got "
                        f"{slots.dtype}")
    if not (table.is_contiguous() and slots.is_contiguous()):
        raise ValueError("gather_rows_cuda: table and slots must be "
                         "contiguous")
    row_bytes = table.shape[1] * table.element_size()
    if row_bytes % 16 or table.data_ptr() % 16:
        raise ValueError(f"gather_rows_cuda: rows of {row_bytes} bytes at "
                         f"address {table.data_ptr():#x}; the kernel moves "
                         "16-byte vectors (row bytes and base address must "
                         "be multiples of 16)")
    u = slots.shape[0]
    if out is None:
        out = torch.empty((u, table.shape[1]), dtype=table.dtype,
                          device=table.device)
    elif (out.shape != (u, table.shape[1]) or out.dtype != table.dtype
          or out.device != table.device or not out.is_contiguous()
          or out.data_ptr() % 16):
        raise ValueError(f"gather_rows_cuda: out must be a contiguous, "
                         f"16-byte aligned [{u}, {table.shape[1]}] "
                         f"{table.dtype} tensor on {table.device}")
    if u == 0:
        return out
    # the library launches on the calling thread's current device
    with torch.cuda.device(table.device):
        rc = _gather_fn()(table.data_ptr(), slots.data_ptr(),
                          out.data_ptr(), table.shape[0], u, row_bytes,
                          torch.cuda.current_stream(
                              table.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"gather_rows kernel launch failed: CUDA error "
                           f"{rc}")
    gather_rows_cuda.launches += 1
    return out


gather_rows_cuda.launches = 0
gather_rows_cuda = devtrace.kernel(gather_rows_cuda)


# -------------------------------------------------------- scatter (push)
class Epilogue(NamedTuple):
    """What the scatter kernel's epilogue reads: the row layout (k, h,
    off), the container (``slot_dtype`` fp32 | bf16 | int8 | fp8; fp32
    with ``V_dtype=bfloat16`` is the bf16 container) and the eight
    hyperparameters, rounded to f32 as JAX rounds its weak-typed Python
    floats."""
    k: int
    h: int
    off: int
    kind: str
    hyper: tuple


def _in_bounds(table: torch.Tensor, slots: torch.Tensor) -> torch.Tensor:
    s = slots.to(torch.int64)
    return (s >= 0) & (s < table.shape[0])


def scatter_rows_ref(table: torch.Tensor, slots: torch.Tensor,
                     rows: torch.Tensor) -> torch.Tensor:
    """Plain version of the scatter: ``index_copy_`` of the rows whose slot
    is in bounds, in place; out-of-bounds pad lanes are dropped (the
    ``mode=drop`` contract). Copies move bits, never values."""
    ok = _in_bounds(table, slots)
    table.index_copy_(0, slots.to(torch.int64)[ok], rows[ok])
    return table


def fm_update_rows_ref(table: torch.Tensor, slots: torch.Tensor,
                       rows: torch.Tensor, gw: torch.Tensor,
                       gV: torch.Tensor, vmask: torch.Tensor,
                       epilogue: Callable) -> torch.Tensor:
    """Plain version of the fused push:
    ``scatter_rows_ref(table, slots, epilogue(rows, gw, gV, vmask))``."""
    return scatter_rows_ref(table, slots, epilogue(rows, gw, gV, vmask))


def scatter_rows(table: torch.Tensor, slots: torch.Tensor,
                 rows: torch.Tensor) -> torch.Tensor:
    """Write ``rows`` at ``slots`` in place (pad lanes dropped): the kernel
    with its epilogue off for a table on the card, the plain version for a
    table on the CPU."""
    if table.device.type == "cuda":
        return scatter_rows_cuda(table, slots, rows)
    if table.device.type == "cpu":
        return scatter_rows_ref(table, slots, rows)
    raise ValueError(f"scatter_rows: unsupported device {table.device}")


def fm_update_rows(table: torch.Tensor, slots: torch.Tensor,
                   rows: torch.Tensor, gw: torch.Tensor, gV: torch.Tensor,
                   vmask: torch.Tensor, epi: Epilogue, epilogue: Callable
                   ) -> torch.Tensor:
    """The fused push, in place: the kernel, which computes the epilogue
    that ``epi`` describes, for a table on the card; the plain version,
    which calls ``epilogue``, for a table on the CPU. Each call runs in
    the ``kernels.push`` span (obs/trace.py)."""
    with trace.span("kernels.push"):
        if table.device.type == "cuda":
            return fm_update_rows_cuda(table, slots, rows, gw, gV, vmask,
                                       epi)
        if table.device.type == "cpu":
            return fm_update_rows_ref(table, slots, rows, gw, gV, vmask,
                                      epilogue)
    raise ValueError(f"fm_update_rows: unsupported device {table.device}")


_CONTAINER = {"fp32": 0, "bf16": 1, "int8": 2, "fp8": 3}


# difacto_scatter_epilogue(table, slots, rows, gw, gV, vmask, capacity,
# n_rows, row_bytes, k, h, off, container, epilogue, hyper, stream)
SCATTER_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int64] * 8
                    + [ctypes.c_void_p, ctypes.c_void_p])


def _scatter_fn():
    lib = build.library("scatter_epilogue")
    fn = lib.difacto_scatter_epilogue
    if fn.argtypes is None:
        fn.argtypes = SCATTER_ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def _check_scatter(name: str, table: torch.Tensor, slots: torch.Tensor,
                   rows: torch.Tensor, extras=()) -> int:
    """What the scatter kernel assumes, checked; returns the row bytes."""
    dev = table.device
    if dev.type != "cuda" or any(t.device != dev
                                 for t in (slots, rows, *extras)):
        raise ValueError(f"{name}: table on {dev}, slots on {slots.device}, "
                         f"rows on {rows.device}; all must be on one CUDA "
                         "device")
    if table.dim() != 2 or slots.dim() != 1 or rows.dim() != 2 \
            or rows.shape != (slots.shape[0], table.shape[1]):
        raise ValueError(f"{name}: want a [C, W] table, 1-D slots [u] and "
                         f"[u, W] rows, got {tuple(table.shape)}, "
                         f"{tuple(slots.shape)} and {tuple(rows.shape)}")
    if slots.dtype != torch.int32:
        raise TypeError(f"{name}: slots must be int32, got {slots.dtype}")
    if rows.dtype != table.dtype:
        raise TypeError(f"{name}: rows are {rows.dtype}, the table "
                        f"{table.dtype}")
    if not all(t.is_contiguous() for t in (table, slots, rows, *extras)):
        raise ValueError(f"{name}: every tensor must be contiguous")
    row_bytes = table.shape[1] * table.element_size()
    if row_bytes % 16 or table.data_ptr() % 16 or rows.data_ptr() % 16:
        raise ValueError(f"{name}: rows of {row_bytes} bytes at addresses "
                         f"{table.data_ptr():#x}/{rows.data_ptr():#x}; the "
                         "kernel moves 16-byte vectors (row bytes and base "
                         "addresses must be multiples of 16)")
    return row_bytes


def _launch_scatter(table, slots, rows, row_bytes, gw=None, gV=None,
                    vmask=None, epi=None) -> None:
    u = slots.shape[0]
    if u == 0:
        return
    hyper = (ctypes.c_float * 8)(*(epi.hyper if epi else (0.0,) * 8))
    k, h, off = (epi.k, epi.h, epi.off) if epi else (0, 0, 0)
    # the library launches on the calling thread's current device
    with torch.cuda.device(table.device):
        rc = _scatter_fn()(
            table.data_ptr(), slots.data_ptr(), rows.data_ptr(),
            gw.data_ptr() if epi else None, gV.data_ptr() if epi else None,
            vmask.data_ptr() if epi else None, table.shape[0], u,
            row_bytes, k, h, off, _CONTAINER[epi.kind] if epi else 0,
            1 if epi else 0, ctypes.cast(hyper, ctypes.c_void_p),
            torch.cuda.current_stream(table.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"scatter_epilogue kernel launch failed: CUDA "
                           f"error {rc}")


def scatter_rows_cuda(table: torch.Tensor, slots: torch.Tensor,
                      rows: torch.Tensor) -> torch.Tensor:
    """Launch ``csrc/scatter_epilogue.cu`` with the epilogue off on the
    current stream, in place; never synchronises.
    ``scatter_rows_cuda.launches`` counts launches."""
    row_bytes = _check_scatter("scatter_rows_cuda", table, slots, rows)
    _launch_scatter(table, slots, rows, row_bytes)
    scatter_rows_cuda.launches += 1
    return table


def fm_update_rows_cuda(table: torch.Tensor, slots: torch.Tensor,
                        rows: torch.Tensor, gw: torch.Tensor,
                        gV: torch.Tensor, vmask: torch.Tensor,
                        epi: Epilogue) -> torch.Tensor:
    """Launch ``csrc/scatter_epilogue.cu`` with the epilogue on: the
    per-row FTRL/AdaGrad update of ``rows`` written in place at ``slots``.
    ``fm_update_rows_cuda.launches`` counts launches."""
    u = slots.shape[0]
    for name, t, shape in (("gw", gw, (u,)), ("vmask", vmask, (u,)),
                           ("gV", gV, (u, epi.k))):
        if t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise TypeError(f"fm_update_rows_cuda: {name} must be f32 "
                            f"{shape}, got {t.dtype} {tuple(t.shape)}")
    row_bytes = _check_scatter("fm_update_rows_cuda", table, slots, rows,
                               (gw, gV, vmask))
    esize = table.element_size()
    if epi.off * esize != row_bytes - 32 or epi.k > epi.h \
            or epi.kind not in _CONTAINER \
            or esize != {"fp32": 4, "bf16": 2, "int8": 1, "fp8": 1}[epi.kind]:
        raise ValueError(f"fm_update_rows_cuda: layout {epi[:4]} does not "
                         f"fit a {table.dtype} table of {row_bytes}-byte "
                         "rows")
    _launch_scatter(table, slots, rows, row_bytes, gw, gV, vmask, epi)
    fm_update_rows_cuda.launches += 1
    return table


scatter_rows_cuda.launches = 0
fm_update_rows_cuda.launches = 0
scatter_rows_cuda = devtrace.kernel(scatter_rows_cuda)
fm_update_rows_cuda = devtrace.kernel(fm_update_rows_cuda)


# ---------------------------------------------------- chunked backward
# difacto_fm_chunk_grad(p, xv, ldx, chunk_idx, chunk_lane, chunk_vals, V,
# ldv, v_bf16, vmask, starts, long_lane, scratch, gw, gV, B, C, U, k,
# group, stream)
CHUNK_GRAD_ARGTYPES = ([ctypes.c_void_p] * 2 + [ctypes.c_int64]
                       + [ctypes.c_void_p] * 4 + [ctypes.c_int64] * 2
                       + [ctypes.c_void_p] * 6 + [ctypes.c_int64] * 5
                       + [ctypes.c_void_p])


# the widest V the kernel sums (k + 2 columns over a block's threads)
CHUNK_GRAD_MAX_K = 510
# chunks a group (the kernel's kS: it refuses a launch that names another)
CHUNK_GRAD_GROUP = 32


def _chunk_grad_fn():
    lib = build.library("fm_chunk_grad")
    fn = lib.difacto_fm_chunk_grad
    if fn.argtypes is None:
        fn.argtypes = CHUNK_GRAD_ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def fm_chunk_grad_cuda(p: torch.Tensor, xv: torch.Tensor,
                       chunk_idx: torch.Tensor, chunk_lane: torch.Tensor,
                       chunk_vals: Optional[torch.Tensor], V: torch.Tensor,
                       v_mask: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch ``csrc/fm_chunk_grad.cu`` on the current stream: the
    chunked-run backward with embeddings, (gw f32[U], gV f32[U, k]), both
    contiguous. Takes p f32[B], xv f32[B, k], chunk_idx i32[C, 16] (pad
    slots ``B``), chunk_lane i32[C] (ascending; pad chunks ``>= U``),
    chunk_vals f32[C, 16] or None (a binary panel), V f32 or bf16 [U, k]
    and v_mask f32[U]. xv and V may be row slices of wider tensors (the
    forward's sums, the gathered fused rows): their columns must be
    contiguous; every other tensor must be. Checks what the kernel assumes
    and raises on anything else; allocates the outputs and the kernel's
    scratch, never synchronises. ``fm_chunk_grad_cuda.launches`` counts
    the calls (three kernel launches each)."""
    name = "fm_chunk_grad_cuda"
    dev = p.device
    ts = [("p", p), ("xv", xv), ("chunk_idx", chunk_idx),
          ("chunk_lane", chunk_lane), ("V", V), ("v_mask", v_mask)]
    if chunk_vals is not None:
        ts.append(("chunk_vals", chunk_vals))
    if dev.type != "cuda" or any(t.device != dev for _, t in ts):
        raise ValueError(f"{name}: " + ", ".join(
            f"{n} on {t.device}" for n, t in ts)
            + "; all must be on one CUDA device")
    want = {"p": (torch.float32,), "xv": (torch.float32,),
            "chunk_idx": (torch.int32,), "chunk_lane": (torch.int32,),
            "V": (torch.float32, torch.bfloat16),
            "v_mask": (torch.float32,), "chunk_vals": (torch.float32,)}
    for n, t in ts:
        if t.dtype not in want[n]:
            raise TypeError(f"{name}: {n} must be "
                            f"{' or '.join(map(str, want[n]))}, got "
                            f"{t.dtype}")
    B = p.shape[0] if p.dim() == 1 else -1
    U, k = V.shape if V.dim() == 2 else (-1, -1)
    C = chunk_lane.shape[0] if chunk_lane.dim() == 1 else -1
    shapes = {"p": (B,), "xv": (B, k), "chunk_idx": (C, CHUNK_L),
              "chunk_lane": (C,), "V": (U, k), "v_mask": (U,),
              "chunk_vals": (C, CHUNK_L)}
    if min(B, C, U) < 0 or not 1 <= k <= CHUNK_GRAD_MAX_K or any(
            tuple(t.shape) != shapes[n] for n, t in ts):
        raise ValueError(f"{name}: want p [B], xv [B, k], chunk_idx and "
                         f"chunk_vals [C, {CHUNK_L}], chunk_lane [C], V "
                         f"[U, k] (1 <= k <= {CHUNK_GRAD_MAX_K}) and v_mask "
                         "[U], got " + ", ".join(
                             f"{n} {tuple(t.shape)}" for n, t in ts))
    for n, t in ts:
        rows = n in ("xv", "V")
        if not (t.stride(-1) == 1 if rows else t.is_contiguous()):
            raise ValueError(f"{name}: {n} must be "
                             + ("row-major with contiguous columns"
                                if rows else "contiguous"))
    if chunk_idx.data_ptr() % 16 or (chunk_vals is not None
                                     and chunk_vals.data_ptr() % 16):
        raise ValueError(f"{name}: chunk_idx and chunk_vals must be "
                         "16-byte aligned (a chunk is four 16-byte loads)")
    if max(B, C, U + 1) >= 2 ** 31:
        raise ValueError(f"{name}: B {B}, C {C} and U {U} must fit int32")
    out = torch.empty(U * (k + 1), dtype=torch.float32, device=dev)
    gV, gw = out[:U * k].view(U, k), out[U * k:]
    if U == 0:
        return gw, gV
    # the kernel's scratch: partials [C, k + 2] (f32), then starts[U + 1]
    # and a slot for each run of its chunk groups (fewer than C; int32)
    scratch = torch.empty(C * (k + 2) + U + 1 + C, dtype=torch.float32,
                          device=dev)
    work = scratch[C * (k + 2):].view(torch.int32)
    # the library launches on the calling thread's current device
    with torch.cuda.device(dev):
        rc = _chunk_grad_fn()(
            p.data_ptr(), xv.data_ptr(), xv.stride(0), chunk_idx.data_ptr(),
            chunk_lane.data_ptr(),
            None if chunk_vals is None else chunk_vals.data_ptr(),
            V.data_ptr(), V.stride(0), int(V.dtype == torch.bfloat16),
            v_mask.data_ptr(), work.data_ptr(), work[U + 1:].data_ptr(),
            scratch.data_ptr(),
            gw.data_ptr(), gV.data_ptr(), B, C, U, k, CHUNK_GRAD_GROUP,
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fm_chunk_grad kernel launch failed: CUDA "
                           f"error {rc}")
    fm_chunk_grad_cuda.launches += 1
    return gw, gV


fm_chunk_grad_cuda.launches = 0
fm_chunk_grad_cuda = devtrace.kernel(fm_chunk_grad_cuda)
