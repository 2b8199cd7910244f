"""The yardstick: the chip's published peaks, the table's row layout as
the configuration states it, and the operations and bytes a replayed
training step needs, counted from the batch's own sizes (tokens, rows,
in-bounds distinct slots, V_dim, row bytes) whatever implements it.

Each input byte is read once and each output byte written once; padded
slots count nothing. A step of ``T`` tokens over ``B`` rows and ``U``
distinct in-bounds slots with ``U_v`` of them embedding-active needs:

- bytes: the ``U`` table rows read and written (the pull and the push),
  the ``T`` token indices and the ``U`` slot ids read, the ``B`` labels
  read;
- operations: the forward's token sums of w, XV and XXVV (1 + 3k a
  token), each row's interaction and objective (3k + 8), the backward's
  token sums of p and p XV (k + 1 a token), each active slot's gV (3k),
  FTRL on every slot (15) and AdaGrad on the active ones (8k).

Float32 outside the tensor cores: the step has no matrix product.
"""

from __future__ import annotations

from typing import Tuple

# NVIDIA H100 SXM, dense rates (NVIDIA's data sheet)
PEAK_FLOPS = {"fp32": 67e12, "tf32": 495e12, "bf16": 989e12}
PEAK_HBM_BYTES_PER_S = 3.35e12
CUDA_ONLY = "the yardstick's peaks are an H100's: a CUDA device only"

_CONTAINER_BYTES = {"fp32": 4, "bf16": 2, "int8": 1, "fp8": 1}


def on_chip(device: str) -> bool:
    return str(device).startswith("cuda")


def share(least_s: float, measured_s: float, device: str) -> float:
    """The least time over the measured one, in %: a share of the chip's
    peak, which means nothing off the chip."""
    if not on_chip(device):
        raise ValueError(CUDA_ONLY)
    if measured_s <= 0:
        raise ValueError("no measured time")
    return 100.0 * least_s / measured_s


def row_layout(conf: dict) -> Tuple[int, int, int]:
    """(k, lanes, lane bytes) of the fused table row the configuration
    states: the embedding and its AdaGrad halves, each padded to 64 lanes
    while the padded table fits ``pad_v_rows_max_mb``, and 8 f32 scalars
    (inside the second half's pad when it has room, else appended, the
    row rounded up to 128 lanes)."""
    k = int(conf["V_dim"])
    kind = conf.get("slot_dtype", "fp32")
    if kind == "fp32" and conf.get("V_dtype") == "bfloat16":
        kind = "bf16"
    lane = _CONTAINER_BYTES[kind]
    cap = int(conf["hash_capacity"])
    h = -(-k // 64) * 64
    if not conf.get("pad_v_rows", True) or \
            cap * 2 * h * lane > int(conf.get("pad_v_rows_max_mb",
                                              1536)) << 20:
        h = k
    ns = 8 * (4 // lane)
    lanes = 2 * h if h - k >= ns else -(-(2 * h + ns) // 128) * 128
    return k, lanes, lane


def row_bytes(conf: dict) -> int:
    _, lanes, lane = row_layout(conf)
    return lanes * lane


def step_bytes(tokens: int, rows: int, slots: int, rb: int) -> int:
    """Bytes a training step needs (see the module docstring)."""
    return 2 * slots * rb + 4 * tokens + 4 * slots + 4 * rows


def step_flops(tokens: int, rows: int, slots: int, active: int,
               k: int) -> int:
    """Operations a training step needs (see the module docstring)."""
    return (tokens * (1 + 3 * k) + rows * (3 * k + 8)
            + tokens * (k + 1) + active * 3 * k + slots * 15
            + active * 8 * k)


def gather_bytes(slots: int, rb: int) -> int:
    """The pull: each in-bounds slot id read, its row read and written."""
    return slots * (2 * rb + 4)


def push_bytes(slots: int, active: int, k: int, rb: int) -> int:
    """The push with its epilogue: each in-bounds slot's id, gathered row,
    gw and mask read and its row written; gV read where the embedding is
    active."""
    return slots * (2 * rb + 12) + active * 4 * k


def least_seconds(flops: float, nbytes: float) -> float:
    """The least time the chip could take: the larger of the two bounds
    (float32 operations, HBM bytes)."""
    return max(flops / PEAK_FLOPS["fp32"], nbytes / PEAK_HBM_BYTES_PER_S)
