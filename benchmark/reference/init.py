"""Frozen copy of the table's V initialisation: entry (r, j) is uniform
in +-V_init_scale/2 from a 32-bit counter hash of (seed, row, column),
computed in float32 for any set of rows."""

from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & _M32


def _mix32(x: torch.Tensor) -> torch.Tensor:
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def init_V(rows: torch.Tensor, k: int, seed: int, scale: float
           ) -> torch.Tensor:
    """float32 [len(rows), k]: the initial V of table rows ``rows``."""
    seed = int(seed) & _M32
    r = rows.to(torch.int64)[:, None]
    col = torch.arange(k, dtype=torch.int64, device=rows.device)[None, :]
    x = _mix32(_mix32((r & _M32) ^ seed) ^ (r >> 32))
    x = _mix32(x ^ _mix32(col ^ 0x9E3779B9))
    u = (x >> 8).to(torch.float32) * (1.0 / (1 << 24))
    return (u - 0.5) * torch.tensor(scale, dtype=torch.float32,
                                    device=rows.device)
