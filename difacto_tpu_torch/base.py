"""Core types and feature-id utilities (counterpart of difacto_tpu/base.py).

- ``real_t`` -> float32 (``REAL_DTYPE``), ``feaid_t`` -> uint64
  (``FEAID_DTYPE``), as in the reference's include/difacto/base.h:16-20.
- ``reverse_bytes`` is the vectorised nibble reversal of feature ids
  (include/difacto/base.h:39-51) that makes ascending dense ids span the
  uint64 space uniformly; the hashed store slots the reversed ids.
- ``encode_fea_grp_id`` / ``decode_fea_grp_id`` pack a feature-group id
  into an id's low bits (the BCD learner's feature partition).
"""

from __future__ import annotations

import numpy as np

# value dtype used for weights/gradients on the host
REAL_DTYPE = np.float32
# raw feature-id dtype (uint64, like the reference's feaid_t)
FEAID_DTYPE = np.uint64


def reverse_bytes(x: np.ndarray | int) -> np.ndarray | int:
    """Reverse the nibbles of uint64 feature ids (vectorised). Applying it
    twice is the identity."""
    scalar = np.isscalar(x) or (isinstance(x, np.ndarray) and x.ndim == 0)
    x = np.asarray(x, dtype=np.uint64)
    x = (x << np.uint64(32)) | (x >> np.uint64(32))
    x = ((x & np.uint64(0x0000FFFF0000FFFF)) << np.uint64(16)) | \
        ((x & np.uint64(0xFFFF0000FFFF0000)) >> np.uint64(16))
    x = ((x & np.uint64(0x00FF00FF00FF00FF)) << np.uint64(8)) | \
        ((x & np.uint64(0xFF00FF00FF00FF00)) >> np.uint64(8))
    x = ((x & np.uint64(0x0F0F0F0F0F0F0F0F)) << np.uint64(4)) | \
        ((x & np.uint64(0xF0F0F0F0F0F0F0F0)) >> np.uint64(4))
    return x.item() if scalar else x


def encode_fea_grp_id(x, gid: int, nbits: int):
    """Pack a feature-group id into the low ``nbits`` bits of a feature id
    (``EncodeFeaGrpID``, include/difacto/base.h:60-63)."""
    if not 0 <= gid < (1 << nbits):
        raise ValueError(f"gid {gid} out of range for {nbits} bits")
    x = np.asarray(x, dtype=np.uint64)
    out = (x << np.uint64(nbits)) | np.uint64(gid)
    return out.item() if out.ndim == 0 else out


def decode_fea_grp_id(x, nbits: int):
    """The group id in the low ``nbits`` bits: the inverse of
    :func:`encode_fea_grp_id` (include/difacto/base.h:71-73)."""
    x = np.asarray(x, dtype=np.uint64)
    out = x & np.uint64((1 << nbits) - 1)
    return out.item() if out.ndim == 0 else out
