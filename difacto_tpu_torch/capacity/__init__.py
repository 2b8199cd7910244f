"""Table-capacity levers (counterpart of difacto_tpu/capacity), behind
SlotStore knobs that all default off:

- count-min admission (``admit_min_count``; :mod:`.sketch`): a sketch over
  the producers' hashed token stream gates slot allocation, so a rare
  feature never costs a row; occupancy eviction (``evict_occupancy``,
  ``SlotStore.maybe_evict``) reclaims the lowest-count rows at epoch ends;
- the host-RAM cold tier (``cold_tier_rows``; :mod:`.tier`): the device
  table holds only the hot rows, the tail lives in host RAM, and rows
  promote and demote in batches on the dispatch thread through the
  fused-row gather and scatter kernels.

Quantized slots (``slot_dtype`` int8/fp8) are the third lever and live in
the updater (updaters/sgd_updater.py).

Producer worker processes import :mod:`.sketch` and must not import
torch, so :class:`~.tier.ColdTier` is imported on first access.
"""

from .sketch import AdmissionFilter, CountMinSketch  # noqa: F401


def __getattr__(name: str):
    if name == "ColdTier":
        from .tier import ColdTier
        return ColdTier
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
