"""Durable training state (counterpart of difacto_tpu/durability): three
legs beside the verified checkpoints (utils/manifest.py, the store's
save/load), all off by default.

- :mod:`.wal` — the write-ahead delta log: between checkpoints the
  touched rows of the last ``wal_flush_batches`` steps are appended as
  CRC'd segments, so recovery = base generation + ordered deltas;
- :mod:`.replicate` — the async peer push of the checkpoint family and
  its live WAL chain after each commit (``replica_peers``,
  ``replica_k``), with an anti-entropy scrub;
- :mod:`.recover` — the ladder ``auto_resume`` climbs: local walk-back ->
  peer fetch -> WAL replay to head.
"""

from . import recover, replicate, wal  # noqa: F401
from .replicate import Replicator, fetch_family  # noqa: F401
from .wal import ReplayResult, WalCorrupt, WalWriter  # noqa: F401
