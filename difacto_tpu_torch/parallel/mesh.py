"""The (dp, fs) device mesh of one process (counterpart of
difacto_tpu/parallel/mesh.py): the key-range "parameter server" of the
port.

- ``fs`` (feature shards): the slot table's capacity axis is cut into
  ``fs`` contiguous key ranges, the analog of ps-lite's key-range server
  sharding (src/store/kvstore_dist.h:90-118). Shard ``i`` owns the slots
  ``[i * C / fs, (i + 1) * C / fs)``; every pull and push of a batch is
  routed to the shards its sorted slot vector touches
  (parallel/sharded.py), one kernel launch per non-empty range.
- ``dp`` (data parallel): each batch's leading axes are cut into ``dp``
  equal blocks, the analog of DiFacto's data-parallel workers; each
  block's per-slot gradient partials are summed in dp order, one push
  per shard (step.py). The step is synchronous, as the JAX package's is.

Devices come from :func:`~difacto_tpu_torch.utils.platform.mesh_devices`:
the visible cards, or the CPU, each repeated
``DIFACTO_TORCH_VIRTUAL_DEVICES`` times, so the 2 x 4 mesh of the example
configs runs on one card (its eight logical devices all on that card) as
the JAX package's tests run it on eight virtual CPU devices. A mesh lies
on one physical device: the table is one tensor there and each shard and
each batch block is a view of it. A mesh over several cards raises
(placing each shard on its own card is a ROADMAP.md follow-up), as does
a mesh across processes (ROADMAP.md item 11b).

All shapes are padded to power-of-two-based buckets (ops/batch.py), so
power-of-two axes divide them (``mesh_dim_min``).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

DP_AXIS = "dp"
FS_AXIS = "fs"


class Mesh:
    """A ``dp x fs`` grid of logical devices (``devices[d][f]``, each a
    ``torch.device``, all the same physical one)."""

    def __init__(self, devices: Sequence[Sequence[torch.device]]):
        self.devices: List[List[torch.device]] = [list(r) for r in devices]
        self.shape = {DP_AXIS: len(self.devices),
                      FS_AXIS: len(self.devices[0])}

    @property
    def dp(self) -> int:
        return self.shape[DP_AXIS]

    @property
    def fs(self) -> int:
        return self.shape[FS_AXIS]

    @property
    def home(self) -> torch.device:
        """The one physical device of the mesh: the table, the batch and
        the step live there."""
        return self.devices[0][0]

    def __repr__(self) -> str:
        return f"Mesh(dp={self.dp}, fs={self.fs}, on {self.home})"


def process_count() -> int:
    """Processes of this run: torch.distributed's world size when it is
    initialized, else 1."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def check_single_process(what: str) -> None:
    """The multi-host branch of the JAX package's ``make_mesh``
    (mesh.py:53-65: the fs axis stays inside a host, a multi-host mesh
    uses every device) is not ported: more than one process raises."""
    n = process_count()
    if n > 1:
        raise NotImplementedError(
            f"{what} across {n} processes is not ported yet (ROADMAP.md, "
            "item 11b: multi-host under torch.distributed); this mesh runs "
            "in one process")


def make_mesh(dp: int = 1, fs: int = 1,
              devices: Optional[Sequence[torch.device]] = None,
              device="cuda") -> Mesh:
    """A (dp, fs) mesh over the first dp*fs logical devices of
    ``device``'s kind (utils/platform.mesh_devices) or of ``devices``.
    Axis sizes must be powers of two: every sharded dimension (the table
    capacity, the batch buckets) is padded to a power of two or 1.5 times
    one, so only power-of-two axes divide them evenly."""
    for name, v in ((DP_AXIS, dp), (FS_AXIS, fs)):
        if v < 1 or (v & (v - 1)) != 0:
            raise ValueError(f"mesh axis {name}={v} must be a power of two")
    n = dp * fs
    check_single_process("a mesh")
    if devices is None:
        from ..utils.platform import mesh_devices
        devices = mesh_devices(n, device)
    if len(devices) < n:
        raise ValueError(f"need {n} devices, have {len(devices)}")
    devices = list(devices)[:n]
    if len(set(devices)) > 1:
        raise NotImplementedError(
            f"a mesh over {len(set(devices))} physical devices is not "
            "ported yet (ROADMAP.md: the mesh on several cards, each "
            "shard on its own card); set DIFACTO_TORCH_VIRTUAL_DEVICES to "
            "put the mesh on one card")
    return Mesh([devices[d * fs:(d + 1) * fs] for d in range(dp)])


def fs_size(mesh: Optional[Mesh]) -> int:
    """The feature-shard degree of a mesh (1 for no mesh)."""
    return 1 if mesh is None else mesh.fs


def dp_size(mesh: Optional[Mesh]) -> int:
    """The data-parallel degree of a mesh (1 for no mesh)."""
    return 1 if mesh is None else mesh.dp


def validate_fs_capacity(capacity: int, fs: int) -> None:
    """The table's capacity must split into ``fs`` equal key ranges:
    power-of-two capacities always do, a user-chosen ``hash_capacity``
    may not. Fail at construction with the knob to fix."""
    if fs > 1 and capacity % fs:
        raise ValueError(
            f"table capacity {capacity} is not divisible by mesh fs={fs}: "
            "the slot table shards its capacity axis in contiguous "
            "key ranges, one per fs device — pick hash_capacity (or "
            "init_capacity) as a multiple of fs")


def fs_shard_bounds(capacity: int, fs: int):
    """[(lo, hi)] row ranges per fs shard: shard i owns slots
    [i*capacity/fs, (i+1)*capacity/fs); per-shard checkpoints slice and
    restore exactly these rows."""
    validate_fs_capacity(capacity, fs)
    rows = capacity // fs
    return [(i * rows, (i + 1) * rows) for i in range(fs)]


# ------------------------------------------------------------ placement
def state_sharding(mesh: Mesh):
    """The table's placement (JAX: ``P('fs', None)`` on every state
    leaf): a function of a [C, ...] tensor to its fs key-range shards,
    views of it (the mesh lies on one device)."""
    def place(x: torch.Tensor) -> list:
        return [x[lo:hi] for lo, hi in fs_shard_bounds(x.shape[0], mesh.fs)]
    return place


def batch_sharding(mesh: Mesh):
    """A batch leaf's placement (JAX: ``P('dp')``, scalars replicated):
    a function of a tensor to its ``dp`` leading-axis blocks, views of
    it. The leading axis must divide by dp (``mesh_dim_min`` sizes the
    buckets so)."""
    def place(x: torch.Tensor):
        if x.dim() == 0:
            return [x] * mesh.dp
        n = x.shape[0]
        if n % mesh.dp:
            raise ValueError(f"leading axis {n} does not split over "
                             f"dp={mesh.dp}")
        m = n // mesh.dp
        return [x[b * m:(b + 1) * m] for b in range(mesh.dp)]
    return place


def replicated(mesh: Mesh):
    """Replicated placement (JAX: ``P()``): the tensor on the mesh's
    device."""
    def place(x: torch.Tensor) -> torch.Tensor:
        return x if x.device == mesh.home else x.to(mesh.home)
    return place


def put_global(arr, placement):
    """Place a host array (numpy or tensor) with ``placement`` (one of
    the functions above). One process only: the JAX package's
    multi-process branch waits for ROADMAP.md item 11b."""
    check_single_process("put_global")
    x = arr if isinstance(arr, torch.Tensor) else torch.from_numpy(arr)
    return placement(x)


def put_dp_local(local_arr, mesh: Mesh):
    """This process's batch block split over dp (one process: the block
    is the global batch)."""
    check_single_process("put_dp_local")
    x = local_arr if isinstance(local_arr, torch.Tensor) \
        else torch.from_numpy(local_arr)
    return batch_sharding(mesh)(x.to(mesh.home))
