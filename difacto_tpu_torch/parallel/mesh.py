"""The (dp, fs) device mesh of one process (counterpart of
difacto_tpu/parallel/mesh.py): the key-range "parameter server" of the
port.

- ``fs`` (feature shards): the slot table's capacity axis is cut into
  ``fs`` contiguous key ranges, the analog of ps-lite's key-range server
  sharding (src/store/kvstore_dist.h:90-118). Shard ``f`` owns the slots
  ``[f * C / fs, (f + 1) * C / fs)`` and lives on ``devices[0][f]``, one
  allocation of its own per state leaf (parallel/sharded.ShardedState);
  every pull and push of a batch is routed to the shards its sorted slot
  vector touches (parallel/sharded.py), one kernel launch per non-empty
  range, on the shard's device.
- ``dp`` (data parallel): each batch's leading axes are cut into ``dp``
  equal blocks, the analog of DiFacto's data-parallel workers; each
  block's per-slot gradient partials are summed in dp order, one push
  per shard (step.py). The step is synchronous, as the JAX package's is.
  The batch, the pulled rows, the loss and the dp partials live on the
  home device ``devices[0][0]``.

Devices come from :func:`~difacto_tpu_torch.utils.platform.mesh_devices`:
the visible cards, or the CPU, each repeated
``DIFACTO_TORCH_VIRTUAL_DEVICES`` times, so the 2 x 4 mesh of the example
configs runs on one card (its eight logical devices all on that card) as
the JAX package's tests run it on eight virtual CPU devices, and on four
cards shard ``f`` sits on card ``f``. A logical device is a placement of
its own whatever card it maps to: every shard is its own allocation, and
every move between logical devices is an explicit copy through
:func:`device_copy`, so one card (or the CPU) runs the code a host of
several cards runs.

Across processes (parallel/multihost.py, launch.py) the dp axis spans
them, host-major, as in the JAX package (mesh.py:53-65): process ``r``
holds the dp blocks ``dp_local`` = ``[r * dp / n, (r + 1) * dp / n)``,
and ``fs`` stays inside each process, so every process holds a whole
replica of the fs-sharded table on its card
(``cuda:{rank % device_count}``).

All shapes are padded to power-of-two-based buckets (ops/batch.py), so
power-of-two axes divide them (``mesh_dim_min``).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from ..utils import collscan

DP_AXIS = "dp"
FS_AXIS = "fs"


class Mesh:
    """A ``dp x fs`` grid of logical devices. ``devices[d][f]`` (each the
    ``torch.device`` of the physical device it maps to) are this
    process's rows of the grid: its dp blocks ``dp_local``, a range of
    the global dp axis (all of it in one process). Shard ``f`` of the
    table lives on ``devices[0][f]``."""

    def __init__(self, devices: Sequence[Sequence[torch.device]],
                 dp: Optional[int] = None, dp_lo: int = 0):
        self.devices: List[List[torch.device]] = [list(r) for r in devices]
        self.dp_local = range(dp_lo, dp_lo + len(self.devices))
        self.shape = {DP_AXIS: dp or len(self.devices),
                      FS_AXIS: len(self.devices[0])}

    @property
    def dp(self) -> int:
        return self.shape[DP_AXIS]

    @property
    def fs(self) -> int:
        return self.shape[FS_AXIS]

    @property
    def home(self) -> torch.device:
        """The mesh's home device, ``devices[0][0]``: the batch, the
        pulled rows, the loss, the dp partials and shard 0 live there."""
        return self.devices[0][0]

    @property
    def shard_devices(self) -> List[torch.device]:
        """The device of each fs shard, in shard order."""
        return list(self.devices[0])

    def __repr__(self) -> str:
        return (f"Mesh(dp={self.dp}, fs={self.fs}, dp_local="
                f"[{self.dp_local.start}, {self.dp_local.stop}), shards on "
                f"{', '.join(str(d) for d in self.devices[0])})")


def make_mesh(dp: int = 1, fs: int = 1,
              devices: Optional[Sequence[torch.device]] = None,
              device="cuda") -> Mesh:
    """A (dp, fs) mesh over the first dp*fs logical devices of
    ``device``'s kind (utils/platform.mesh_devices) or of ``devices``.
    Axis sizes must be powers of two: every sharded dimension (the table
    capacity, the batch buckets) is padded to a power of two or 1.5 times
    one, so only power-of-two axes divide them evenly. ``devices`` may
    name distinct physical devices (``cuda:0`` .. ``cuda:3``: shard ``f``
    on card ``f``) or repeat one; nothing is allocated here.

    Across processes the JAX package's rules hold (mesh.py:53-65 and its
    learner's sgd.py:473-478): the mesh uses every logical device of
    every process, ``fs`` divides a process's count (the table is whole
    in each process) and ``dp`` is a multiple of the process count; this
    process gets its ``dp / n`` rows."""
    from .multihost import process_count, process_index
    for name, v in ((DP_AXIS, dp), (FS_AXIS, fs)):
        if v < 1 or (v & (v - 1)) != 0:
            raise ValueError(f"mesh axis {name}={v} must be a power of two")
    n = dp * fs
    nproc = process_count()
    if nproc > 1:
        from ..utils.platform import logical_devices
        local = list(devices) if devices is not None \
            else logical_devices(device)[0]
        if n != len(local) * nproc:
            raise ValueError(
                f"multi-host meshes must use every device: dp*fs={n} != "
                f"{len(local) * nproc} global devices")
        if fs > len(local) or len(local) % fs:
            raise ValueError(
                f"mesh fs={fs} must divide the local device count "
                f"{len(local)} (the feature-sharded table must be "
                "host-complete)")
        if dp % nproc:
            raise ValueError(f"mesh_dp={dp} must be a multiple of the host "
                             f"count {nproc}")
        dp_local = dp // nproc
        devices = local
        n = dp_local * fs
    else:
        dp_local = dp
    if devices is None:
        from ..utils.platform import mesh_devices
        devices = mesh_devices(n, device)
    if len(devices) < n:
        raise ValueError(f"need {n} devices, have {len(devices)}")
    devices = [torch.device(d) for d in list(devices)[:n]]
    return Mesh([devices[d * fs:(d + 1) * fs] for d in range(dp_local)],
                dp=dp, dp_lo=process_index() * dp_local)


def fs_size(mesh: Optional[Mesh]) -> int:
    """The feature-shard degree of a mesh (1 for no mesh)."""
    return 1 if mesh is None else mesh.fs


def dp_size(mesh: Optional[Mesh]) -> int:
    """The global data-parallel degree of a mesh (1 for no mesh)."""
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
def _stream_of(device: torch.device):
    return torch.cuda.current_stream(device) if device.type == "cuda" \
        else None


def device_copy(x: torch.Tensor, device=None,
                out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The one move between logical devices: a copy of ``x`` into ``out``
    (or into a new tensor on ``device``). It always copies, also when both
    logical devices map to one card, so that one card and the CPU run the
    code of a host of several cards. On cards it is ordered against the
    kernels of both devices' current streams with events, without a host
    sync: the copy runs on the source's current stream once the
    destination's stream has reached it, and the destination's stream
    waits for the copy (one stream, as on one card, orders it by itself).
    With ``DIFACTO_HLOSCAN=1`` the bytes it moves are recorded through
    utils/collscan (kind ``device_copy``), never as a table-axis
    collective."""
    if out is None:
        out = torch.empty(x.shape, dtype=x.dtype, device=device)
    src, dst = _stream_of(x.device), _stream_of(out.device)
    if src is None or dst is None or src == dst:
        out.copy_(x)
    else:
        ready = torch.cuda.Event()
        ready.record(dst)
        src.wait_event(ready)
        with torch.cuda.device(x.device), torch.cuda.stream(src):
            out.copy_(x, non_blocking=True)
        done = torch.cuda.Event()
        done.record(src)
        dst.wait_event(done)
    if collscan.enabled():
        collscan.record_collective("device_copy", x.shape, x.dtype,
                                   x.numel() * x.element_size(), 1,
                                   skip_files=(__file__,))
    return out


def state_sharding(mesh: Mesh):
    """The table's placement (JAX: ``P('fs', None)`` on every state
    leaf): a function of a [C, ...] tensor to its fs key-range shards,
    shard ``f`` copied (:func:`device_copy`) into an allocation of its
    own on ``mesh.devices[0][f]``."""
    def place(x: torch.Tensor) -> list:
        return [device_copy(x[lo:hi], dev) for (lo, hi), dev in zip(
            fs_shard_bounds(x.shape[0], mesh.fs), mesh.shard_devices)]
    return place


def batch_sharding(mesh: Mesh):
    """A batch leaf's placement (JAX: ``P('dp')``, scalars replicated):
    a function of this process's batch tensor to its ``dp_local`` leading
    axis blocks, views of it. The leading axis must divide by their count
    (``mesh_dim_min`` sizes the buckets so)."""
    nb = len(mesh.dp_local)

    def place(x: torch.Tensor):
        if x.dim() == 0:
            return [x] * nb
        n = x.shape[0]
        if n % nb:
            raise ValueError(f"leading axis {n} does not split over "
                             f"dp={nb}")
        m = n // nb
        return [x[b * m:(b + 1) * m] for b in range(nb)]
    return place


def replicated(mesh: Mesh):
    """Replicated placement (JAX: ``P()``): the tensor on the mesh's
    device."""
    def place(x: torch.Tensor) -> torch.Tensor:
        return x if x.device == mesh.home else x.to(mesh.home)
    return place


def put_global(arr, placement):
    """Place a host array (numpy or tensor) with ``placement`` (one of
    the functions above). Across processes every process passes the same
    value (a replicated input, a same-seed init) and places its copy."""
    x = arr if isinstance(arr, torch.Tensor) else torch.from_numpy(arr)
    return placement(x)


def put_dp_local(local_arr, mesh: Mesh):
    """This process's batch block split over its ``dp_local`` blocks: the
    global batch is every process's block in process order (host-major,
    the JAX package's ``put_dp_local``); in one process the block is the
    global batch."""
    x = local_arr if isinstance(local_arr, torch.Tensor) \
        else torch.from_numpy(local_arr)
    return batch_sharding(mesh)(x.to(mesh.home))
