"""Device selection for the port's entry points.

Every entry point takes ``device=`` and defaults to ``"cuda"``. A CUDA
request on a machine without a visible GPU raises: the port never carries
on silently on the CPU, so a run that claims the card really used it. The
CPU is used only when the caller asks for it (``device="cpu"``, or
``device=cpu`` on the CLI), as the tests do.

:func:`mesh_devices` gives a (dp, fs) mesh its logical devices: the
physical ones, each repeated ``DIFACTO_TORCH_VIRTUAL_DEVICES`` times, the
port's counterpart of the JAX package's
``--xla_force_host_platform_device_count`` (``=8`` puts the example
configs' 2 x 4 mesh on one card, or on the CPU in the tests).

Across processes (parallel/multihost.py) a rank's card is
``cuda:{rank % device_count}`` (multihost.initialize makes it the
current device, so ``device=cuda`` resolves to it), and its
logical devices are that card repeated ``DIFACTO_TORCH_VIRTUAL_DEVICES``
times.
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device={str(device)!r} requested but no CUDA device is "
                "visible; pass device='cpu' (device=cpu on the CLI) to run "
                "on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {str(device)!r} "
                         "(expected cuda or cpu)")
    return dev


# logical devices per physical one (the port's counterpart of XLA's
# --xla_force_host_platform_device_count; see mesh_devices)
VIRTUAL_DEVICES_ENV = "DIFACTO_TORCH_VIRTUAL_DEVICES"
_LOGGED_SHARING: set = set()


def logical_devices(device="cuda") -> tuple:
    """(every logical device of ``device``'s kind, the repeat count):
    the physical devices (:func:`mesh_devices`; across processes this
    rank's card alone), each repeated ``DIFACTO_TORCH_VIRTUAL_DEVICES``
    times."""
    import os

    from ..parallel.multihost import process_count
    dev = resolve_device(device)
    if dev.type == "cuda" and process_count() > 1:
        phys = [dev]
    elif dev.type == "cuda":
        phys = [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    else:
        phys = [torch.device("cpu")]
    raw = os.environ.get(VIRTUAL_DEVICES_ENV, "1").strip() or "1"
    try:
        rep = int(raw)
    except ValueError:
        raise ValueError(f"{VIRTUAL_DEVICES_ENV}={raw!r} is not an "
                         "integer") from None
    if rep < 1:
        raise ValueError(f"{VIRTUAL_DEVICES_ENV}={rep} must be >= 1")
    return [d for d in phys for _ in range(rep)], rep


def mesh_devices(n: int, device="cuda") -> list:
    """The logical devices a mesh of ``n`` places its shards and blocks
    on, the counterpart of ``jax.devices()`` in the JAX package's
    ``make_mesh``: every visible card for ``cuda``, the one CPU device for
    ``cpu``, each repeated ``DIFACTO_TORCH_VIRTUAL_DEVICES`` times (default
    1) in order, so logical device ``i`` is physical device
    ``i // repeat``. The variable is the port's counterpart of the JAX
    package's ``--xla_force_host_platform_device_count=8`` (its tests run
    every mesh on 8 virtual CPU devices): it lets a 2 x 4 mesh run on one
    card, each shard a key range of its own allocations on that card, as
    it would be on a card of its own. With fewer
    than ``n`` logical devices it raises the JAX package's "need n
    devices, have m"; it never quietly puts several shards on one device.
    A logical device that shares a physical one is logged once at INFO,
    with the mapping."""
    import logging

    logical, rep = logical_devices(device)
    if len(logical) < n:
        raise ValueError(f"need {n} devices, have {len(logical)}")
    key = (logical[0].type, len(logical), rep, n)
    if rep > 1 and key not in _LOGGED_SHARING:
        _LOGGED_SHARING.add(key)
        logging.getLogger("difacto_tpu_torch").info(
            "mesh: %d logical devices on %d physical (%s=%d): %s", n,
            len({str(d) for d in logical[:n]}), VIRTUAL_DEVICES_ENV, rep,
            ", ".join(f"{i}->{d}" for i, d in enumerate(logical[:n])))
    return logical[:n]
