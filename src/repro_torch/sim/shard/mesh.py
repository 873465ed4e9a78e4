"""The sim's device-pool mesh: a 1-D 'devices' axis over local devices
(the port of ``repro.sim.shard.mesh``).

The sharded pool partitions the POOL axis (the leading device axis of
NetworkState / StackedClients) into one contiguous block of pool slots
per shard.  The mesh is built through ``launch.mesh.make_local_mesh``;
the reference's trailing 1-wide 'model' axis is left out, as nothing
reads it.

Shard s sits on the (i + s)-th device of the engine's type, where
``cuda:i`` is the engine's device (``cuda:s`` for the default
``cuda:0``).  A host with fewer devices than shards emulates them only
when asked: ``emulate=True`` places every shard on the one given device
(the counterpart of JAX's ``--xla_force_host_platform_device_count``),
which the CPU tests and a one-card run use.  Nothing emulates by itself.
"""
from __future__ import annotations

import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.launch.mesh import LocalMesh, local_devices, make_local_mesh

#: the pool-partition axis name ('devices': pool slots, not chips)
DEVICE_AXIS = "devices"


def make_pool_mesh(n_shards: int, device: DeviceLike = None, *,
                   emulate: bool = False) -> LocalMesh:
    """'devices' mesh of ``n_shards`` shards on consecutive devices of
    ``device``'s type starting at ``device`` (the GPU unless the caller
    passes "cpu"), or all on ``device`` itself with ``emulate=True``.  A
    mesh of 1 is valid, so the sharded pipeline can always be
    exercised."""
    dev = resolve_device(device)
    n = int(n_shards)
    if n < 1:
        raise ValueError(f"n_shards must be >= 1, got {n}")
    if emulate:
        return make_local_mesh((dev,) * n, DEVICE_AXIS)
    avail = local_devices(dev.type)
    first = dev.index if dev.index is not None else (
        torch.cuda.current_device() if dev.type == "cuda" else 0)
    if first + n > len(avail):
        raise RuntimeError(
            f"pool mesh wants {n} {dev.type} devices from {dev} on, but "
            f"the host has {len(avail)}; to emulate {n} shards on one "
            f"device, ask for it: SimulationEngine(cfg, emulate=True) (or "
            f"make_pool / ShardedPool with emulate=True)")
    return make_local_mesh(avail[first:first + n], DEVICE_AXIS)
