"""Sharded device-pool subsystem: the sim's device axis over a mesh of
local devices.

Layers (see each module's docstring):
  mesh.py — the 1-D 'devices' pool mesh (built through launch.mesh)
  ops.py  — per-shard building blocks (train / pair-divergence with
            cross-shard gather / alpha_combine_slab transfer / eval)
  pool.py — the DevicePool backend API the executors call: LocalPool
            (one device) and ShardedPool (pool axis partitioned, padded
            at this boundary only)
"""
from repro_torch.sim.shard.mesh import DEVICE_AXIS, make_pool_mesh
from repro_torch.sim.shard.pool import (DevicePool, LocalPool, ShardedPool,
                                        make_pool)

__all__ = ["DEVICE_AXIS", "make_pool_mesh", "DevicePool", "LocalPool",
           "ShardedPool", "make_pool"]
