"""Device-pool backends (``pool.py``): ``LocalPool``, the single-device
pool the executor calls.  The sharded pool over ``torch.distributed``
is not ported yet (ROADMAP.md queue 1 item 5)."""
from repro_torch.sim.shard.pool import DevicePool, LocalPool, make_pool

__all__ = ["DevicePool", "LocalPool", "make_pool"]
