"""Step accounting: FLOPs, HBM bytes and collective traffic of the ops a
step runs (the port of ``repro.launch.hlo``, which walks XLA's optimized
HLO text; the name is kept so that a reader finds it).

``analyze_step(fn, *args)`` runs ``fn`` once under one
``TorchDispatchMode`` and counts every op that reaches the dispatcher:

  * FLOPs: ``torch.utils.flop_counter``'s registry (``mm``, ``bmm``,
    ``addmm``, ``baddbmm``, ``convolution``, SDPA, ...) plus the formulas
    the four kernel ops register (``repro_torch::flash_attention``,
    ``::gla_chunked``, ``::alpha_combine``, ``::disagreement``).
    Elementwise flops are left out, as in JAX: they are roofline-irrelevant
    next to the matmuls.
  * HBM bytes: operand bytes + result bytes of every op that is not a
    view or metadata op (JAX's ``_FREE_OPS``: reshapes, views, empty
    buffers, iota).  A kernel op counts its inputs read once and its
    outputs written once: its byte bound.
  * collective bytes: result bytes (x2 for all-reduce: ring =
    reduce-scatter + all-gather) of every ``_c10d_functional``
    collective; 0 on one device.
  * a function that ATen decomposes differently by device
    (``F.one_hot``: a bounds check, zeros and a scatter on the CPU, zeros
    and a scatter on the card, a comparison and a cast on ``meta``) is
    counted as its decomposition on ``meta``, on every device, so that a
    count on the CPU or the card equals the dry run's.

On a mesh the counter counts one rank: its own.  An op on DTensors is
let through (``NotImplemented``), so DTensor runs it, and what DTensor
then runs comes back to the counter: each op on this rank's local
shards (a matmul on its shards, a kernel op at its local shapes through
the op's sharding rule) and each ``_c10d_functional`` collective that a
redistribution inserts.  DTensor's planning is no work of the rank and
is not counted: its shape inference runs the op on the global shapes
under a ``FakeTensorMode``, and an op with no sharding rule of its own
is planned by running its decomposition on global ``meta`` tensors (the
first call at each layout only; later calls find the plan cached).  So
a DTensor step over a ``"fake"`` process group on ``meta`` shards counts
what rank 0 of a live world counts, on its first call or any later one
(the partitioned dry run, ``launch/dryrun.py``).

What differs from JAX's count.  PyTorch runs eagerly: every op's
operands and result go through device memory, where XLA fuses chains of
elementwise ops and counts only a fusion's boundary.  So the bytes here
are an upper bound on what XLA's fused count would say.  A loop is counted
once a trip as it runs (JAX derives scan multiplicities from trip
counts).  JAX's walk counts a Pallas custom call as zero FLOPs; the port
counts a kernel by its formula: the work the function needs (flash: 4·D
per live (query, key) pair), which is what the kernel's bound column in
``PERF.md`` uses.  The counts hold on any device, ``meta`` included, where
nothing is computed and nothing allocated.
"""
from __future__ import annotations

import dataclasses
import functools
import threading
from collections import defaultdict
from typing import Any, Dict, List, Tuple

import torch
from torch.distributed.tensor import DTensor
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry


# the _c10d_functional collectives, by JAX's HLO op names
COLLECTIVE_OPS = {
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}

# ops that move no bytes (JAX's _FREE_OPS: parameter, constant, bitcast,
# reshape, iota, ...): views are found by their schema, these by name
_FREE_OPS = {"empty", "empty_like", "empty_strided", "new_empty",
             "new_empty_strided", "_unsafe_view", "lift_fresh", "arange",
             "wait_tensor", "_local_scalar_dense", "sym_size", "sym_stride",
             "sym_numel", "sym_storage_offset", "is_same_size",
             "_has_compatible_shallow_copy_type", "set_",
             "_wrap_tensor_autograd", "scalar_tensor"}


def _nbytes(values) -> int:
    """Bytes of the tensors among ``values`` and in the lists, tuples and
    dicts among them (an op's arguments and results nest no deeper)."""
    total = 0
    for x in values:
        if isinstance(x, torch.Tensor):
            total += x.numel() * x.element_size()
        elif isinstance(x, (list, tuple)):
            total += _nbytes(x)
        elif isinstance(x, dict):
            total += _nbytes(x.values())
    return total


@dataclasses.dataclass
class HloAnalysis:
    flops: float                         # per step, on the devices it ran on
    hbm_bytes: float
    collective_bytes: float
    per_collective: Dict[str, Tuple[int, int]]   # op -> (count, bytes)

    def as_dict(self):
        return {"flops": self.flops, "hbm_bytes": self.hbm_bytes,
                "collective_bytes": self.collective_bytes,
                "per_collective": {k: {"count": c, "bytes": b}
                                   for k, (c, b) in
                                   self.per_collective.items()}}


_PLANNING = threading.local()


def _planning() -> bool:
    """Whether DTensor is planning an op (module docstring): under its
    ``FakeTensorMode``, or inside its decomposition-based propagation."""
    return getattr(_PLANNING, "depth", 0) > 0 or torch._C._get_dispatch_mode(
        torch._C._TorchDispatchModeKey.FAKE) is not None


@functools.lru_cache(None)
def _mark_decomposition_planning() -> None:
    """Wrap DTensor's decomposition-based propagation (which runs an op's
    decomposition on global ``meta`` tensors, and builds a mesh the first
    time) so that ``_planning`` sees it; the wrapper only keeps a depth.
    Where this torch has no such propagation there is nothing to mark."""
    try:
        from torch.distributed.tensor._decompositions import \
            DecompShardingStrategy as strategy
    except ImportError:
        return
    plan = strategy.propagate_strategy

    @functools.wraps(plan)
    def propagate_strategy(*args, **kwargs):
        _PLANNING.depth = getattr(_PLANNING, "depth", 0) + 1
        try:
            return plan(*args, **kwargs)
        finally:
            _PLANNING.depth -= 1

    strategy.propagate_strategy = propagate_strategy


# composite functions whose decomposition ATen picks by device
_BY_DEVICE = {"one_hot"}


class _AsOnMeta(TorchFunctionMode):
    """Has ``counter`` count each call of a ``_BY_DEVICE`` function on
    plain tensors off ``meta`` as the same call on ``meta`` (the module's
    docstring)."""

    def __init__(self, counter):
        super().__init__()
        self.counter = counter

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        tensors = [a for a in args if isinstance(a, torch.Tensor)]
        if getattr(func, "__name__", None) not in _BY_DEVICE or any(
                isinstance(t, DTensor) or t.is_meta for t in tensors):
            return func(*args, **kwargs)
        self.counter._inside += 1        # the counter skips what runs here
        try:
            out = func(*args, **kwargs)
            meta = [a.to("meta") if isinstance(a, torch.Tensor) else a
                    for a in args]
            with StepCounter() as on_meta:
                func(*meta, **kwargs)
        finally:
            self.counter._inside -= 1
        self.counter.flops += on_meta.flops
        self.counter.hbm_bytes += on_meta.hbm_bytes
        return out


class StepCounter(TorchDispatchMode):
    """Counts the ops run while it is active (``with StepCounter() as c:
    out = fn(*args)``; then ``c.analysis()``).  It sees each op once: the
    ops inside a kernel op's implementation are not counted.  On DTensors
    it counts this rank's local ops and collectives (the module's
    docstring); ``buffers`` keeps each collective's count and bytes by
    (collective, result shape, dtype), and ``largest`` the buffers that
    moved most."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.hbm_bytes = 0
        self.buffers: Dict[Tuple, List[int]] = defaultdict(lambda: [0, 0])
        self._rules: Dict[Any, Tuple] = {}
        self._inside = 0                 # in a _BY_DEVICE function
        self._as_on_meta = _AsOnMeta(self)
        _mark_decomposition_planning()

    def __enter__(self):
        self._as_on_meta.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        super().__exit__(*exc)
        return self._as_on_meta.__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self._inside or _planning():
            return out
        rule = self._rules.get(func)
        if rule is None:
            rule = self._rules[func] = self._rule(func)
        formula, coll, free = rule
        if formula is not None:
            self.flops += formula(*args, **kwargs, out_val=out)
        if coll is not None:
            first = out[0] if isinstance(out, (list, tuple)) else out
            buf = self.buffers[(coll, tuple(first.shape), str(first.dtype))]
            buf[0] += 1
            buf[1] += _nbytes((out,)) * (2 if coll == "all-reduce" else 1)
        if not free:
            self.hbm_bytes += _nbytes(args) + _nbytes(kwargs.values()) \
                + _nbytes((out,))
        return out

    @staticmethod
    def _rule(func):
        """(FLOP formula or None, collective name or None, moves no
        bytes) of an op overload."""
        packet = func._overloadpacket
        name = packet.__name__
        coll = COLLECTIVE_OPS.get(name) \
            if func.namespace == "_c10d_functional" else None
        return (flop_registry.get(packet), coll,
                func.is_view or name in _FREE_OPS)

    def largest(self, n: int = 5) -> List[Tuple]:
        """(collective, shape, dtype, count, bytes) of the ``n`` buffers
        that moved the most bytes."""
        return [(*k, *v) for k, v in sorted(
            self.buffers.items(), key=lambda kv: -kv[1][1])[:n]]

    def analysis(self) -> HloAnalysis:
        per: Dict[str, Tuple[int, int]] = {}
        for (coll, *_), (c, b) in self.buffers.items():
            n, nb = per.get(coll, (0, 0))
            per[coll] = (n + c, nb + b)
        return HloAnalysis(
            flops=float(self.flops), hbm_bytes=float(self.hbm_bytes),
            collective_bytes=float(sum(b for _, b in per.values())),
            per_collective=per)


def analyze_step(fn, *args) -> HloAnalysis:
    """Run ``fn(*args)`` once and count what it does."""
    with StepCounter() as counter:
        fn(*args)
    return counter.analysis()


# Back-compat shim (JAX's dryrun.py used it)
@dataclasses.dataclass
class CollectiveStats:
    per_op: Dict[str, Tuple[int, int]]
    total_bytes: int


def collective_stats(fn, *args) -> CollectiveStats:
    a = analyze_step(fn, *args)
    return CollectiveStats(per_op=a.per_collective,
                           total_bytes=int(a.collective_bytes))
