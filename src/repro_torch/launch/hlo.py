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
from collections import defaultdict
from typing import Any, Dict, List, Tuple

import torch
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
             "_has_compatible_shallow_copy_type", "set_"}


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


class StepCounter(TorchDispatchMode):
    """Counts the ops run while it is active (``with StepCounter() as c:
    out = fn(*args)``; then ``c.analysis()``).  It sees each op once: the
    ops inside a kernel op's implementation are not counted."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.hbm_bytes = 0
        self.per_collective: Dict[str, List[int]] = defaultdict(
            lambda: [0, 0])
        self._rules: Dict[Any, Tuple] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        rule = self._rules.get(func)
        if rule is None:
            rule = self._rules[func] = self._rule(func)
        formula, coll, free = rule
        if formula is not None:
            self.flops += formula(*args, **kwargs, out_val=out)
        if coll is not None:
            moved = _nbytes((out,)) * (2 if coll == "all-reduce" else 1)
            self.per_collective[coll][0] += 1
            self.per_collective[coll][1] += moved
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

    def analysis(self) -> HloAnalysis:
        per = {k: (c, b) for k, (c, b) in self.per_collective.items()}
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
