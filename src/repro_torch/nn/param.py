"""The port's ``repro.nn.param``: spec trees and their materialization.

Models declare a *spec tree*: nested dicts whose leaves are ``ParamSpec``
(shape + logical axes + initializer); ``materialize`` turns it into real
tensors.  Parameters are plain (nested) dicts of tensors in the JAX
package's shapes.  Their flat-vector form follows JAX's tree order (dict
keys sorted, each leaf raveled row-major), so a vector made here lines up
element for element with ``repro.nn.param.flatten_to_vector`` of the same
weights — the layout the ``alpha_combine`` transfer mixes.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]      # logical axis name per dim (or None)
    init: str = "normal"                 # normal (fan-in)|zeros|ones|embed
    scale: float = 1.0                   # stddev multiplier / fan-in override
    dtype: str = "float32"

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} vs axes {self.axes}")


def is_spec(x) -> bool:
    return isinstance(x, ParamSpec)


def _init_leaf(spec: ParamSpec, gen: torch.Generator) -> torch.Tensor:
    """One leaf, drawn on ``gen``'s device."""
    dtype = getattr(torch, spec.dtype)
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=dtype, device=gen.device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=dtype, device=gen.device)
    if spec.init == "embed":
        std = spec.scale
    elif spec.init == "normal":
        # fan-in scaled normal (lecun): last dim = fan-out
        std = spec.scale / math.sqrt(max(1, math.prod(spec.shape[:-1])))
    else:
        raise ValueError(f"unsupported init {spec.init!r}")
    return (torch.randn(spec.shape, generator=gen, dtype=torch.float32,
                        device=gen.device) * std).to(dtype)


def materialize(specs: Dict[str, Any], gen: torch.Generator, *,
                device: torch.device) -> Dict[str, Any]:
    """Real tensors for a (nested) spec dict, drawn leaf by leaf in JAX
    tree order (sorted keys, depth first) from ``gen``, then moved to
    ``device``.  A CPU generator gives the same weights on every device;
    a generator on the card draws there (the full-width LM's 1.24 B
    normals take seconds on a CPU generator)."""
    return {k: materialize(specs[k], gen, device=device)
            if isinstance(specs[k], dict)
            else _init_leaf(specs[k], gen).to(device) for k in sorted(specs)}


def count_params(tree) -> int:
    """Elements in a (nested) tree of specs or tensors."""
    if isinstance(tree, dict):
        return sum(count_params(v) for v in tree.values())
    return math.prod(tree.shape)


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts (``None`` is a leaf), in
    JAX's tree order: dict keys sorted, depth first."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    return fn(tree, *rest)


def tree_leaves(tree):
    """The leaves of nested dicts in JAX's tree order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    return [tree]


def flatten_to_vector(tree: Dict[str, Any], *,
                      lead: int = 0) -> torch.Tensor:
    """Concatenate every leaf of a (nested) dict in JAX tree order into
    one float32 vector; with ``lead=1`` the leaves carry a leading stack
    axis and the result is (S, P)."""
    parts = [t.reshape(*t.shape[:lead], -1).float() for t in tree_leaves(tree)]
    return torch.cat(parts, dim=lead)


def unflatten_from_vector(vec: torch.Tensor, like: Dict[str, Any],
                          *, lead: int = 0) -> Dict[str, Any]:
    """Inverse of ``flatten_to_vector``: the tree, shapes and dtypes from
    ``like`` (leaf shapes taken after its first ``lead`` axes); ``vec``'s
    own leading axes are kept."""
    head = vec.shape[:-1]
    off = 0

    def rebuild(t):
        nonlocal off
        if isinstance(t, dict):
            return {k: rebuild(t[k]) for k in sorted(t)}
        shape = t.shape[lead:]
        n = math.prod(shape)
        out = vec[..., off:off + n].reshape(*head, *shape).to(t.dtype)
        off += n
        return out

    return rebuild(like)
