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
import hashlib
import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

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


@dataclasses.dataclass(frozen=True)
class ShapeDtype:
    """A model input's shape and dtype (``jax.ShapeDtypeStruct``'s
    counterpart): what ``abstract`` turns into a ``meta`` tensor."""
    shape: Tuple[int, ...]
    dtype: str

    @property
    def ndim(self) -> int:
        return len(self.shape)


def abstract(specs, device="meta"):
    """Empty tensors of a tree (dicts and tuples) of ``ParamSpec`` or
    ``ShapeDtype`` leaves, on ``device``: on ``meta`` (the default) they
    hold shapes and dtypes only and allocate nothing (JAX's
    ``abstract``, which gives ``ShapeDtypeStruct``s)."""
    if isinstance(specs, dict):
        return {k: abstract(v, device) for k, v in specs.items()}
    if isinstance(specs, tuple):
        return tuple(abstract(v, device) for v in specs)
    return torch.empty(specs.shape, dtype=getattr(torch, specs.dtype),
                       device=device)


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


# elements drawn at once by ``draw_shard`` (256 MB of fp32 normals)
DRAW_CHUNK = 1 << 26


def shard_bounds(shape: Sequence[int], spec, mesh_sizes: Dict[str, int],
                 coord: Dict[str, int]) -> List[Tuple[int, int]]:
    """(start, stop) of each dim held by the device at ``coord`` (mesh
    axis -> index) under ``spec`` (a ``PartitionSpec``): a dim split over
    several axes takes them first outermost, as JAX lays it out."""
    out = []
    for i, n in enumerate(shape):
        entry = spec[i] if i < len(spec) else None
        names = () if entry is None else \
            (entry if isinstance(entry, tuple) else (entry,))
        idx, split = 0, 1
        for name in names:
            idx = idx * mesh_sizes[name] + coord[name]
            split *= mesh_sizes[name]
        size = n // split
        out.append((idx * size, (idx + 1) * size))
    return out


def _chunk_seed(seed: int, path: str, chunk: int) -> int:
    digest = hashlib.sha256(f"{seed}/{path}/{chunk}".encode()).digest()
    return int.from_bytes(digest[:8], "little") & (2 ** 63 - 1)


def draw_shard(spec: ParamSpec, seed: int, path: str,
               bounds: Sequence[Tuple[int, int]],
               device) -> torch.Tensor:
    """The block ``bounds`` of leaf ``path``, drawn so that it does not
    depend on how the leaf is split: the leaf is cut along dim 0 into
    chunks of about ``DRAW_CHUNK`` elements, each drawn whole from a
    generator on ``device`` seeded from (``seed``, ``path``, chunk
    index), and the block is cut out of the chunks it overlaps.  At most
    one chunk is held besides the block."""
    dtype = getattr(torch, spec.dtype)
    shape = tuple(b - a for a, b in bounds)
    if spec.init in ("zeros", "ones"):
        fill = torch.zeros if spec.init == "zeros" else torch.ones
        return fill(shape, dtype=dtype, device=device)
    std = spec.scale if spec.init == "embed" else \
        spec.scale / math.sqrt(max(1, math.prod(spec.shape[:-1])))
    if spec.init not in ("embed", "normal"):
        raise ValueError(f"unsupported init {spec.init!r}")
    rest = spec.shape[1:]
    rows = max(1, DRAW_CHUNK // max(1, math.prod(rest)))
    inner = tuple(slice(a, b) for a, b in bounds[1:])
    (r0, r1), parts = bounds[0], []
    gen = torch.Generator(device=device)
    for c in range(r0 // rows, (r1 - 1) // rows + 1):
        lo = c * rows
        n = min(rows, spec.shape[0] - lo)
        gen.manual_seed(_chunk_seed(seed, path, c))
        block = torch.randn((n,) + tuple(rest), generator=gen,
                            dtype=torch.float32, device=device)
        a, b = max(r0, lo) - lo, min(r1, lo + n) - lo
        parts.append((block[(slice(a, b),) + inner] * std).to(dtype))
        del block
    return torch.cat(parts) if len(parts) > 1 else parts[0].contiguous()


def materialize_on_mesh(specs: Dict[str, Any], seed: int, device_mesh,
                        shardings: Dict[str, Any]) -> Dict[str, Any]:
    """DTensor parameters on ``device_mesh``, each laid out by the
    ``NamedSharding`` at its place in ``shardings``, each rank making
    only its own shard.

    On a CPU mesh every rank draws the leaves whole from one CPU
    generator seeded ``seed``, in JAX tree order, as ``materialize``
    does with that generator, and keeps its shard: the weights equal a
    one-process run's.  On the cards each rank draws its shard through
    ``draw_shard`` on its card: no rank holds a whole leaf (granite-34b's
    stacked MLP leaf is 53 GB in fp32), and the draws do not depend on
    the mesh.  DTensor's own random ops are not used: its offset-based
    RNG tracker shifts a shard's Philox offset by the shard's linear
    index times its size, which matches the unsplit draw only where a
    shard is a contiguous range of the leaf, not for a shard of dim 1
    or later."""
    from torch.distributed.tensor import DTensor
    from repro_torch.nn.sharding import placements
    names = device_mesh.mesh_dim_names
    sizes = dict(zip(names, device_mesh.shape))
    coord = dict(zip(names, device_mesh.get_coordinate()))
    dev = torch.device(device_mesh.device_type,
                       torch.cuda.current_device()) \
        if device_mesh.device_type == "cuda" else torch.device("cpu")
    cpu_gen = torch.Generator().manual_seed(seed) \
        if dev.type == "cpu" else None

    def leaf(spec, sharding, path):
        bounds = shard_bounds(spec.shape, sharding.spec, sizes, coord)
        if cpu_gen is not None:
            local = _init_leaf(spec, cpu_gen)[
                tuple(slice(a, b) for a, b in bounds)].contiguous()
        else:
            local = draw_shard(spec, seed, path, bounds, dev)
        return DTensor.from_local(
            local, device_mesh, placements(sharding.spec, device_mesh),
            run_check=False, shape=torch.Size(spec.shape),
            stride=torch.empty(spec.shape, device="meta").stride())

    def walk(tree, shard, path):
        return {k: walk(tree[k], shard[k], f"{path}/{k}")
                if isinstance(tree[k], dict)
                else leaf(tree[k], shard[k], f"{path}/{k}")
                for k in sorted(tree)}

    return walk(specs, shardings, "")


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
