"""Logical-axis -> mesh-axis sharding rules (MaxText-style): the port of
``repro.nn.sharding``.

Rules are an ordered list ``(logical_name, candidate mesh axes)``.  Resolution
walks each array dim: the first candidate mesh axis that (a) exists in the
mesh, (b) is not already used by another dim of the same array, and (c)
divides the dim size, is taken; otherwise the dim is replicated.  This gives
divisibility-safe fallback (e.g. kv_heads=8 on a model=16 axis -> replicate,
kv_heads=32 -> shard).

The resolution is pure Python: a mesh is anything with a ``.shape``
dict of axis sizes (the port's ``launch.mesh.LocalMesh`` and
``abstract_mesh``), as JAX's resolution reads it; a ``DeviceMesh`` is
read through ``mesh_view``.  ``spec_for`` and
``activation_spec`` return the port's own ``PartitionSpec``;
``tree_shardings`` gives ``NamedSharding``s whose ``shard_shape`` is a
leaf's per-device shape.

On a ``DeviceMesh`` the specs become DTensor layouts, DTensor standing
where GSPMD stands in JAX: ``placements`` turns a ``PartitionSpec`` into
one ``Shard``/``Replicate`` a mesh dim, ``distribute`` lays a tree out
by its shardings, and ``constrain`` (JAX's ``with_sharding_constraint``,
``src/repro/nn/sharding.py:177-183``) ``redistribute``s a DTensor to
the activation's spec; a plain tensor passes through, as JAX's is a
no-op outside a mesh.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                      distribute_tensor)

from repro_torch.nn import param as param_lib

Rules = List[Tuple[str, Tuple[str, ...]]]

# Baseline (paper-faithful / standard FSDP+TP) rule set.
DEFAULT_RULES: Rules = [
    ("batch",    ("pod", "data")),
    ("clients",  ("data",)),          # FL client axis in decentralized runtime
    ("vocab",    ("model",)),
    ("embed",    ("data",)),          # FSDP shard of the contracting dim
    ("embed_act", ("model",)),        # residual-stream activations: TP shard
    ("mlp",      ("model",)),
    ("heads",    ("model",)),
    ("kv_heads", ("model",)),
    ("qkv",      ()),                 # head_dim: replicated
    ("experts",  ("expert",)),        # only if an expert axis exists
    ("layers",   ()),                 # scan-stacked leading dim: replicated
    ("state",    ()),
    ("seq",      ()),
    ("kv_seq",   ()),
]

# Hillclimb variants.
EXPERT_PARALLEL_RULES: Rules = [
    ("batch",    ("pod", "data")),
    ("clients",  ("data",)),
    ("vocab",    ("model",)),
    ("experts",  ("data",)),          # expert-parallel over the data axis
    ("embed",    ("data",)),
    ("embed_act", ("model",)),
    ("mlp",      ("model",)),
    ("heads",    ("model",)),
    ("kv_heads", ("model",)),
    ("qkv",      ()),
    ("layers",   ()),
    ("state",    ()),
    ("seq",      ()),
    ("kv_seq",   ()),
]

SEQ_PARALLEL_RULES: Rules = DEFAULT_RULES[:-2] + [
    ("seq",      ("model",)),         # long-context: shard sequence
    ("kv_seq",   ("model",)),
]

# Pure FSDP (ZeRO-3-style): batch sharded over EVERY mesh axis, parameters
# sharded (embed->data, mlp/heads->model) and all-gathered just-in-time at
# use; no tensor-parallel sharding of the residual stream.
FSDP_RULES: Rules = [
    ("batch",    ("pod", "data", "model")),
    ("clients",  ("data",)),
    ("vocab",    ("model",)),
    ("embed",    ("data",)),
    ("embed_act", ()),                # residual stream: no TP
    ("mlp",      ("model",)),
    ("heads",    ("model",)),
    ("kv_heads", ("model",)),
    ("qkv",      ()),
    ("experts",  ()),
    ("layers",   ()),
    ("state",    ()),
    ("seq",      ()),
    ("kv_seq",   ()),
]

RULE_SETS: Dict[str, Rules] = {
    "default": DEFAULT_RULES,
    "expert_parallel": EXPERT_PARALLEL_RULES,
    "seq_parallel": SEQ_PARALLEL_RULES,
    "fsdp": FSDP_RULES,
}


class PartitionSpec(tuple):
    """``jax.sharding.PartitionSpec``'s counterpart: one entry a dim, each
    ``None`` (replicated), a mesh axis name, or a tuple of names (the dim
    split jointly over them; a tuple of one name is that name, as JAX
    stores it)."""

    def __new__(cls, *entries):
        return super().__new__(cls, (e[0] if isinstance(e, tuple)
                                     and len(e) == 1 else e
                                     for e in entries))

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A leaf's layout on ``mesh``: ``spec`` names the mesh axes that split
    each dim (JAX's ``NamedSharding(mesh, spec)``)."""
    mesh: Any
    spec: PartitionSpec

    def shard_shape(self, global_shape: Sequence[int]) -> Tuple[int, ...]:
        """The per-device shape: each dim divided by the product of the
        mesh axes that shard it (the rules shard only a dim they divide)."""
        out = list(global_shape)
        for i, entry in enumerate(self.spec):
            if entry is None:
                continue
            names = entry if isinstance(entry, tuple) else (entry,)
            split = math.prod(self.mesh.shape[n] for n in names)
            if out[i] % split:
                raise ValueError(f"dim {i} of {tuple(global_shape)} is not "
                                 f"divisible by {names} ({split})")
            out[i] //= split
        return tuple(out)


def spec_for(shape: Sequence[int], axes: Sequence[Optional[str]],
             mesh, rules: Rules) -> PartitionSpec:
    rule_map = dict(rules)
    used: set = set()
    out = []
    for dim, name in zip(shape, axes):
        assigned = None
        if name == "batch":
            # batch may span several mesh axes jointly (pod x data) — e.g.
            # decode KV caches: without this, a (2,16,16) mesh shards the
            # cache batch only 2-way over 'pod' and residency blows up 16x.
            multi = []
            size = 1
            for cand in rule_map.get(name, ()):
                if cand in mesh.shape and cand not in used \
                        and mesh.shape[cand] > 1 \
                        and dim % (size * mesh.shape[cand]) == 0:
                    multi.append(cand)
                    used.add(cand)
                    size *= mesh.shape[cand]
            assigned = tuple(multi) if multi else None
        elif name is not None:
            for cand in rule_map.get(name, ()):  # ordered candidates
                if cand in mesh.shape and cand not in used \
                        and dim % mesh.shape[cand] == 0 and mesh.shape[cand] > 1:
                    assigned = cand
                    used.add(cand)
                    break
        out.append(assigned)
    # trim trailing Nones for tidier specs
    while out and out[-1] is None:
        out.pop()
    return PartitionSpec(*out)


def _tree_map_specs(fn, tree):
    """``fn`` over the ``ParamSpec`` leaves of nested dicts and tuples (a
    decode cache is a tuple of dicts in some families)."""
    if isinstance(tree, dict):
        return {k: _tree_map_specs(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map_specs(fn, v) for v in tree)
    if param_lib.is_spec(tree):
        return fn(tree)
    return tree


def tree_pspecs(specs_tree, mesh, rules: Rules):
    """ParamSpec tree -> PartitionSpec tree."""
    return _tree_map_specs(
        lambda s: spec_for(s.shape, s.axes, mesh, rules), specs_tree)


def tree_shardings(specs_tree, mesh, rules: Rules):
    return _tree_map_specs(
        lambda s: NamedSharding(mesh, spec_for(s.shape, s.axes, mesh, rules)),
        specs_tree)


def activation_spec(mesh, rules: Rules, *axes: Optional[str],
                    dims: Optional[Sequence[int]] = None) -> PartitionSpec:
    """PartitionSpec for an activation with the given logical axes.

    ``batch`` may map to multiple mesh axes (pod+data) which PartitionSpec
    expresses as a tuple entry.
    """
    rule_map = dict(rules)
    used: set = set()
    out = []
    for i, name in enumerate(axes):
        if name is None:
            out.append(None)
            continue
        cands = [c for c in rule_map.get(name, ())
                 if c in mesh.shape and c not in used and mesh.shape[c] > 1]
        if dims is not None:
            cands = [c for c in cands if dims[i] % mesh.shape[c] == 0]
        if name == "batch":
            # use every available candidate jointly (pod, data)
            multi = []
            size = 1
            for c in cands:
                if dims is None or dims[i] % (size * mesh.shape[c]) == 0:
                    multi.append(c)
                    size *= mesh.shape[c]
                    used.add(c)
            out.append(tuple(multi) if multi else None)
        else:
            out.append(cands[0] if cands else None)
            if cands:
                used.add(cands[0])
    while out and out[-1] is None:
        out.pop()
    return PartitionSpec(*out)


# ---------------------------------------------------------------- DTensor
def mesh_view(mesh):
    """``mesh`` as the rules read it: a ``DeviceMesh`` becomes its axis
    sizes; any other mesh is returned as it is."""
    if hasattr(mesh, "mesh_dim_names"):
        from repro_torch.launch.mesh import abstract_mesh
        return abstract_mesh(mesh.shape, mesh.mesh_dim_names)
    return mesh


def placements(spec: PartitionSpec, device_mesh) -> List[Any]:
    """One DTensor placement a mesh dim: ``Shard(i)`` where dim ``i`` of
    ``spec`` names the mesh dim (alone or in a tuple, which splits the
    dim over each of its axes, the first outermost, as JAX lays it out),
    else ``Replicate()``."""
    names = device_mesh.mesh_dim_names
    out: List[Any] = [Replicate()] * len(names)
    for i, entry in enumerate(spec):
        if entry is None:
            continue
        for name in (entry if isinstance(entry, tuple) else (entry,)):
            out[names.index(name)] = Shard(i)
    return out


def distribute(tree, shardings, device_mesh):
    """``tree``'s tensors (nested dicts and tuples) as DTensors laid out by
    the ``NamedSharding`` at the same place of ``shardings``.  Every rank
    passes the same full tensors, and each keeps its own shard of them
    (no rank's copy is sent); a DTensor is redistributed where its
    layout differs."""
    if isinstance(tree, dict):
        return {k: distribute(v, shardings[k], device_mesh)
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(distribute(v, s, device_mesh)
                          for v, s in zip(tree, shardings))
    if tree is None:
        return None
    want = placements(shardings.spec, device_mesh)
    if isinstance(tree, DTensor):
        return tree if list(tree.placements) == want \
            else tree.redistribute(device_mesh, want)
    return distribute_tensor(tree, device_mesh, want, src_data_rank=None)


def full(tree):
    """Every DTensor of a tree (nested dicts and tuples) gathered into a
    plain tensor on each rank; other leaves are returned as they are."""
    if isinstance(tree, dict):
        return {k: full(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(full(v) for v in tree)
    return tree.full_tensor() if isinstance(tree, DTensor) else tree


def constrain(x: torch.Tensor, mesh, rules: Rules, *axes: Optional[str]):
    """``x`` laid out by the logical ``axes`` (resolved against ``x``'s
    dims): a DTensor is ``redistribute``d (an all-gather, a reduce-scatter
    or a local slice, as the placements differ); a plain tensor is
    returned as it is."""
    if not isinstance(x, DTensor):
        return x
    dm = x.device_mesh
    spec = activation_spec(mesh_view(dm), rules, *axes, dims=x.shape)
    want = placements(spec, dm)
    if tuple(want) == tuple(x.placements):
        return x
    return x.redistribute(dm, want)
