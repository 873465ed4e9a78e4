"""Local device meshes (the port of ``repro.launch.mesh.make_local_mesh``).

A mesh here is a single-process object: a 1-D row of ``torch.device``
entries along one named axis.  One controller drives every device
through it (the reference's ``shard_map`` programs are likewise driven
by one process); it needs no process group and can place several
entries on one device, which is how a mesh is emulated on a host with
fewer devices than shards.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Sequence, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class LocalMesh:
    """``devices``: the mesh's entries in order; ``shape`` maps the axis
    name to its size (``mesh.shape["devices"]`` reads as in JAX)."""
    devices: Tuple[torch.device, ...]
    axis_names: Tuple[str, ...]
    shape: Dict[str, int]


def local_devices(device_type: str) -> Tuple[torch.device, ...]:
    """Every device of ``device_type`` this host has (the CPU is one)."""
    if device_type == "cuda":
        return tuple(torch.device("cuda", i)
                     for i in range(torch.cuda.device_count()))
    return (torch.device(device_type),)


def make_local_mesh(devices: Sequence[torch.device],
                    axis_name: str) -> LocalMesh:
    """A 1-D mesh over ``devices`` along ``axis_name``."""
    devs = tuple(devices)
    return LocalMesh(devices=devs, axis_names=(axis_name,),
                     shape={axis_name: len(devs)})
