"""Device meshes and the card's peak rates (the port of
``repro.launch.mesh``).

A mesh here is a single-process object: a 1-D row of ``torch.device``
entries along one named axis.  One controller drives every device
through it (the reference's ``shard_map`` programs are likewise driven
by one process); it needs no process group and can place several
entries on one device, which is how a mesh is emulated on a host with
fewer devices than shards.

``HW`` holds the NVIDIA H100 SXM5 80 GB's published dense peaks at its
700 W limit (JAX's ``HW`` is a TPU v5e's and is not copied), and
``abstract_mesh`` is the device-free mesh the dry run resolves its
shardings on: the counterpart of ``make_production_mesh``, which needs
only the mesh's shape, never its devices.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Sequence, Tuple

import torch


# NVIDIA H100 SXM5 80 GB, per card (data sheet, dense rates without
# sparsity, at the 700 W power limit)
HW = {
    "name": "nvidia-h100-sxm5-80gb",
    "peak_flops_bf16": 989e12,     # tensor cores, bf16 and fp16
    "peak_flops_tf32": 495e12,     # tensor cores, TF32
    "peak_flops_fp32": 67e12,      # CUDA cores, fp32 FMA
    "hbm_bw": 3.35e12,             # bytes/s
    "hbm_bytes": 80e9,
    "nvlink_bw": 450e9,            # bytes/s each way, to the other cards
}


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """A mesh's shape without devices: ``shape`` maps each axis name to
    its size, as ``jax.sharding.Mesh.shape`` does."""
    axis_names: Tuple[str, ...]
    shape: Dict[str, int]

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())


def abstract_mesh(shape: Sequence[int],
                  axis_names: Sequence[str]) -> AbstractMesh:
    """A device-free mesh of ``shape`` along ``axis_names``: e.g. (16, 16)
    over ('data', 'model'), or (2, 16, 16) over ('pod', 'data', 'model')
    as JAX's production meshes."""
    if len(shape) != len(axis_names):
        raise ValueError(f"mesh shape {tuple(shape)} vs axes "
                         f"{tuple(axis_names)}")
    return AbstractMesh(tuple(axis_names),
                        dict(zip(axis_names, (int(n) for n in shape))))


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
