"""Device meshes, the ranks that run on them, and the card's peak rates
(the port of ``repro.launch.mesh``).

Two kinds of mesh:

* ``make_local_mesh``: a single-process object, a 1-D row of
  ``torch.device`` entries along one named axis, which the simulator's
  sharded pool drives from one controller (the reference's
  ``shard_map`` programs are likewise driven by one process); it needs
  no process group and can place several entries on one device, which
  is how a mesh is emulated on a host with fewer devices than shards.
* ``make_device_mesh``: the ('data', 'model') ``DeviceMesh`` over the
  ranks of a ``torch.distributed`` world, one device a rank, on which
  the LM steps run as DTensor programs (JAX's two-axis
  ``make_local_mesh(model_axis)``, ``src/repro/launch/mesh.py:39-59``).
  ``launch`` starts those ranks: ``gloo`` on the CPU, ``nccl`` on the
  cards with rank r on ``cuda:r``.

``HW`` holds the NVIDIA H100 SXM5 80 GB's published dense peaks at its
700 W limit (JAX's ``HW`` is a TPU v5e's and is not copied), and
``abstract_mesh`` is the device-free mesh the dry run resolves its
shardings on: the counterpart of ``make_production_mesh``, which needs
only the mesh's shape, never its devices.
"""
from __future__ import annotations

import dataclasses
import datetime
import math
import multiprocessing
import tempfile
import time
import traceback
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist


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


# ---------------------------------------------------------------- DeviceMesh
MESH_AXES = ("data", "model")


def mesh_shape(n: int, model_axis: Optional[int] = None) -> Tuple[int, int]:
    """JAX's ``make_local_mesh(model_axis)`` over ``n`` devices
    (``src/repro/launch/mesh.py:55-59``): the model axis is
    ``model_axis`` (default 1), the devices past a multiple of it are
    dropped, and the rest is the data axis."""
    m = model_axis or 1
    if n < m:
        raise RuntimeError(f"model_axis={m} needs {m} devices, found {n}")
    n = (n // m) * m                    # drop any remainder, as JAX does
    return n // m, m


def make_device_mesh(model_axis: Optional[int] = None, *,
                     device_type: str = "cuda"):
    """A ('data', 'model') ``DeviceMesh`` over every rank of the
    initialised world, shaped by ``mesh_shape``.  The world must hold
    exactly the mesh's devices: ``launch`` starts ``mesh_shape``'s
    product of ranks, so JAX's dropped remainder is never started."""
    from torch.distributed.device_mesh import init_device_mesh
    n = dist.get_world_size() if dist.is_initialized() else 1
    shape = mesh_shape(n, model_axis)
    if math.prod(shape) != n:
        raise RuntimeError(f"a world of {n} ranks cannot hold the mesh "
                           f"{shape}; start {math.prod(shape)} ranks")
    if not dist.is_initialized():
        raise RuntimeError("make_device_mesh needs an initialised process "
                           "group (run the ranks through launch())")
    return init_device_mesh(device_type, shape, mesh_dim_names=MESH_AXES)


# ---------------------------------------------------------------- launcher
def _rank_main(fn, rank: int, world: int, device_type: str, backend: str,
               tmp: str, threads: int) -> None:
    """One rank: join the world through ``file://`` in ``tmp``, run
    ``fn(*args)`` on the arguments saved in ``tmp`` (on the CPU with
    ``threads`` intra-op threads), save what it returns (or the
    traceback) in ``tmp``."""
    out = Path(tmp)
    try:
        kw: Dict[str, Any] = {}
        args = torch.load(out / "args.pt", weights_only=False)
        if device_type == "cpu":        # the caller's threads, shared
            torch.set_num_threads(threads)
        if device_type == "cuda":
            card = rank % torch.cuda.device_count()
            torch.cuda.set_device(card)
            if backend == "nccl":
                kw["device_id"] = torch.device("cuda", card)
        dist.init_process_group(
            backend,
            init_method=f"file://{out / 'rendezvous'}", world_size=world,
            rank=rank, timeout=datetime.timedelta(minutes=30), **kw)
        torch.save(fn(*args), out / f"result{rank}.pt")
    except BaseException:
        # written before the group is torn down, so that the rank that
        # failed first is the first to say so
        (out / f"error{rank}.txt").write_text(traceback.format_exc())
        raise SystemExit(1)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def launch(fn: Callable[..., Any], world: int, *, device_type: str = "cuda",
           args: Tuple = (), timeout: Optional[float] = 900.0,
           backend: Optional[str] = None) -> List[Any]:
    """Run ``fn(*args)`` on ``world`` ranks of one ``torch.distributed``
    world and return each rank's result (``torch.save``d, so plain
    tensors and Python values), rank 0 first.

    Each rank is a spawned process: ``fn`` must be importable (a
    module-level function).  They meet through ``file://`` in a
    temporary directory, so no TCP port can collide, and read ``args``
    from a file there: sent down each rank's pipe, arguments larger than
    the pipe would hold each rank's start until it had read them, and the
    ranks would start one after another.  ``gloo`` on the
    CPU, ``nccl`` on the cards (rank r on ``cuda:r``, one card a rank:
    ``nccl`` refuses two ranks on one card); ``backend="gloo"`` with
    ``device_type="cuda"`` puts rank r on card r modulo the cards.  The kernels are built here
    first, so the ranks find them built.  If a rank fails, or the ranks
    are not all done within ``timeout`` seconds of the host clock, every
    rank is killed and this raises with the first failing rank's
    traceback (``timeout=None``: no deadline; a collective that waits
    on a dead rank still fails after the process group's 30 minutes).
    The ranks share the caller's intra-op threads
    (``torch.get_num_threads()``, at least one a rank): ranks on the CPU
    that each took the host's cores would oversubscribe it, the more so
    beside other processes."""
    backend = backend or ("nccl" if device_type == "cuda" else "gloo")
    if device_type == "cuda":
        if backend == "nccl" and torch.cuda.device_count() < world:
            raise RuntimeError(f"{world} ranks need {world} cards under nccl "
                               f"(one a rank); this host has "
                               f"{torch.cuda.device_count()}")
        from repro_torch.kernels import _build
        _build.build()
    elif device_type != "cpu":
        raise ValueError(f"launch: device_type {device_type!r} is neither "
                         f"'cpu' nor 'cuda'")
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="repro_mesh_") as tmp:
        torch.save(args, Path(tmp, "args.pt"))
        threads = max(1, torch.get_num_threads() // world)
        procs = [ctx.Process(target=_rank_main,
                             args=(fn, r, world, device_type, backend, tmp,
                                   threads))
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline = None if timeout is None else time.monotonic() + timeout
        failed: Optional[str] = None
        try:
            while True:
                codes = [p.exitcode for p in procs]
                bad = [r for r, c in enumerate(codes) if c not in (None, 0)]
                if bad:
                    # the first rank that failed, not a rank that then
                    # lost its peer: give the others a moment to exit.  A
                    # rank that has written its traceback has failed, even
                    # while it still tears its group down
                    time.sleep(0.5)
                    errs = {r: Path(tmp, f"error{r}.txt")
                            for r in range(world)}
                    bad = [r for r, p in enumerate(procs)
                           if p.exitcode not in (None, 0) or errs[r].exists()]
                    first = min(bad, key=lambda r: errs[r].stat().st_mtime
                                if errs[r].exists() else float("inf"))
                    failed = (f"rank {first} of {world} failed (exit code "
                              f"{procs[first].exitcode}):\n"
                              + (errs[first].read_text()
                                 if errs[first].exists() else ""))
                    break
                if all(c == 0 for c in codes):
                    break
                if deadline is not None and time.monotonic() > deadline:
                    failed = (f"the {world} ranks did not finish within "
                              f"{timeout:.0f} s (exit codes {codes})")
                    break
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.exitcode is None:
                    p.kill()
            for p in procs:
                p.join()
        if failed:
            raise RuntimeError(f"launch: {failed}")
        return [torch.load(Path(tmp, f"result{r}.pt"), weights_only=False)
                for r in range(world)]
