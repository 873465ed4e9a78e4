"""Build the port's CUDA kernels from the sources in the checkout.

Each ``kernels/<name>/csrc/<name>.cu`` is compiled by ``nvcc`` on its own
into a shared library with a plain C interface (no PyTorch headers, so a
build takes seconds) and loaded with ``ctypes``.  Libraries go to
``build/repro_torch/`` at the repository root, named by a hash of the
source, so an edited source is rebuilt and an unchanged one is not.
There is no fallback: a missing ``nvcc`` or a failed build raises.
No kernel has a backward pass: ``refuse_grad`` stops a CUDA call whose
output autograd would need to differentiate.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Optional, Sequence, Tuple

import torch

KERNELS_DIR = Path(__file__).resolve().parent
BUILD_DIR = KERNELS_DIR.parents[2] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
NAMES = ("alpha_combine", "disagreement", "flash_attention", "ssm_scan")

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("repro_torch kernels: nvcc not found (looked on PATH "
                       "and in $CUDA_HOME/bin); the CUDA toolkit is needed "
                       "to build the kernels")


def _source(name: str) -> Path:
    return KERNELS_DIR / name / "csrc" / f"{name}.cu"


def _target(name: str) -> Path:
    digest = hashlib.sha256(_source(name).read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names: Sequence[str] = NAMES) -> Dict[str, str]:
    """Compile every stale library, one ``nvcc`` per source, all started
    together.  Returns each kernel's ptxas report ("" when cached)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = _target(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(_source(name))],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp, out)
    reports = {name: "" for name in names}
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        reports[name] = log
        if proc.returncode != 0:
            failed.append(f"{name} (nvcc exit {proc.returncode}):\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("repro_torch kernel build failed: "
                           + "\n".join(failed))
    return reports


def load(name: str) -> ctypes.CDLL:
    """The kernel's library, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = _loaded[name] = ctypes.CDLL(str(_target(name)))
    return lib


@functools.lru_cache(maxsize=None)
def entry(name: str, symbol: str, argtypes: Tuple[type, ...]):
    """The C entry point ``symbol`` of kernel ``name``, typed once (ctypes
    would otherwise pass each pointer as a 32-bit int); it returns a
    ``cudaError_t``."""
    fn = getattr(load(name), symbol)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


def check(name: str, err: int) -> None:
    """Raise on a nonzero ``cudaError_t`` returned by a C entry point
    (a launch the GPU refused never runs, and no later synchronize
    reports it)."""
    if err != 0:
        fn = getattr(load(name), f"{name}_error_string")
        fn.restype = ctypes.c_char_p
        fn.argtypes = [ctypes.c_int]
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err} "
                           f"({fn(err).decode()})")


def refuse_grad(name: str, plain: str,
                *tensors: Optional[torch.Tensor]) -> None:
    """Raise ``RuntimeError`` when grad mode is on and a floating-point
    input requires grad: the kernel's output would carry no ``grad_fn``
    and a backward pass would silently miss its inputs.  The caller
    should compute ``plain`` (the differentiable plain version) instead;
    nothing here reroutes to it."""
    if not torch.is_grad_enabled():
        return
    for t in tensors:
        if t is not None and t.is_floating_point() and t.requires_grad:
            raise RuntimeError(
                f"{name}: an input requires grad, and the CUDA kernel has "
                f"no backward pass; call {plain} (differentiable), or run "
                f"under torch.no_grad()")
