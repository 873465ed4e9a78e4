"""Checkpoints of nested dicts of arrays on .npz (the port of
``repro.checkpoint.store``).

A tree is a nested dict (or list / tuple) whose leaves are numpy arrays,
tensors or scalars.  Each leaf is stored under its path's name,
``"['params']['conv1']"`` or ``"['list'][1]"``: the names
``jax.tree_util.keystr`` gives the same paths, so an archive written here
and one written by the JAX package for the same tree hold the same
member names.  Restores are structure-checked against a target tree
(names, shapes, dtypes).

Crash consistency: a checkpoint is the pair ``step_<k>.npz`` (arrays) +
``step_<k>.json`` (metadata).  The metadata is written atomically FIRST,
the npz atomically (tmp + fsync + rename) LAST, so a ``step_<k>.npz``
that exists implies its metadata does too — a crash mid-save leaves at
worst an orphan ``.json``/``.tmp`` that ``latest_step`` never sees.  A
corrupt or partial archive (e.g. a crash racing the rename on a
non-atomic filesystem) surfaces as ``CheckpointCorruptError``; restores
that asked for "the latest" fall back to the previous step with a
warning instead of dying on a raw zipfile exception.
"""
from __future__ import annotations

import json
import os
import re
import tempfile
import warnings
import zipfile
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch


class CheckpointCorruptError(RuntimeError):
    """A checkpoint archive exists but cannot be read back (truncated
    write, bad zip member, missing metadata, ...)."""


def leaf_name(*path) -> str:
    """The archive name of a leaf's path: ``[{k!r}]`` per dict key,
    ``[i]`` per sequence index (``leaf_name('pool', '00003', 'images')``
    -> ``"['pool']['00003']['images']"``)."""
    return "".join(f"[{p}]" if isinstance(p, int) else f"[{p!r}]"
                   for p in path)


def _as_numpy(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def flatten_tree(tree: Any, prefix: Tuple = ()) -> Dict[str, Any]:
    """{archive name: leaf} of a nested dict / list / tuple."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(flatten_tree(tree[k], prefix + (k,)))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(flatten_tree(v, prefix + (i,)))
        return out
    return {leaf_name(*prefix): tree}


def _atomic_write(path: str, data: bytes):
    """tmp + fsync + rename in ``path``'s directory."""
    d = os.path.dirname(path) or "."
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def save_checkpoint(ckpt_dir: str, step: int, tree: Any,
                    metadata: Optional[dict] = None) -> str:
    """Write ``<ckpt_dir>/step_<step>.npz`` atomically; returns the path.

    ``metadata`` (JSON-serializable) lands in ``step_<step>.json`` and is
    committed BEFORE the arrays so the npz's existence implies complete
    metadata (see module docstring)."""
    os.makedirs(ckpt_dir, exist_ok=True)
    arrays = {k: _as_numpy(v) for k, v in flatten_tree(tree).items()}
    path = os.path.join(ckpt_dir, f"step_{step:08d}.npz")
    if metadata is not None:
        _atomic_write(os.path.join(ckpt_dir, f"step_{step:08d}.json"),
                      json.dumps(metadata, indent=2).encode())
    fd, tmp = tempfile.mkstemp(dir=ckpt_dir, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **arrays)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return path


def available_steps(ckpt_dir: str) -> List[int]:
    """Sorted step numbers with an archive present (may include corrupt
    ones — readability is only known at load time)."""
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(int(m.group(1)) for fn in os.listdir(ckpt_dir)
                  if (m := re.fullmatch(r"step_(\d+)\.npz", fn)))


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = available_steps(ckpt_dir)
    return steps[-1] if steps else None


def load_metadata(ckpt_dir: str, step: int) -> Optional[dict]:
    """The ``step_<step>.json`` sidecar, or None if it was never written."""
    path = os.path.join(ckpt_dir, f"step_{step:08d}.json")
    if not os.path.exists(path):
        return None
    try:
        with open(path) as f:
            return json.load(f)
    except (json.JSONDecodeError, OSError) as e:
        raise CheckpointCorruptError(
            f"checkpoint metadata {path} is unreadable: {e}") from e


def _read_arrays(ckpt_dir: str, step: int) -> Dict[str, np.ndarray]:
    path = os.path.join(ckpt_dir, f"step_{step:08d}.npz")
    try:
        with np.load(path) as data:
            # materialize every member NOW: npz reads lazily, so a
            # truncated member would otherwise only explode later,
            # far from this try/except
            return {k: np.array(data[k]) for k in data.files}
    except (zipfile.BadZipFile, ValueError, EOFError, KeyError,
            OSError) as e:
        raise CheckpointCorruptError(
            f"checkpoint {path} is corrupt or partial "
            f"({type(e).__name__}: {e}); delete it or restore an "
            f"earlier step") from e


def load_arrays(ckpt_dir: str, step: Optional[int] = None,
                fallback: bool = True) -> Tuple[int, Dict[str, np.ndarray]]:
    """Read one checkpoint's raw arrays, keyed by their archive names.
    ``step=None`` loads the latest readable step: a corrupt latest is
    skipped with a warning and the previous step is tried
    (``fallback=False`` disables that).  An explicitly requested step
    never falls back.  Returns ``(step, arrays)``."""
    if step is not None:
        return step, _read_arrays(ckpt_dir, step)
    steps = available_steps(ckpt_dir)
    if not steps:
        raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    last_err: Optional[CheckpointCorruptError] = None
    for s in reversed(steps):
        try:
            return s, _read_arrays(ckpt_dir, s)
        except CheckpointCorruptError as e:
            last_err = e
            if not fallback:
                raise
            warnings.warn(f"{e}; falling back to the previous checkpoint")
    raise CheckpointCorruptError(
        f"every checkpoint in {ckpt_dir} is corrupt "
        f"(steps {steps}); last error: {last_err}")


def gc_checkpoints(ckpt_dir: str, keep: int = 3) -> List[int]:
    """Retention: delete all but the newest ``keep`` checkpoints
    (archive + metadata sidecar).  Returns the deleted steps."""
    if keep < 1:
        raise ValueError(f"gc_checkpoints keep must be >= 1, got {keep}")
    doomed = available_steps(ckpt_dir)[:-keep]
    for s in doomed:
        for ext in ("npz", "json"):
            path = os.path.join(ckpt_dir, f"step_{s:08d}.{ext}")
            if os.path.exists(path):
                os.unlink(path)
    return doomed


def restore_checkpoint(ckpt_dir: str, target: Any,
                       step: Optional[int] = None) -> Any:
    """Restore into the structure of ``target``: every leaf comes back as
    a numpy array of the target leaf's shape and dtype (a tensor leaf
    comes back as a tensor on its device).

    A corrupt/partial archive raises ``CheckpointCorruptError`` instead
    of a raw zipfile exception; when ``step`` is None (restore latest)
    the previous step is tried first, with a warning (see
    ``load_arrays``)."""
    step, data = load_arrays(ckpt_dir, step)

    def rebuild(t, prefix):
        if isinstance(t, dict):
            return {k: rebuild(v, prefix + (k,)) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(rebuild(v, prefix + (i,))
                           for i, v in enumerate(t))
        key = leaf_name(*prefix)
        if key not in data:
            raise KeyError(f"checkpoint step {step} in {ckpt_dir} "
                           f"missing leaf {key}")
        arr = data[key]
        want = tuple(t.shape) if hasattr(t, "shape") else arr.shape
        if tuple(arr.shape) != want:
            raise ValueError(
                f"{key}: checkpoint shape {arr.shape} != target {want}")
        if isinstance(t, torch.Tensor):
            return torch.as_tensor(arr).to(dtype=t.dtype, device=t.device)
        return arr.astype(getattr(t, "dtype", arr.dtype))

    return rebuild(target, ())
