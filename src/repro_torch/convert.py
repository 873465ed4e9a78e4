"""Weights and data carried across from the JAX package, as numpy.

The port keeps the JAX package's parameter shapes (HWIO conv kernels,
(in, out) fc matrices, layer-stacked LM leaves such as ``layers/attn/wq``
(L, D, H, hd)) and dict keys, so converting is a dtype and device move:
stacked trees (leading device axis) and single trees alike.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.fl.client import StackedClients


def params_from_jax(tree: Mapping[str, np.ndarray],
                    device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """A dict of numpy arrays (``repro.fl.cnn`` parameters, stacked or
    single) -> the port's float32 tensors on ``device``."""
    dev = resolve_device(device)
    return {k: torch.tensor(np.asarray(v), dtype=torch.float32, device=dev)
            for k, v in tree.items()}


def params_to_numpy(params: Mapping[str, torch.Tensor]
                    ) -> Dict[str, np.ndarray]:
    return {k: v.detach().cpu().numpy() for k, v in params.items()}


def params_max_abs_diff(params: Mapping[str, torch.Tensor],
                        tree: Mapping[str, np.ndarray]) -> Dict[str, float]:
    """Per leaf, the largest absolute difference between the port's
    (stacked) parameters and a dict of numpy arrays in JAX's layout, e.g.
    the reference simulator's ``state.params`` after its last round."""
    return {k: float(np.max(np.abs(
        v.detach().cpu().double().numpy() - np.asarray(tree[k], float))))
        for k, v in params.items()}


def clients_from_numpy(clients, device: DeviceLike = None) -> StackedClients:
    """Any object with the fields of ``repro.fl.client.StackedClients``
    (arrays convertible by ``np.asarray``) -> the port's StackedClients."""
    dev = resolve_device(device)

    def t(name, dtype):
        return torch.tensor(np.asarray(getattr(clients, name)),
                            dtype=dtype, device=dev)

    return StackedClients(
        x=t("x", torch.float32), y=t("y", torch.int64),
        labeled=t("labeled", torch.bool), valid=t("valid", torch.bool),
        true_y=t("true_y", torch.int64), counts=t("counts", torch.int64))


# ``ModelConfig.attention_impl``: the JAX package's names -> the port's
ATTENTION_IMPL_FROM_JAX = {"xla": "dot", "chunked": "chunked",
                           "pallas": "kernel"}


def lm_params_from_jax(tree: Any, device: DeviceLike = None) -> Any:
    """A nested dict (or tuple, or list) of numpy arrays in JAX's layout
    (``jax.tree_util.tree_map(np.asarray, model.init(key))``, or a
    model's cache such as RWKV's state tuple) -> the same tree of tensors
    on ``device``, each in its own dtype (bfloat16 arrays included)."""
    dev = resolve_device(device)

    def leaf(a):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":          # ml_dtypes: no torch view
            return torch.tensor(a.astype(np.float32),
                                device=dev).to(torch.bfloat16)
        return torch.tensor(a, device=dev)

    def conv(t):
        if isinstance(t, Mapping):
            return {k: conv(v) for k, v in t.items()}
        if isinstance(t, (tuple, list)):
            return type(t)(conv(v) for v in t)
        return leaf(t)

    return conv(tree)


def lm_params_to_numpy(params: Any) -> Any:
    """Inverse of ``lm_params_from_jax`` (bfloat16 leaves come back as
    float32 arrays, which hold them exactly)."""
    if isinstance(params, Mapping):
        return {k: lm_params_to_numpy(v) for k, v in params.items()}
    if isinstance(params, (tuple, list)):
        return type(params)(lm_params_to_numpy(v) for v in params)
    v = params.detach()
    return (v.float() if v.dtype == torch.bfloat16 else v).cpu().numpy()
