"""The paper's client model (Sec. V): a 2-layer CNN (10 and 20 maps)
followed by two fully-connected layers, as a functional forward over a
parameter dict.  The same architecture with a 2-dim output head is the
Algorithm-1 domain classifier.

Public layouts are the JAX package's: inputs NHWC, conv weights HWIO,
fc weights (in, out).  Inside, activations run NCHW and conv weights
OIHW, and the conv stack is flattened in (h, w, c) order into ``fc1``'s
320 rows, exactly as ``repro.fl.cnn`` reshapes its NHWC activations.

Every function also takes a *stacked* parameter dict (leading model axis
M) with inputs (M, B, H, W, C): the M models run as one grouped
convolution (``groups=M``) and batched matrix products — the batch
dimension written out where the JAX package vmaps.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.nn.param import ParamSpec, materialize

FC_HIDDEN = 128

Params = Dict[str, torch.Tensor]


def cnn_specs(num_classes: int = 10, in_ch: int = 3) -> Dict[str, ParamSpec]:
    # 28 -> conv5 -> 24 -> pool2 -> 12 -> conv5 -> 8 -> pool2 -> 4
    flat = 20 * 4 * 4
    return {
        "conv1": ParamSpec((5, 5, in_ch, 10), (None, None, None, None)),
        "b1": ParamSpec((10,), (None,), init="zeros"),
        "conv2": ParamSpec((5, 5, 10, 20), (None, None, None, None)),
        "b2": ParamSpec((20,), (None,), init="zeros"),
        "fc1": ParamSpec((flat, FC_HIDDEN), (None, None)),
        "fcb1": ParamSpec((FC_HIDDEN,), (None,), init="zeros"),
        "fc2": ParamSpec((FC_HIDDEN, num_classes), (None, None)),
        "fcb2": ParamSpec((num_classes,), (None,), init="zeros"),
    }


def cnn_init(gen: torch.Generator, num_classes: int = 10, in_ch: int = 3, *,
             device: torch.device) -> Params:
    return materialize(cnn_specs(num_classes, in_ch), gen, device=device)


def _conv_relu_pool(h, w, b):
    """h: (B, M*Cin, H, W); w: (M, kh, kw, Cin, Cout) HWIO; b: (M, Cout).
    One grouped VALID conv, bias, relu, 2x2/2 VALID max-pool."""
    m, kh, kw, cin, cout = w.shape
    w = w.permute(0, 4, 3, 1, 2).reshape(m * cout, cin, kh, kw)
    h = F.conv2d(h, w, groups=m) + b.reshape(1, m * cout, 1, 1)
    return F.max_pool2d(F.relu(h), 2, 2)


def _features_stacked(params: Params, x: torch.Tensor) -> torch.Tensor:
    """params stacked over M models, x: (M, B, H, W, C) -> (M, B, 128)."""
    m, b = x.shape[:2]
    h = x.permute(1, 0, 4, 2, 3).reshape(b, m * x.shape[4], *x.shape[2:4])
    h = _conv_relu_pool(h, params["conv1"], params["b1"])
    h = _conv_relu_pool(h, params["conv2"], params["b2"])
    # (B, M*20, 4, 4) -> per model (h, w, c) order, as JAX flattens NHWC
    c = params["conv2"].shape[-1]
    h = h.reshape(b, m, c, *h.shape[2:]).permute(1, 0, 3, 4, 2) \
        .reshape(m, b, -1)
    return F.relu(torch.bmm(h, params["fc1"]) + params["fcb1"][:, None, :])


def forward_stacked(params: Params, x: torch.Tensor) -> torch.Tensor:
    """Stacked logits: (M, B, H, W, C) -> (M, B, num_classes)."""
    h = _features_stacked(params, x)
    return torch.bmm(h, params["fc2"]) + params["fcb2"][:, None, :]


def _one(params: Params) -> Params:
    return {k: v[None] for k, v in params.items()}


def cnn_forward(params: Params, x: torch.Tensor) -> torch.Tensor:
    """x: (B, 28, 28, C) float32 -> logits (B, num_classes)."""
    return forward_stacked(_one(params), x[None])[0]


def cnn_features(params: Params, x: torch.Tensor) -> torch.Tensor:
    """Penultimate features (B, FC_HIDDEN)."""
    return _features_stacked(_one(params), x[None])[0]


def xent_stacked(params: Params, x: torch.Tensor,
                 y: torch.Tensor) -> torch.Tensor:
    """Per-model mean cross-entropy, (M,): x (M, B, ...), y (M, B)."""
    logits = forward_stacked(params, x)
    logz = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, y[..., None])[..., 0]
    return (logz - ll).mean(dim=-1)


def xent_loss(params: Params, x: torch.Tensor,
              y: torch.Tensor) -> torch.Tensor:
    return xent_stacked(_one(params), x[None], y[None])[0]


def accuracy(params: Params, x: torch.Tensor, y: torch.Tensor,
             mask=None) -> torch.Tensor:
    pred = torch.argmax(cnn_forward(params, x), dim=-1)
    hit = (pred == y).float()
    if mask is not None:
        m = mask.float()
        return torch.sum(hit * m) / torch.clamp(torch.sum(m), min=1.0)
    return hit.mean()
