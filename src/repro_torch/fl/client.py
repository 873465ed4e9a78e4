"""Client-local training, batched across devices.

Every device's (padded) dataset is stacked into one tensor, and local
training for all devices is one Python loop over SGD steps in which the
N device models run as one stacked forward and backward pass (the
batch dimension written out where ``repro.fl.client`` vmaps and scans).

Paper protocol (Sec. V): SGD, 100 iterations, mini-batch 10, lr 0.01.

Minibatch draws: the JAX package samples each step's rows with
``jax.random.categorical`` over a 0/-1e30 mask, i.e. uniformly with
replacement over a device's labeled rows (over its valid rows when it
has no labels).  Here all draws are made up front as one (N, iters,
batch) index tensor from an explicit generator, and ``train_sources``
takes such a tensor instead, so tests can pass in the reference's draws.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.data.partition import DeviceData
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.fl import cnn
from repro_torch.kernels.disagreement.ops import disagreement
from repro_torch.nn.param import materialize

Params = Dict[str, torch.Tensor]


@dataclasses.dataclass
class StackedClients:
    """Device-major stacked data.  x: (N, n_max, 28, 28, 3); counts: (N,)."""
    x: torch.Tensor             # float32
    y: torch.Tensor             # int64 shown labels; -1 where unlabeled
    labeled: torch.Tensor       # (N, n_max) bool
    valid: torch.Tensor         # (N, n_max) bool (False = padding)
    true_y: torch.Tensor        # int64 ground truth (eval only)
    counts: torch.Tensor        # (N,) int64

    @property
    def n_devices(self) -> int:
        return self.x.shape[0]

    @property
    def device(self) -> torch.device:
        return self.x.device


def stack_clients(devices: List[DeviceData], *,
                  device: DeviceLike = None) -> StackedClients:
    dev = resolve_device(device)
    n_max = max(d.n for d in devices)

    def pad(a, fill, dtype):
        out = np.full((len(devices), n_max) + a[0].shape[1:], fill,
                      dtype=a[0].dtype)
        for i, arr in enumerate(a):
            out[i, :len(arr)] = arr
        return torch.as_tensor(out, dtype=dtype, device=dev)

    return StackedClients(
        x=pad([d.images for d in devices], 0.0, torch.float32),
        y=pad([d.labels for d in devices], -1, torch.int64),
        labeled=pad([d.labeled_mask for d in devices], False, torch.bool),
        valid=pad([np.ones(d.n, bool) for d in devices], False, torch.bool),
        true_y=pad([d.true_labels for d in devices], -1, torch.int64),
        counts=torch.as_tensor([d.n for d in devices], dtype=torch.int64,
                               device=dev),
    )


# ------------------------------------------------------------- local SGD
def sample_train_indices(clients: StackedClients, gen: torch.Generator, *,
                         iters: int, batch: int) -> torch.Tensor:
    """(N, iters, batch) row indices: uniform with replacement over each
    device's labeled rows, or its valid rows when it has none."""
    labeled = clients.labeled.cpu()
    valid = clients.valid.cpu()
    rows = []
    for i in range(clients.n_devices):
        sel = labeled[i] if bool(labeled[i].any()) else valid[i]
        rows.append(torch.multinomial(sel.double(), iters * batch,
                                      replacement=True, generator=gen))
    return torch.stack(rows).view(-1, iters, batch).to(clients.device)


def sgd_steps(params: Params, batches, lr: float) -> Params:
    """Plain SGD on stacked models: ``batches`` yields (x (M, B, ...),
    y (M, B)); every model steps on the gradient of its own mean loss."""
    p = {k: v.detach() for k, v in params.items()}
    for x, y in batches:
        leaves = {k: v.requires_grad_() for k, v in p.items()}
        loss = cnn.xent_stacked(leaves, x, y).sum()
        grads = torch.autograd.grad(loss, list(leaves.values()))
        with torch.no_grad():
            p = {k: v - lr * g for (k, v), g in zip(leaves.items(), grads)}
    return p


def train_sources(params_stack: Params, clients: StackedClients,
                  gen: Optional[torch.Generator] = None, *,
                  iters: int = 100, batch: int = 10, lr: float = 0.01,
                  draws: Optional[torch.Tensor] = None) -> Params:
    """Local supervised training on each device's LABELED data.

    Devices with no labeled data train on uniform draws over valid rows
    with y clamped to 0 — their output is discarded by the caller (they
    will be targets).  ``draws``: optional (N, iters, batch) row indices
    used instead of drawing from ``gen``."""
    if draws is None:
        draws = sample_train_indices(clients, gen, iters=iters, batch=batch)
    n = clients.n_devices
    if tuple(draws.shape) != (n, iters, batch):
        raise ValueError(f"draws {tuple(draws.shape)} != {(n, iters, batch)}")
    draws = draws.to(device=clients.device, dtype=torch.int64)
    y_safe = torch.clamp(clients.y, min=0)
    dev_ax = torch.arange(n, device=clients.device)[:, None]
    batches = ((clients.x[dev_ax, draws[:, t]], y_safe[dev_ax, draws[:, t]])
               for t in range(iters))
    return sgd_steps(params_stack, batches, lr)


@torch.no_grad()
def _predictions(params_stack: Params, clients: StackedClients
                 ) -> torch.Tensor:
    """(N, n_max) argmax predictions of each device's model on its rows."""
    return torch.argmax(cnn.forward_stacked(params_stack, clients.x), dim=-1)


def empirical_errors(params_stack: Params,
                     clients: StackedClients) -> torch.Tensor:
    """eq (3) per device: unlabeled data counted as error 1.  (N,) f32."""
    pred = _predictions(params_stack, clients)
    wrong_lab = clients.labeled & (pred != clients.y)
    err = wrong_lab | (clients.valid & ~clients.labeled)
    return err.float().sum(1) / torch.clamp(clients.valid.float().sum(1),
                                            min=1.0)


def true_accuracies(params_stack: Params,
                    clients: StackedClients) -> torch.Tensor:
    """Ground-truth accuracy of each device's model on its own data."""
    hit = (_predictions(params_stack, clients) == clients.true_y).float()
    m = clients.valid.float()
    return (hit * m).sum(1) / torch.clamp(m.sum(1), min=1.0)


@torch.no_grad()
def pairwise_disagreement(params_stack: Params,
                          clients: StackedClients) -> torch.Tensor:
    """eq (4) for every pair of device models: the (N, N) share of the
    union of all devices' valid rows on which models i and j predict
    different labels (``core.bounds.hypothesis_disagreement`` for all
    pairs at once, through the ``disagreement`` kernel)."""
    x = clients.x[clients.valid]                          # (M, 28, 28, 3)
    n = clients.n_devices
    logits = cnn.forward_stacked(params_stack,
                                 x[None].expand(n, *x.shape))
    preds = torch.argmax(logits, dim=-1).to(torch.int32)  # (N, M)
    return disagreement(preds)


def init_client_params(n_devices: int, gen: torch.Generator,
                       num_classes: int = 10, shared_init: bool = True, *,
                       device: DeviceLike = None) -> Params:
    """Stacked per-device parameters.  ``shared_init=True`` (the FL norm,
    and a precondition for meaningful parameter averaging at targets)
    repeats ONE initialization for every device."""
    dev = resolve_device(device)
    specs = cnn.cnn_specs(num_classes)
    if shared_init:
        p = materialize(specs, gen, device=dev)
        return {k: v[None].repeat(n_devices, *([1] * v.dim()))
                for k, v in p.items()}
    ps = [materialize(specs, gen, device=dev) for _ in range(n_devices)]
    return {k: torch.stack([p[k] for p in ps]) for k in ps[0]}
