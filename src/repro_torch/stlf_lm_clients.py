"""ST-LF over TRANSFORMER language-model clients (the twin of
``examples/stlf_lm_clients.py``): the paper's bounds -> divergence ->
(P) -> alpha-transfer pipeline orchestrating decoder LMs of the model zoo
in place of its CNNs.

    PYTHONPATH=src python -m repro_torch.stlf_lm_clients [--device D]

Setup: 6 devices hold token streams from two topic domains.  Devices 0-1
(domain A) and 2-3 (domain B) have enough data to train; devices 4 (A)
and 5 (B) are data-poor.  Algorithm 1 runs with a tiny transformer
domain classifier (the LM's last-token logits as features + a 2-way
head).  Runs on the GPU unless ``--device cpu`` is given; there the
transfer mixes the six clients' ~0.59 M parameters through the
``alpha_combine`` kernel.

Randomness: JAX draws the clients' initial weights from ``PRNGKey(0)``
and each Algorithm-1 pair's from ``fold_in(PRNGKey(1), i * N_DEV + j)``.
``main`` and ``algorithm1_lm`` take those trees as arguments (tests pass
in JAX's, carried across by ``convert.lm_params_from_jax``); without
them the port draws its own, from seed 0 and seed ``1000 + i * N_DEV +
j`` on a generator on the run's device.  The token batches are the
numpy ``LMStream``'s, the same in both packages.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core import BoundTerms, EnergyModel, STLFProblem, solve_stlf
from repro_torch.data import LMStream, LMStreamConfig
from repro_torch.device import resolve_device
from repro_torch.fl.transfer import apply_transfer
from repro_torch.launch.steps import value_and_grad
from repro_torch.models.api import build_model
from repro_torch.nn.param import tree_leaves, tree_map
from repro_torch.optim import adamw, apply_updates

N_DEV = 6
DOMAIN = [0, 0, 1, 1, 0, 1]          # topic domain per device
RICH = [True, True, True, True, False, False]
SEQ, BATCH = 64, 4
TRAIN_ITERS = 40
HEAD_FEATS = 64                      # logits taken as the head's features
PAIR_STEPS = 15

cfg = get_config("repro-100m").reduced(num_layers=2, d_model=128)
cfg = dataclasses.replace(cfg, vocab_size=512)
model = build_model(cfg)

streams = [LMStream(LMStreamConfig(vocab_size=512, num_topics=16,
                                   topic_vocab=96, seed=dom))
           for dom in DOMAIN]


def _device(params) -> torch.device:
    return tree_leaves(params)[0].device


def batches(dev, seed, device="cpu") -> Tuple[torch.Tensor, torch.Tensor]:
    """Device ``dev``'s (tokens, labels) (BATCH, SEQ) batch ``seed`` on
    ``device``: domain A devices draw topics 0-7, domain B topics 8-15,
    emulated by distinct stream seeds."""
    t, l = streams[dev].sample(BATCH, SEQ, seed=seed * 97 + dev % 2)
    return (torch.as_tensor(t, device=device),
            torch.as_tensor(l, device=device))


def local_train(params, dev, iters):
    """``iters`` steps of ``adamw(3e-3)`` on device ``dev``'s stream from
    ``params``.  Returns (params, the last step's loss)."""
    opt = adamw(3e-3)
    state = opt.init(params)
    loss = None
    for it in range(iters):
        t, l = batches(dev, it + 1, _device(params))
        (loss, _), g = value_and_grad(
            lambda pp: model.loss(pp, {"tokens": t, "labels": l}), params)
        with torch.no_grad():
            u, state = opt.update(g, state, params)
            params = apply_updates(params, u)
    return params, float(loss)


@torch.no_grad()
def eval_error(params, dev):
    """1 - next-token top-1 accuracy proxy on held-out stream data: the
    teacher-forced loss squashed to [0, 1).  (JAX's also runs a prefill
    whose result it drops.)"""
    t, l = batches(dev, 777, _device(params))
    loss, _ = model.loss(params, {"tokens": t, "labels": l})
    return float(1.0 - np.exp(-float(loss) / 4.0))


def _features(params, toks):
    """The head's features: tanh of the LM's first HEAD_FEATS last-token
    logits (fixed weights: no gradient reaches the backbone)."""
    h = model.prefill(params, {"tokens": toks})          # (B, 1, V) fp32
    return torch.tanh(h[:, 0, :HEAD_FEATS])


def classifier_pair(params, i, j):
    """Algorithm 1 for one pair: train a 2-way head on the backbone
    ``params`` to tell device i's stream from device j's (PAIR_STEPS
    gradient steps of 0.5), then d = 2(1 - 2 eps) on held-out batches.
    Returns (head {"w" (64, 2), "b" (2,)}, d)."""
    dev = _device(params)
    head = {"w": torch.zeros(HEAD_FEATS, 2, device=dev),
            "b": torch.zeros(2, device=dev)}
    y = torch.cat([torch.zeros(BATCH, dtype=torch.long, device=dev),
                   torch.ones(BATCH, dtype=torch.long, device=dev)])

    def loss_fn(hd, fi, fj):
        lg = torch.cat([fi @ hd["w"] + hd["b"], fj @ hd["w"] + hd["b"]])
        logz = torch.logsumexp(lg, dim=-1)
        ll = torch.gather(lg, -1, y[:, None])[:, 0]
        return torch.mean(logz - ll), {}

    for it in range(PAIR_STEPS):
        fi = _features(params, batches(i, 1000 + it, dev)[0])
        fj = _features(params, batches(j, 2000 + it, dev)[0])
        _, g = value_and_grad(lambda hd: loss_fn(hd, fi, fj), head)
        head = {"w": head["w"] - 0.5 * g["w"], "b": head["b"] - 0.5 * g["b"]}
    with torch.no_grad():
        pi = torch.argmax(_features(params, batches(i, 9001, dev)[0])
                          @ head["w"] + head["b"], -1).cpu().numpy()
        pj = torch.argmax(_features(params, batches(j, 9002, dev)[0])
                          @ head["w"] + head["b"], -1).cpu().numpy()
    eps = ((pi != 0).sum() + (pj != 1).sum()) / (2 * BATCH)
    return head, float(np.clip(2 * (1 - 2 * eps), 0, 2))


def algorithm1_lm(device="cpu", inits: Optional[Dict] = None):
    """Pairwise divergence with a transformer domain classifier, one
    fresh backbone a pair: ``inits[(i, j)]`` where given, else drawn
    from seed ``1000 + i * N_DEV + j`` on ``device``."""
    div = np.zeros((N_DEV, N_DEV))
    for i in range(N_DEV):
        for j in range(i + 1, N_DEV):
            if inits is not None:
                params = inits[(i, j)]
            else:
                params = model.init(torch.Generator(device=device)
                                    .manual_seed(1000 + i * N_DEV + j),
                                    device=device)
            _, div[i, j] = classifier_pair(params, i, j)
            div[j, i] = div[i, j]
    return div


def _clock(device: torch.device) -> float:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


def main(argv=None, *, init=None, pair_inits=None):
    """Run the pipeline and print JAX's lines.  ``init``: the clients'
    common initial parameters; ``pair_inits``: Algorithm 1's per-pair
    backbones ({(i, j): tree}).  Returns the decisions and the wall
    time of each phase (host clock, a synchronize at each end)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; no silent CPU run)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    walls = {}
    if init is None:
        init = model.init(torch.Generator(device=dev).manual_seed(0),
                          device=dev)

    print("local training (sources candidates)...")
    t0 = _clock(dev)
    eps_hat = np.ones(N_DEV)
    trained = []
    for d in range(N_DEV):
        iters = TRAIN_ITERS if RICH[d] else 2     # data-poor: barely trains
        p, _ = local_train(init, d, iters)
        trained.append(p)
        eps_hat[d] = eval_error(p, d)
        print(f"  device {d} (domain {'AB'[DOMAIN[d]]}, "
              f"{'rich' if RICH[d] else 'poor'}): eps_hat={eps_hat[d]:.3f}")
    stacked = tree_map(lambda *xs: torch.stack(xs), trained[0], *trained[1:])
    t1 = _clock(dev)
    walls["local_train_s"] = t1 - t0

    print("Algorithm 1 (transformer domain classifier)...")
    div = algorithm1_lm(dev, pair_inits)
    print(np.round(div, 2))
    t2 = _clock(dev)
    walls["algorithm1_s"] = t2 - t1

    n_data = np.where(RICH, 4000, 100)
    bounds = BoundTerms(eps_hat, n_data, div)
    energy = EnergyModel.for_tpu_links(
        N_DEV, model_bytes=4e6, link_bw=50e9)   # ~1M-param reduced model
    prob = STLFProblem(bounds, energy)
    res = solve_stlf(prob, max_outer=5, inner_steps=500, device=dev)
    print("psi:", res.psi.astype(int), " (0=source, 1=target)")
    print("alpha:")
    print(np.round(res.alpha, 2))
    t3 = _clock(dev)
    walls["solve_s"] = t3 - t2

    with torch.no_grad():
        mixed = apply_transfer(stacked, res.alpha, res.psi)
    t4 = _clock(dev)
    walls["transfer_s"] = t4 - t3
    targets = {}
    for d in np.flatnonzero(res.psi == 1.0):
        p_d = tree_map(lambda a: a[d], mixed)
        before = eval_error(trained[d], d)
        after = eval_error(p_d, d)
        srcs = np.flatnonzero(res.alpha[:, d] > 0)
        same = all(DOMAIN[s] == DOMAIN[d] for s in srcs)
        targets[int(d)] = dict(before=before, after=after,
                               sources=srcs.tolist(), same_domain=same)
        print(f"target device {d}: eps {before:.3f} -> {after:.3f} "
              f"(received from {srcs.tolist()}, same-domain={same})")
    print("[stlf-lm] walls (s): " + ", ".join(
        f"{k[:-2]} {v:.3f}" for k, v in walls.items()))
    return dict(eps_hat=eps_hat, div=div, psi=res.psi, alpha=res.alpha,
                targets=targets, walls=walls, stacked=stacked, mixed=mixed)


if __name__ == "__main__":
    main()
