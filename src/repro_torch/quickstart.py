"""Quickstart: ST-LF end to end on a small synthetic federated network,
on the port (the twin of ``examples/quickstart.py``).

    PYTHONPATH=src python -m repro_torch.quickstart [--device cpu]

Builds a 6-device network over two visually distinct digit domains, runs
the full ST-LF pipeline (local training -> Algorithm 1 divergence
estimation -> optimization (P) -> source->target model transfer) and
prints the resulting source/target split, link weights, target accuracy
and communication energy, next to the FedAvg baseline.  Runs on the GPU
unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.data import build_network
from repro_torch.fl import (evaluate_assignment, pairwise_disagreement,
                            prepare_round, run_stlf)
from repro_torch.fl import baselines as bl

N_DEVICES = 6


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; no silent CPU run)")
    args = ap.parse_args(argv)

    devices = build_network("M//MM", num_devices=N_DEVICES,
                            samples_per_device=120, seed=0,
                            label_subset=[0, 1, 2, 3])
    print(f"devices: {[d.n_labeled for d in devices]} labeled samples each")

    state = prepare_round(devices, 0, train_iters=150, div_tau=2,
                          div_T=15, device=args.device)
    print("empirical errors:", np.round(state.eps_hat, 2))
    print("divergence matrix (Algorithm 1):")
    print(np.round(state.div_hat, 2))
    print("hypothesis disagreement, eq. (4), on the union of all data:")
    print(np.round(pairwise_disagreement(state.params,
                                         state.clients).cpu().numpy(), 2))

    stlf = run_stlf(state, max_outer=6, inner_steps=800)
    print("\nST-LF:")
    print("  psi (0=source, 1=target):", stlf.psi.astype(int))
    print("  alpha (link weights):")
    print(np.round(stlf.alpha, 2))
    print(f"  target accuracy: {stlf.target_acc:.3f}")
    print(f"  energy: {stlf.energy:.4f} (x{stlf.transmissions} "
          f"transmissions)")

    fedavg = evaluate_assignment(state, "FedAvg", stlf.psi,
                                 bl.fedavg_alpha(stlf.psi, state.clients))
    print(f"\nFedAvg baseline: accuracy {fedavg.target_acc:.3f}, "
          f"energy {fedavg.energy:.4f}")


if __name__ == "__main__":
    main()
