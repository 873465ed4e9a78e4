"""Full federated-domain-adaptation comparison (the paper's Fig. 8/9 +
Table I protocol) on the port: ST-LF vs all eight baselines on a
split-dataset network (the twin of ``examples/stlf_federated.py``).

    PYTHONPATH=src python -m repro_torch.stlf_federated [setting] [--device D]

``setting`` is any of the paper's dataset manipulations: M, U, MM (single),
M+U, M+MM, MM+U (mixed), M//U, M//MM, MM//U (split).  Default M//MM.
Runs on the GPU unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.data import build_network
from repro_torch.fl import prepare_round, run_all_baselines, run_stlf


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("setting", nargs="?", default="M//MM")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; no silent CPU run)")
    args = ap.parse_args(argv)
    print(f"=== ST-LF vs baselines on {args.setting} ===")

    devices = build_network(args.setting, num_devices=10,
                            samples_per_device=150, seed=0)
    state = prepare_round(devices, 0, train_iters=200, div_tau=3, div_T=20,
                          device=args.device)
    stlf = run_stlf(state, max_outer=6, inner_steps=800)
    results = {"ST-LF": stlf}
    results.update(run_all_baselines(state, stlf, 1))

    print(f"\n{'method':<12} {'tgt acc':>8} {'energy':>9} {'tx':>4}")
    emax = max(r.energy for r in results.values()) or 1.0
    for name, r in results.items():
        print(f"{name:<12} {r.target_acc:>8.3f} "
              f"{100*r.energy/emax:>8.1f}% {r.transmissions:>4d}")
    print("\npsi (ST-LF):", stlf.psi.astype(int))
    print("alpha (ST-LF):")
    print(np.round(stlf.alpha, 2))


if __name__ == "__main__":
    main()
