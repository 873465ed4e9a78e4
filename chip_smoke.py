#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits nonzero):

1. device  — requires CUDA; prints the card's name and power limit.
2. build   — compiles every CUDA kernel of the port from its source in
             this checkout (``build/repro_torch/``), all at once.
3. kernels — holds each kernel against its plain PyTorch version on the
             card (``alpha_combine`` to rtol/atol 1e-5, ``disagreement``
             exactly) and times kernel, plain version and one PyTorch
             library call with CUDA events.
4. main path — the ST-LF paper pipeline at its full-size setting (10
             devices x 250 samples, 300 local SGD steps, Algorithm 1 with
             tau=4, T=25, the default solver), through the port's entry
             points on ``cuda``; every kernel's launch count is zeroed
             just before and read just after, and must have risen.
5. checks  — the disagreement kernel on the trained models' predictions
             and the transfer against their plain versions, and the GPU
             against the port on the CPU at a small size.

``python3 chip_smoke.py --profile`` adds a torch.profiler window over
each phase (the device's busy share, top kernels) after phase 5.

The last three lines of standard output are the ``nvidia-smi`` name and
power limit, one JSON object describing every kernel, and the device
JSON; the line before them, ``[report] {...}``, holds every number the
run took.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet): memory rate, fp32 without tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12
INNER_STEPS = 1500          # solve_stlf's default inner budget (run_stlf)

KERNEL_META = {
    "alpha_combine": dict(
        source="src/repro_torch/kernels/alpha_combine/csrc/alpha_combine.cu",
        replaces="src/repro/kernels/alpha_combine/kernel.py:25"),
    "disagreement": dict(
        source="src/repro_torch/kernels/disagreement/csrc/disagreement.cu",
        replaces="src/repro/kernels/disagreement/kernel.py:21"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, iters: int) -> float:
    """Mean milliseconds of ``fn`` over ``iters`` back-to-back calls,
    CUDA events around the run, after a warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: float, ops: float):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the fp32 rate."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_FP32_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_kernels(ac, dg, report):
    """Each kernel against its plain version at the main path's shape and
    at the others the port is built for; timings of all three."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = {"alpha_combine": [], "disagreement": []}
    for s, t, p in [(10, 10, 48158), (256, 256, 48158), (7, 5, 1001)]:
        theta = torch.randn(s, p, device=dev, generator=gen)
        alpha = torch.rand(s, t, device=dev, generator=gen)
        alpha /= alpha.sum(0, keepdim=True)
        out = ac.alpha_combine(theta, alpha)
        torch.cuda.synchronize()
        plain = ac.alpha_combine_plain(theta, alpha)
        err = float((out - plain).abs().max())
        if not torch.allclose(out, plain, rtol=1e-5, atol=1e-5):
            raise AssertionError(f"alpha_combine {(s, t, p)}: max abs err "
                                 f"{err} beyond rtol/atol 1e-5")
        iters = 200 if s * p < 1e7 else 20
        b_ms, b_by = bound(4 * (s * p + s * t + t * p), 2 * s * t * p)
        rows["alpha_combine"].append(dict(
            shape=[s, t, p], max_abs_err=err,
            ms=cuda_ms(lambda: ac.alpha_combine(theta, alpha), iters),
            plain_ms=cuda_ms(lambda: ac.alpha_combine_plain(
                theta, alpha), iters),
            library_ms=cuda_ms(lambda: torch.matmul(alpha.T, theta),
                               iters),
            bound_ms=b_ms, bound_by=b_by))
    # all rows valid at the timed shapes, as on the main path (there
    # torch.cdist with p=0 counts the same mismatches); a mask at the last
    for n, m, masked in [(10, 2500, False), (256, 64000, False),
                         (13, 777, True)]:
        preds = torch.randint(0, 10, (n, m), device=dev, generator=gen,
                              dtype=torch.int32)
        valid = (torch.rand(m, device=dev, generator=gen) < 0.8).float() \
            if masked else torch.ones(m, device=dev)
        fpreds = preds.float()
        out = dg.disagreement_counts(preds, valid)
        torch.cuda.synchronize()
        plain = dg.disagreement_counts_plain(preds, valid)
        if not torch.equal(out, plain):
            raise AssertionError(f"disagreement {(n, m)}: max abs err "
                                 f"{float((out - plain).abs().max())}, "
                                 f"exact equality required")
        iters = 200 if n * n * m < 1e8 else 10
        b_ms, b_by = bound(4 * (n * m + m + n * n), 2 * n * n * m)
        rows["disagreement"].append(dict(
            shape=[n, m], max_abs_err=0.0,
            ms=cuda_ms(lambda: dg.disagreement_counts(preds, valid),
                       iters),
            plain_ms=cuda_ms(lambda: dg.disagreement_counts_plain(
                preds, valid), max(1, iters // 10)),
            library_ms=None if masked else cuda_ms(
                lambda: torch.cdist(fpreds, fpreds, p=0), iters),
            bound_ms=b_ms, bound_by=b_by))
    for name, rs in rows.items():
        for r in rs:
            lib = "none" if r["library_ms"] is None \
                else f"{r['library_ms']:.4f} ms"
            log(f"[kernels] {name} {r['shape']}: {r['ms']:.4f} ms kernel, "
                f"{r['plain_ms']:.4f} ms plain, library {lib}, "
                f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}), "
                f"max abs err {r['max_abs_err']:.3g}")
    report["kernel_shapes"] = rows
    return rows


def phase_main_path(ac, dg, report):
    """The paper pipeline at full size through the port's entry points."""
    from repro_torch.data import build_network
    from repro_torch.fl import pairwise_disagreement, prepare_round, run_stlf

    devices = build_network("M//MM", num_devices=10, samples_per_device=250,
                            seed=0)
    ac.alpha_combine.launches = 0
    dg.disagreement_counts.launches = 0
    t0 = time.perf_counter()
    state = prepare_round(devices, 0, train_iters=300, div_tau=4, div_T=25)
    t1 = time.perf_counter()
    hyp = pairwise_disagreement(state.params, state.clients).cpu().numpy()
    t2 = time.perf_counter()
    stlf = run_stlf(state)
    t3 = time.perf_counter()
    launches = {"alpha_combine": ac.alpha_combine.launches,
                "disagreement": dg.disagreement_counts.launches}
    solve_s = stlf.solver.solve_time_s
    wall = dict(prepare_round=t1 - t0, train=state.wall_s["train"],
                divergence=state.wall_s["divergence"],
                hyp_disagreement=t2 - t1, solve=solve_s,
                transfer_eval=(t3 - t2) - solve_s, total=t3 - t0)
    steps = stlf.solver.outer_iters * INNER_STEPS
    log("[main] phase wall s: " + ", ".join(
        f"{k}={v:.3f}" for k, v in wall.items()))
    log(f"[main] solver: {stlf.solver.outer_iters} outer x {INNER_STEPS} "
        f"inner steps, {solve_s / steps * 1e3:.3f} ms per inner step "
        f"(host clock)")
    log(f"[main] psi={stlf.psi.astype(int).tolist()} "
        f"n_targets={int(stlf.psi.sum())} target_acc={stlf.target_acc:.4f} "
        f"energy={stlf.energy:.6f} transmissions={stlf.transmissions}")
    log(f"[main] launches in the main path: {launches}")
    for name, n in launches.items():
        if n < 1:
            raise AssertionError(f"{name} kernel was not launched on the "
                                 f"main path")

    # outputs are right by the repo's own means
    n = len(devices)
    if not (stlf.psi.shape == (n,) and set(stlf.psi) <= {0.0, 1.0}
            and (stlf.psi == 0).any()):
        raise AssertionError(f"bad psi {stlf.psi}")
    tg = stlf.psi == 1.0
    if not np.allclose(stlf.alpha[:, tg].sum(0), 1.0) \
            or not np.all(np.isfinite(stlf.per_device_acc)) \
            or not np.isfinite(stlf.energy):
        raise AssertionError("alpha columns, accuracies or energy invalid")
    if not (np.isfinite(state.div_hat).all() and np.allclose(
            state.div_hat, state.div_hat.T)
            and np.all((hyp >= 0) & (hyp <= 1))):
        raise AssertionError("divergence or disagreement matrix invalid")

    # the disagreement kernel on the trained models' predictions
    from repro_torch.fl import cnn
    c = state.clients
    x = c.x[c.valid]
    with torch.no_grad():
        preds = torch.argmax(cnn.forward_stacked(
            state.params, x[None].expand(n, *x.shape)), -1) \
            .to(torch.int32).contiguous()
    ones = torch.ones(preds.shape[1], device=preds.device)
    kern = dg.disagreement_counts(preds, ones)
    plain = dg.disagreement_counts_plain(preds, ones)
    if not torch.equal(kern, plain):
        raise AssertionError("disagreement on trained predictions differs "
                             "from the plain version")
    if not np.allclose(hyp, (plain / preds.shape[1]).cpu().numpy()):
        raise AssertionError("pairwise_disagreement is not eq. (4)")

    # the transfer through the plain version gives the same accuracies
    from repro_torch.fl.client import true_accuracies
    from repro_torch.nn.param import flatten_to_vector, unflatten_from_vector
    flat = flatten_to_vector(state.params, lead=1)
    alpha = torch.as_tensor(stlf.alpha, dtype=torch.float32,
                            device=flat.device)
    mixed = unflatten_from_vector(ac.alpha_combine_plain(flat, alpha),
                                  state.params, lead=1)
    psi = torch.as_tensor(stlf.psi, dtype=torch.float32, device=flat.device)
    sel = {k: v * (1 - psi.reshape(-1, *[1] * (v.dim() - 1)))
           + mixed[k] * psi.reshape(-1, *[1] * (v.dim() - 1))
           for k, v in state.params.items()}
    plain_acc = true_accuracies(sel, c).cpu().numpy()
    if not np.array_equal(plain_acc, stlf.per_device_acc):
        raise AssertionError(f"transfer: kernel accuracies "
                             f"{stlf.per_device_acc} != plain {plain_acc}")

    report["main_path"] = dict(
        wall_s=wall, launches=launches, psi=stlf.psi.tolist(),
        n_targets=int(stlf.psi.sum()), target_acc=stlf.target_acc,
        energy=stlf.energy, transmissions=stlf.transmissions,
        per_device_acc=stlf.per_device_acc.tolist(),
        eps_hat=state.eps_hat.tolist(),
        outer_iters=stlf.solver.outer_iters,
        objective_trace=stlf.solver.objective_trace)
    return launches, state, stlf


def phase_profile(state, stlf, report):
    """``--profile`` only: torch.profiler over short windows of each phase
    on the main path's state; the device's busy share of each window
    (kernel time summed over wall time) and its top kernels."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.problem import STLFProblem
    from repro_torch.core.solver import solve_stlf
    from repro_torch.fl import evaluate_assignment, train_local

    from repro_torch.kernels.alpha_combine import ops as ac
    from repro_torch.kernels.disagreement import ops as dg

    prob = STLFProblem(state.bounds, state.energy)
    dev = torch.device("cuda")
    theta = torch.randn(10, 48158, device=dev)
    alpha = torch.rand(10, 10, device=dev)
    preds = torch.randint(0, 10, (10, 2500), device=dev, dtype=torch.int32)
    ones = torch.ones(2500, device=dev)
    windows = {
        # device time of each kernel at the main path's shapes, x20
        "kernels_x20": lambda: [(ac.alpha_combine(theta, alpha),
                                 dg.disagreement_counts(preds, ones))
                                for _ in range(20)],
        "train_20_steps": lambda: train_local(state.params, state.clients, 1,
                                              iters=20),
        "solve_1x128_steps": lambda: solve_stlf(
            prob, max_outer=1, inner_steps=128, polish=False),
        "transfer_eval": lambda: evaluate_assignment(
            state, "ST-LF", stlf.psi, stlf.alpha),
    }
    out = {}
    for name, fn in windows.items():
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        # kernel entries only: an operator's entry repeats its kernels' time
        dev = [(e.self_device_time_total, e.key)
               for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
        busy = sum(t for t, _ in dev)
        top = sorted(dev, reverse=True)[:5]
        out[name] = dict(wall_us=wall_us, device_us=busy,
                         busy_share=busy / wall_us,
                         top=[[k, t] for t, k in top])
        log(f"[profile] {name}: wall {wall_us:.0f} us, device busy "
            f"{busy:.0f} us ({busy / wall_us:.1%}); top: "
            + "; ".join(f"{k[:40]} {t:.0f}us" for t, k in top))
    report["profile"] = out


def phase_small_reference():
    """The port on the GPU against the port on the CPU (which the CPU
    tests hold against the JAX package) on small inputs."""
    from repro_torch.core.bounds import BoundTerms
    from repro_torch.core.energy import EnergyModel
    from repro_torch.core.problem import STLFProblem
    from repro_torch.core.solver import solve_stlf
    from repro_torch.data import build_network
    from repro_torch.fl.client import (init_client_params,
                                       sample_train_indices, stack_clients,
                                       train_sources)

    devs = build_network("M//MM", num_devices=4, samples_per_device=40,
                         seed=2, label_subset=[0, 1, 2, 3])
    out = {}
    for dev in ("cpu", "cuda"):
        c = stack_clients(devs, device=dev)
        p0 = init_client_params(4, torch.Generator().manual_seed(0),
                                device=dev)
        draws = sample_train_indices(c, torch.Generator().manual_seed(1),
                                     iters=10, batch=10)
        out[dev] = train_sources(p0, c, iters=10, batch=10, draws=draws)
    for k in out["cpu"]:
        if not torch.allclose(out["cuda"][k].cpu(), out["cpu"][k],
                              rtol=1e-4, atol=1e-5):
            raise AssertionError(f"train_sources: GPU differs from CPU on "
                                 f"{k}")
    rng = np.random.default_rng(0)
    eps = rng.uniform(0.05, 1.0, 6)
    div = rng.uniform(0.1, 1.5, (6, 6))
    div = 0.5 * (div + div.T)
    np.fill_diagonal(div, 0.0)
    prob = STLFProblem(BoundTerms(eps, np.full(6, 5000), div),
                       EnergyModel.sample(6, rng))
    a = solve_stlf(prob, max_outer=3, inner_steps=200, device="cpu")
    b = solve_stlf(prob, max_outer=3, inner_steps=200, device="cuda")
    if not (np.array_equal(a.psi, b.psi)
            and np.allclose(a.alpha, b.alpha, atol=1e-3)):
        raise AssertionError("solve_stlf: GPU decisions differ from CPU")
    log("[small] train_sources and solve_stlf agree on GPU and CPU")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.device import resolve_device
    from repro_torch.kernels import _build
    from repro_torch.kernels.alpha_combine import ops as ac
    from repro_torch.kernels.disagreement import ops as dg

    # 1. device
    resolve_device("cuda")                    # also turns TF32 off
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    log(f"[device] {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}; "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    report = {"nvidia_smi": smi, "torch": torch.__version__}

    # 2. build, every kernel at once
    t0 = time.perf_counter()
    ptxas = _build.build()
    report["build_s"] = time.perf_counter() - t0
    log(f"[build] {report['build_s']:.2f} s for {sorted(ptxas)}")
    for name, text in ptxas.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")

    # 3. kernels against their plain versions
    rows = phase_kernels(ac, dg, report)

    # 4. main path at full size, counted
    launches, state, stlf = phase_main_path(ac, dg, report)

    # 5. GPU against the CPU port on small inputs
    phase_small_reference()
    if "--profile" in sys.argv[1:]:
        phase_profile(state, stlf, report)

    kernels = []
    for name, rs in rows.items():
        main = rs[0]                # the main path's shape comes first
        kernels.append(dict(
            name=name, route="cuda", **KERNEL_META[name],
            launches=launches[name],
            max_abs_err=max(r["max_abs_err"] for r in rs),
            ms=main["ms"], plain_ms=main["plain_ms"],
            bound_ms=main["bound_ms"], bound_by=main["bound_by"],
            library_ms=main["library_ms"]))
    log("[report] " + json.dumps(report))
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
