#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits nonzero):

1. device  — requires CUDA; prints the card's name and power limit.
2. build   — compiles every CUDA kernel of the port from its source in
             this checkout (``build/repro_torch/``), all at once, and
             checks with ``cuobjdump -sass`` that the bf16 flash kernel,
             the alpha_combine kernels and the two ssm_scan kernels that
             compute products run on the tensor cores (HGMMA; HMMA/HGMMA
             ...TF32).
3. kernels — holds each kernel against its plain PyTorch version on the
             card (``alpha_combine`` to rtol/atol 1e-5 at six shapes, T
             past 256 and S no multiple of 8 among them;
             ``disagreement_counts`` and ``disagreement()`` exactly,
             fractional weights bit-equal on two launches and within
             rtol 1e-6, with both versions' error against a float64 sum;
             the host's share of a (10, 2500) call split into its parts)
             and times kernel, plain version and one PyTorch library
             call with CUDA events.
             ``flash_attention`` is held against its plain version at
             the serve path's two prefill shapes in bf16 (within one
             bf16 ulp: rtol 2^-7, atol 1e-5; the tensor-core kernel) and
             in fp32 (the SIMT kernel), and on the JAX package's test
             grid in fp32 (atol 3e-5, rtol 1e-4), and timed beside
             ``scaled_dot_product_attention`` (its own error against the
             plain version printed too).  Where a window applies, the
             plain version without it must fall outside the bar (the
             check sees a kernel that drops it).
             ``ssm_scan`` is held against its plain version at the rwkv
             serve path's two prefill shapes and a ragged L = 300, both
             variants, three decay regimes (rwkv6's init, -|N(0, 1)| and
             a strong -8 +- 0.5 that takes the diagonal blocks' per-pair
             branch), bf16 r/k/v with fp32 log_w and all fp32 (y in bf16
             within one ulp, in fp32 within 1e-5 / 1e-4, the state within
             1e-5 / 1e-4), and to the same bars against the plain version
             with its products summed in float64 (its fp32 sums alone lie
             up to ~0.8 of the fp32 bar from those); timed at the serve
             shapes with each of its three kernels' device time (the
             profiler must see each exactly once a call), and against the
             fp32 token-by-token recurrence at (1, 512).
3b. guard  — each kernel wrapper raises for a CUDA input that requires
             grad while grad is enabled (no kernel has a backward pass),
             and computes under ``torch.no_grad()``.
4. main path — the ST-LF paper pipeline at its full-size setting (10
             devices x 250 samples, 300 local SGD steps, Algorithm 1 with
             tau=4, T=25, the default solver), through the port's entry
             points on ``cuda``; every kernel's launch count is zeroed
             just before and read just after, and must have risen.
4b. baselines — the paper's comparison matrix (``run_all_baselines``:
             the four alpha-baselines on ST-LF's psi, the four
             psi-baselines) on that state, counted: ``alpha_combine``
             once a method; FADA's columns sum to one at its targets;
             on the card its gaps agree with the CPU port's on the same
             draws within 2 rows of a pair's data and its weights within
             1e-2 of their largest entry (the discriminators' SGD
             amplifies float32 noise in the features, see
             ``FADA_GAP_ROWS``), and half the learning rate (a planted
             fault) breaks both bars.
4c. sim    — the simulator's sync path through its CLI
             (``python -m repro_torch.sim.run``, ``--trace``): the
             default run (channel-drift, 8 devices, 5 rounds; a pool of
             8, one ``alpha_combine`` kernel a round), then device-churn
             at 16 devices for 3 rounds (4 spares, a pool of 20: two
             kernels a round), counted; each round's phase walls from
             the trace fields, the solves' inner steps from the trace
             events; the kernel against its plain version on the last
             round's own transfer inputs (rtol/atol 1e-5).
5. serve   — llama3.2-1b at full width (16 layers, seeded weights drawn
             on the card) with ``attention_impl="kernel"``: prefill of
             (4, 2048) and (1, 9216) prompts (the second past the 8192
             window), counted: the flash kernel must have run exactly
             32 times; the same prefills through ``"dot"`` agree; then
             ``serve.generate`` of 32 greedy tokens after a (4, 64)
             prompt, and JAX's serving invariant: the token-by-token
             decode's logits at the prompt's last token match prefill's.
             The logit checks test the whole stack's casts; the kernel
             itself is held, element by element, against its plain
             version on layer 0's own q, k, v of both prompts.
5b. serve-rwkv — rwkv6-1.6b at full width and depth (24 layers, seeded
             weights drawn on the card): prefill of (4, 2048) and
             (1, 16384) prompts, counted: ``ssm_scan``'s kernels must
             have run exactly 3 x 48 times (three a call, a call a layer),
             and 3 x 24 more at each later prefill; then
             ``serve.generate`` of 32 greedy tokens after a (4, 64)
             prompt, and JAX's serving invariant at (4, 64) and (2, 300);
             the kernel against its plain version on layer 0's own
             r, k, v, log_w of both prompts.
6. checks  — the disagreement kernel on the trained models' predictions
             and the transfer against their plain versions, and the GPU
             against the port on the CPU at a small size (the ST-LF
             pieces, two small sync simulator runs with equal decisions,
             and the LM's and rwkv6's prefill and greedy tokens).

``python3 chip_smoke.py --profile`` adds a torch.profiler window over
each phase (the device's busy share, top kernels; the ST-LF kernels'
launches and device time a call) after phase 6.

The last three lines of standard output are the ``nvidia-smi`` name and
power limit, one JSON object describing every kernel, and the device
JSON; the line before them, ``[report] {...}``, holds every number the
run took.
"""
from __future__ import annotations

import dataclasses
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet): memory rate, fp32 without tensor
# cores, bf16 and TF32 on the tensor cores (dense)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12
PEAK_BF16_PER_S = 989e12
PEAK_TF32_PER_S = 495e12
INNER_STEPS = 1500          # solve_stlf's default inner budget (run_stlf)

KERNEL_META = {
    "alpha_combine": dict(
        source="src/repro_torch/kernels/alpha_combine/csrc/alpha_combine.cu",
        replaces="src/repro/kernels/alpha_combine/kernel.py:25"),
    "disagreement": dict(
        source="src/repro_torch/kernels/disagreement/csrc/disagreement.cu",
        replaces="src/repro/kernels/disagreement/kernel.py:21"),
    "flash_attention": dict(
        source="src/repro_torch/kernels/flash_attention/csrc/"
               "flash_attention.cu",
        replaces="src/repro/kernels/flash_attention/kernel.py:31"),
    "ssm_scan": dict(
        source="src/repro_torch/kernels/ssm_scan/csrc/ssm_scan.cu",
        replaces="src/repro/kernels/ssm_scan/kernel.py:36"),
}
LM_ARCH = "llama3.2-1b"
# (B, S) of the serve path's two prefills: a batch of 2k prompts, and one
# prompt past llama3.2-1b's 8192-token sliding window
PREFILLS = [(4, 2048), (1, 9216)]
# the last-token logits of two bf16 paths (kernel vs dot prefill, decode
# vs prefill): tests/test_decode_parity.py's bar, and equal argmax
LM_TOL = dict(atol=0.15, rtol=0.05)
# flash_attention against its plain version.  Both sum in fp32 and round
# once to the output type, so in bf16 they differ by at most one bf16 ulp
# of the value (<= 2^-7 of it); fp32 is the JAX package's own bar
FLASH_TOL = {torch.bfloat16: dict(atol=1e-5, rtol=2.0 ** -7),
             torch.float32: dict(atol=3e-5, rtol=1e-4)}
RWKV_ARCH = "rwkv6-1.6b"
# (B, L) of the rwkv serve path's two prefills: a batch of 2k prompts,
# and one long prompt at batch 1, the case a linear-attention model is
# chosen for
RWKV_PREFILLS = [(4, 2048), (1, 16384)]
# ssm_scan against its plain version: y in bf16 within one bf16 ulp (both
# sum in fp32 and round once), y in fp32 within summation order, the
# final state (fp32) likewise; and to the same bars against the plain
# version with its products summed in float64 from the same fp32 factors
# (its fp32 sums, in cuBLAS's order, are themselves up to ~0.8 of the
# fp32 bar from those at rwkv6's scale)
SSM_TOL = {torch.bfloat16: dict(atol=1e-5, rtol=2.0 ** -7),
           torch.float32: dict(atol=1e-5, rtol=1e-4)}
SSM_STATE_TOL = dict(atol=1e-5, rtol=1e-4)
SSM_REGIMES = ("init", "abs", "strong")
# the kernels one ssm_scan call launches, in order, and those of them
# that compute products on the tensor cores
SSM_KERNELS = ("ssm_chunk_state_kernel", "ssm_state_scan_kernel",
               "ssm_chunk_output_kernel")
SSM_MMA_KERNELS = ("ssm_chunk_state_kernel", "ssm_chunk_output_kernel")
# the kernel against JAX's fp32 token-by-token recurrence: the decays
# are rounded differently (exp of a cumsum against a product of exps)
RECUR_TOL = dict(atol=1e-3, rtol=1e-4)


FADA_KW = dict(iters=40, batch=16, lr=0.05)   # fada_alpha's defaults
# FADA on the card against the CPU port on the same draws.  The
# discriminators' SGD steps far past stability (a row's |f|^2 reaches
# ~850 at lr 0.05), so float32 noise in the features (cuDNN's against
# the CPU's: ~6e-7 of the largest entry) moves w.  Gaps: at most 2 rows
# of a pair apart (measured: 0; noise ten times the measured one moves
# 1 row).  w: within 1e-2 of its largest entry (measured up to 2.5e-3;
# noise ten times the measured one: 3.1e-3).  Half the learning rate
# moves both far past the bars (PERF.md §6).
FADA_GAP_ROWS = 2
FADA_W_TOL = 1e-2
# the simulator's runs on the card: (scenario, devices, rounds); the
# default run (8 devices, no spares: a pool of 8, the transfer's one
# mma.sync kernel a round), then device-churn at 16 devices (4 spares: a
# pool of 20, split + wgmma, two kernels a round)
SIM_RUNS = [("channel-drift", 8, 5), ("device-churn", 16, 3)]
SIM_TAGS = [f"{s}-n{n}-r{r}" for s, n, r in SIM_RUNS]
# the small sync runs held GPU against CPU: (scenario, seed), each with
# targets in some round under the port's seeds
SMALL_SIM = [("channel-drift", 0), ("device-churn", 2)]
SMALL_SIM_CFG = dict(devices=5, rounds=3, samples_per_device=40,
                     train_iters=30, div_tau=1, div_T=3, solver_max_outer=4,
                     solver_inner_steps=300, solver_inner_steps_warm=150)
# RoundRecord fields that are decisions: GPU and CPU runs must agree
SIM_DECISIONS = ("n_active", "n_sources", "n_targets", "transmissions",
                 "events", "resolved", "warm", "resolve_reason")


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


def bound(nbytes: float, ops: float, peak_ops: float = PEAK_FP32_PER_S):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the peak rate of their type (fp32 by default)."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / peak_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def demangle(_build, symbol: str) -> str:
    """``symbol`` without its namespaces and parameters, through the
    toolkit's cu++filt: e.g. ``flash_fwd_tc_kernel<64>``."""
    text = subprocess.run(
        [str(Path(_build._nvcc()).parent / "cu++filt"), symbol],
        capture_output=True, text=True, timeout=60, check=True).stdout
    text = text.strip().replace("(anonymous namespace)::", "")
    text = text.replace("(bool)1", "true").replace("(bool)0", "false")
    return text.replace("(int)", "").split("(")[0].split("::")[-1]


def check_flash_sass(_build):
    """The bf16 flash kernel compiled to Hopper's warpgroup MMAs: every
    instance of ``flash_fwd_tc_kernel`` in the library must hold HGMMA
    instructions (a kernel compiled to FMAs fails).  Returns
    {instance: HGMMA count}."""
    cuobjdump = Path(_build._nvcc()).parent / "cuobjdump"
    sass = subprocess.run(
        [str(cuobjdump), "-sass", str(_build._target("flash_attention"))],
        capture_output=True, text=True, timeout=300, check=True).stdout
    counts = {}
    for fn in sass.split("Function : ")[1:]:
        name = fn.split("\n", 1)[0].strip()
        if "flash_fwd_tc_kernel" in name:
            d = re.search(r"flash_fwd_tc_kernelILi(\d+)E", name).group(1)
            counts[f"flash_fwd_tc_kernel<{d}>"] = len(
                re.findall(r"\bHGMMA\b", fn))
    if len(counts) != 4 or not all(counts.values()):
        raise AssertionError(f"flash_attention: the bf16 kernel's SASS "
                             f"lacks HGMMA instructions: {counts}")
    return counts


def check_alpha_sass(_build):
    """The alpha_combine kernels compiled to TF32 tensor-core MMAs:
    ``HMMA...TF32`` (mma.sync) in ``alpha_combine_tc_kernel``,
    ``HGMMA...TF32`` (wgmma) in ``alpha_combine_wgmma_kernel``; a kernel
    compiled to FMAs fails.  Returns {kernel: TF32 MMA count}."""
    cuobjdump = Path(_build._nvcc()).parent / "cuobjdump"
    sass = subprocess.run(
        [str(cuobjdump), "-sass", str(_build._target("alpha_combine"))],
        capture_output=True, text=True, timeout=300, check=True).stdout
    counts = {}
    for fn in sass.split("Function : ")[1:]:
        name = demangle(_build, fn.split("\n", 1)[0].strip())
        if name.startswith("alpha_combine_tc_kernel"):
            counts[name] = len(re.findall(r"\bHMMA\.\S*TF32", fn))
        elif name.startswith("alpha_combine_wgmma_kernel"):
            counts[name] = len(re.findall(r"\bHGMMA\.\S*TF32", fn))
    if sorted(counts) != ["alpha_combine_tc_kernel",
                          "alpha_combine_wgmma_kernel"] \
            or not all(counts.values()):
        raise AssertionError(f"alpha_combine: the kernels' SASS lacks TF32 "
                             f"MMA instructions: {counts}")
    return counts


def check_ssm_sass(_build):
    """The ssm_scan kernels that compute products compiled to TF32
    tensor-core MMAs (``HMMA...TF32``, mma.sync), every instance of each;
    a kernel compiled to FMAs fails.  Returns {instance: TF32 MMA
    count}."""
    cuobjdump = Path(_build._nvcc()).parent / "cuobjdump"
    sass = subprocess.run(
        [str(cuobjdump), "-sass", str(_build._target("ssm_scan"))],
        capture_output=True, text=True, timeout=300, check=True).stdout
    counts = {}
    for fn in sass.split("Function : ")[1:]:
        mangled = fn.split("\n", 1)[0].strip()
        for kernel in SSM_MMA_KERNELS:
            inst = re.search(kernel + r"I((?:Lb[01]E)+)E", mangled)
            if inst:  # the template arguments: which inputs are bf16
                args = ", ".join("true" if a == "1" else "false" for a in
                                 re.findall(r"Lb([01])E", inst.group(1)))
                counts[f"{kernel}<{args}>"] = len(
                    re.findall(r"\bHMMA\.\S*TF32", fn))
    # the state kernel for each dtype of k and v, the output kernel for
    # each of q, k and v
    if len(counts) != 4 + 8 or not all(counts.values()):
        raise AssertionError(f"ssm_scan: the kernels' SASS lacks TF32 MMA "
                             f"instructions: {counts}")
    return counts


def zero_counts(kernels):
    for fn in kernels.values():
        fn.launches = 0


def read_counts(kernels):
    return {name: fn.launches for name, fn in kernels.items()}


def phase_kernels(ac, dg, report):
    """Each kernel against its plain version at the main path's shape and
    at the others the port is built for; timings of all three."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = {"alpha_combine": [], "disagreement": []}
    # the main path's shape first, the simulator's scale, ragged P, an S
    # that is no multiple of 8, and T past one block's 256 targets
    for s, t, p in [(10, 10, 48158), (256, 256, 48158), (7, 5, 1001),
                    (13, 9, 48158), (300, 300, 1001), (64, 300, 48158)]:
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
        nbytes = 4 * (s * p + s * t + t * p)
        # the function's work, 2 S T P, at the tensor cores' TF32 peak;
        # beside it the time of the 3xTF32 split's three products at that
        # peak (the kernel's own floor) and the fp32-FMA bound
        b_ms, b_by = bound(nbytes, 2 * s * t * p, PEAK_TF32_PER_S)
        fma_ms, _ = bound(nbytes, 2 * s * t * p)
        row = dict(
            shape=[s, t, p], max_abs_err=err,
            ms=cuda_ms(lambda: ac.alpha_combine(theta, alpha), iters),
            plain_ms=cuda_ms(lambda: ac.alpha_combine_plain(
                theta, alpha), iters),
            library_ms=cuda_ms(lambda: torch.matmul(alpha.T, theta),
                               iters),
            bound_ms=b_ms, bound_by=b_by, fp32_fma_bound_ms=fma_ms,
            split_products_ms=3 * 2 * s * t * p / PEAK_TF32_PER_S * 1e3)
        rows["alpha_combine"].append(row)
    # all rows valid at the timed shapes, as on the main path (there
    # torch.cdist with p=0 counts the same mismatches); masks after them
    for n, m, masked in [(10, 2500, False), (256, 64000, False),
                         (13, 777, True), (130, 777, True)]:
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
        # the main path's call: disagreement(preds), the normalized matrix
        # in the kernel's one launch, equal to counts / max(sum(valid), 1)
        norm = dg.disagreement(preds, valid > 0 if masked else None)
        if not torch.equal(norm, plain / torch.clamp(valid.sum(), min=1.0)):
            raise AssertionError(f"disagreement() {(n, m)} is not counts / "
                                 f"max(sum(valid), 1) bit for bit")
        iters = 200 if n * n * m < 1e8 else 10
        b_ms, b_by = bound(4 * (n * m + m + n * n), 2 * n * n * m)
        row = dict(
            shape=[n, m], masked=masked, max_abs_err=0.0,
            ms=cuda_ms(lambda: dg.disagreement_counts(preds, valid),
                       iters),
            plain_ms=cuda_ms(lambda: dg.disagreement_counts_plain(
                preds, valid), max(1, iters // 10)),
            library_ms=None if masked else cuda_ms(
                lambda: torch.cdist(fpreds, fpreds, p=0), iters),
            bound_ms=b_ms, bound_by=b_by)
        if not masked:
            row.update(
                main_call_ms=cuda_ms(lambda: dg.disagreement(preds), iters),
                library_normalized_ms=cuda_ms(
                    lambda: torch.cdist(fpreds, fpreds, p=0) / m, iters))
        if (n, m) == (10, 2500):
            row["host"] = host_breakdown(dg, preds, valid, iters)
        rows["disagreement"].append(row)
    report["disagreement_fractional"] = check_fractional_weights(dg, gen)
    # the cluster capacities the wrapper sizes its clusters from, and its
    # choice at each timed shape
    caps = {bn: dg._caps(0, bn) for bn in (16, 32)}
    report["disagreement_clusters"] = dict(
        capacity=caps, plan={f"{n}x{m}": dg._plan(n, m, 0)
                             for n, m in [(10, 2500), (256, 64000)]})
    log(f"[kernels] disagreement clusters the card holds at once, sizes "
        f"1-8: {caps}; (tile, cluster) chosen: "
        f"{report['disagreement_clusters']['plan']}")
    for name, rs in rows.items():
        for r in rs:
            lib = "none" if r["library_ms"] is None \
                else f"{r['library_ms']:.4f} ms"
            extra = ""
            if "fp32_fma_bound_ms" in r:
                extra = (f" (the split's three TF32 products "
                         f"{r['split_products_ms']:.4f} ms; fp32-FMA bound "
                         f"{r['fp32_fma_bound_ms']:.4f} ms)")
            if "main_call_ms" in r:
                extra = (f"; disagreement(preds) {r['main_call_ms']:.4f} "
                         f"ms, cdist/M {r['library_normalized_ms']:.4f} ms")
            log(f"[kernels] {name} {r['shape']}: {r['ms']:.4f} ms kernel, "
                f"{r['plain_ms']:.4f} ms plain, library {lib}, "
                f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}){extra}, "
                f"max abs err {r['max_abs_err']:.3g}")
    report["kernel_shapes"] = rows
    return rows


def host_breakdown(dg, preds, valid, iters):
    """Where a small call's time goes: the wrapper against its parts, each
    timed alone back to back (CUDA events; at this size the host's
    enqueue rate): ``torch.empty`` of the output, the bare ``ctypes``
    launch into a preallocated output, and the wrapper's checks and
    lookups (a call that fails its last check before the launch)."""
    n, m = preds.shape
    out = torch.empty((n, n), device=preds.device)
    fpreds = preds.float()
    bn, cl = dg._plan(n, m, preds.get_device())
    launch = dg._entry()
    stream = torch.cuda.current_stream().cuda_stream

    def bare():
        launch(preds.data_ptr(), valid.data_ptr(), out.data_ptr(), n, m, bn,
               cl, 0, stream)
    parts = dict(
        wrapper_ms=cuda_ms(lambda: dg.disagreement_counts(preds, valid),
                           iters),
        empty_ms=cuda_ms(lambda: torch.empty((n, n), device=preds.device),
                         iters),
        bare_launch_ms=cuda_ms(bare, iters),
        checks_ms=cuda_ms(lambda: dg._ready(preds, valid), iters),
        cdist_ms=cuda_ms(lambda: torch.cdist(fpreds, fpreds, p=0), iters))
    log("[kernels] disagreement (10, 2500) host: " + ", ".join(
        f"{k} {v:.4f}" for k, v in parts.items()))
    return parts


def _counts_f64(preds, valid):
    """The disagreement counts summed in float64, in row blocks."""
    n = preds.shape[0]
    rows = max(1, 2 ** 27 // max(n * preds.shape[1], 1))
    v = valid.double()
    return torch.cat([((preds[i:i + rows, None, :] != preds[None, :, :])
                       .double() * v).sum(-1) for i in range(0, n, rows)])


def check_fractional_weights(dg, gen):
    """Fractional weights: two launches give the same bits (the kernel's
    sum order is fixed by the shapes), within rtol 1e-6 of the plain
    version (whose order is torch's); both versions' error against the
    same sum in float64 is reported."""
    dev = torch.device("cuda")
    out = []
    for n, m in [(256, 64000), (130, 777), (10, 2500)]:
        preds = torch.randint(0, 10, (n, m), device=dev, generator=gen,
                              dtype=torch.int32)
        valid = torch.rand(m, device=dev, generator=gen)
        a = dg.disagreement_counts(preds, valid)
        b = dg.disagreement_counts(preds, valid)
        plain = dg.disagreement_counts_plain(preds, valid)
        exact = _counts_f64(preds, valid)

        def rel_err(x, ref):
            return float(((x.double() - ref).abs()
                          / ref.abs().clamp(min=1e-30)).max())
        rel = rel_err(a, plain.double())
        rel_kernel, rel_plain = rel_err(a, exact), rel_err(plain, exact)
        if not torch.equal(a, b):
            raise AssertionError(f"disagreement {(n, m)}: two launches on "
                                 f"fractional weights differ")
        if not torch.allclose(a, plain, rtol=1e-6, atol=0.0):
            raise AssertionError(f"disagreement {(n, m)}: fractional "
                                 f"weights {rel:.3g} from the plain "
                                 f"version, beyond rtol 1e-6")
        log(f"[kernels] disagreement {[n, m]} fractional weights: two "
            f"launches bit-equal, max rel err {rel:.3g} against the plain "
            f"version; against a float64 sum: kernel {rel_kernel:.3g}, "
            f"plain {rel_plain:.3g}")
        out.append(dict(shape=[n, m], bit_equal=True, max_rel_err=rel,
                        kernel_rel_err_f64=rel_kernel,
                        plain_rel_err_f64=rel_plain))
    return out


def live_pairs(sq: int, sk: int, causal: bool, window) -> int:
    """(query, key) pairs one (batch, head) of flash attention keeps, with
    query i at position i + sk - sq."""
    i = np.arange(sq) + (sk - sq)
    hi = np.minimum(i, sk - 1) if causal else np.full(sq, sk - 1)
    lo = np.maximum(0, i - window + 1) if window else np.zeros(sq, int)
    return int(np.clip(hi - lo + 1, 0, None).sum())


def _beyond(out, ref, tol) -> int:
    """Elements of ``out`` outside ``torch.allclose``'s bar around ref."""
    ref = ref.float()
    return int(((out.float() - ref).abs()
                > tol["atol"] + tol["rtol"] * ref.abs()).sum())


def check_flash(fa, q, k, v, causal, window, what):
    """The kernel against its plain version on the same inputs, within
    FLASH_TOL; with a window, the plain version without it (what a
    kernel that dropped the window would give) must fall outside the bar.
    Returns (max abs err, elements the windowless version moves beyond
    the bar or None, RMS of the output)."""
    out = fa.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    plain = fa.flash_attention_plain(q, k, v, causal=causal, window=window)
    tol = FLASH_TOL[q.dtype]
    err = float((out.float() - plain.float()).abs().max())
    rms = float(plain.float().square().mean().sqrt())
    if out.dtype != q.dtype or not torch.isfinite(out).all() \
            or not torch.allclose(out.float(), plain.float(), **tol):
        raise AssertionError(f"flash_attention {what}: max abs err {err} "
                             f"beyond {tol} ({_beyond(out, plain, tol)} "
                             f"elements; output RMS {rms:.3g})")
    del out
    moved = None
    if window is not None:
        moved = _beyond(fa.flash_attention_plain(q, k, v, causal=causal),
                        plain, tol)
        if moved == 0:
            raise AssertionError(f"flash_attention {what}: dropping the "
                                 f"window moves no element beyond {tol}; "
                                 f"the check cannot see the window")
    return err, moved, rms


def phase_flash(fa):
    """``flash_attention`` against its plain version at the serve path's
    prefill shapes (bf16 and fp32, GQA K/V as ``attend`` passes them;
    bf16 timed beside ``scaled_dot_product_attention``) and on the JAX
    package's test grid (``tests/test_kernels.py``, fp32)."""
    import torch.nn.functional as F
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [  # (b, sq, sk, h, kv, d, causal, window, dtype)
        (4, 2048, 2048, 32, 8, 64, True, None, bf16),
        (1, 9216, 9216, 32, 8, 64, True, 8192, bf16),
        (4, 2048, 2048, 32, 8, 64, True, None, f32),
        (1, 9216, 9216, 32, 8, 64, True, 8192, f32),
        (1, 100, 100, 3, 3, 64, True, None, f32),
        (2, 64, 64, 2, 2, 32, True, 24, f32),
        (1, 32, 160, 2, 2, 16, True, None, f32),
        (1, 96, 96, 1, 1, 128, False, None, f32),
    ]
    rows = []
    for b, sq, sk, h, kv, d, causal, window, dt in cases:
        q = torch.randn(b, sq, h, d, device=dev, generator=gen).to(dt)
        k, v = (torch.randn(b, sk, kv, d, device=dev, generator=gen).to(dt)
                for _ in range(2))
        shape = [b, sq, sk, h, kv, d]
        dtype = str(dt).replace("torch.", "")
        route = "tensor cores (wgmma, bf16)" if dt == bf16 \
            else "SIMT (fp32 FMAs)"
        err, moved, rms = check_flash(
            fa, q, k, v, causal, window,
            f"{shape} {dtype} causal={causal} window={window}")
        row = dict(shape=shape, causal=causal, window=window, dtype=dtype,
                   kernel=route, max_abs_err=err, out_rms=rms,
                   tol=FLASH_TOL[dt], beyond_bar_without_window=moved)
        note = f"max abs err {err:.3g} (output RMS {rms:.3g}, bar " \
               f"{FLASH_TOL[dt]})" + ("" if moved is None else
                                      f"; without the window {moved} "
                                      f"elements fall beyond the bar")
        if dt == bf16:             # the serve path's shapes: timed
            pairs = live_pairs(sq, sk, causal, window) * b * h
            nbytes = (2 * q.numel() + k.numel() + v.numel()) \
                * q.element_size()
            b_ms, b_by = bound(nbytes, 4 * d * pairs, PEAK_BF16_PER_S)
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            mask = None
            if window is not None:
                i = torch.arange(sq, device=dev)[:, None] + (sk - sq)
                j = torch.arange(sk, device=dev)[None, :]
                mask = (j <= i) & (j > i - window)

            def sdpa():
                return F.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=mask,
                    is_causal=mask is None and causal, enable_gqa=True)
            # SDPA against the same plain version, beside the kernel
            plain = fa.flash_attention_plain(q, k, v, causal=causal,
                                             window=window)
            lib = sdpa().transpose(1, 2)
            row.update(sdpa_max_abs_err=float(
                (lib.float() - plain.float()).abs().max()),
                sdpa_beyond_bar=_beyond(lib, plain, FLASH_TOL[dt]))
            del lib, plain
            row.update(
                pairs=pairs, flops=4 * d * pairs, bytes=nbytes,
                ms=cuda_ms(lambda: fa.flash_attention(
                    q, k, v, causal=causal, window=window), 10),
                plain_ms=cuda_ms(lambda: fa.flash_attention_plain(
                    q, k, v, causal=causal, window=window), 2),
                library_ms=cuda_ms(sdpa, 10),
                bound_ms=b_ms, bound_by=b_by)
            row["tflops"] = 4 * d * pairs / row["ms"] / 1e9
            log(f"[kernels] flash_attention {shape} {dtype} window="
                f"{window} on the {route}: {row['ms']:.4f} ms kernel "
                f"({row['tflops']:.1f} TFLOP/s of 4 D per live pair), "
                f"{row['plain_ms']:.4f} ms plain, sdpa "
                f"{row['library_ms']:.4f} ms, bound {b_ms:.4f} ms "
                f"({b_by}); {note}; sdpa against the plain version: max "
                f"abs err {row['sdpa_max_abs_err']:.3g}, "
                f"{row['sdpa_beyond_bar']} elements beyond the bar")
        else:
            log(f"[kernels] flash_attention {shape} {dtype} causal="
                f"{causal} window={window} on the {route}: {note}")
        rows.append(row)
        del q, k, v
        torch.cuda.empty_cache()
    return rows


def _timed(fn):
    """(result, host seconds) of ``fn`` between two synchronizes."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _logit_gap(a, b, what):
    """Max abs difference of two (B, 1, V) logit tensors; raises unless
    they agree within LM_TOL with equal argmax in every row."""
    a, b = a.float(), b.float()
    diff = float((a - b).abs().max())
    top2 = b.topk(2, dim=-1).values
    gap = float((top2[..., 0] - top2[..., 1]).min())
    if not (torch.isfinite(a).all() and torch.allclose(a, b, **LM_TOL)
            and torch.equal(a.argmax(-1), b.argmax(-1))):
        raise AssertionError(
            f"{what}: max |dlogit| {diff:.4g} (tolerance {LM_TOL}), argmax "
            f"{a.argmax(-1).flatten().tolist()} vs "
            f"{b.argmax(-1).flatten().tolist()}, smallest top-2 gap "
            f"{gap:.4g}")
    return diff, gap


def layer0_qkv(model, params, tokens):
    """Layer 0's q, k, v as ``DecoderLM.prefill`` hands them to the
    attention impl: the prompt's embedding, rmsnorm, projection, rope."""
    from repro_torch.models.common import take_layer
    from repro_torch.nn.attention import project_qkv
    from repro_torch.nn.layers import rmsnorm
    cfg = model.cfg
    dtype = getattr(torch, cfg.dtype)
    x = model._embed_inputs(params, {"tokens": tokens}, dtype)
    b, s, _ = x.shape
    p = take_layer(params["layers"], 0)
    positions = torch.arange(s, device=x.device).expand(b, s)
    return project_qkv(p["attn"], rmsnorm(x, p["ln1"], cfg.norm_eps),
                       positions, cfg.rope_theta, dtype)


def phase_serve(counted, report):
    """llama3.2-1b at full width through the port's serving entry points:
    ``DecoderLM.prefill`` with the flash kernel (counted), the same
    prefills through ``"dot"``, ``serve.generate``, and JAX's
    prefill/decode invariant (tests/test_decode_parity.py).  The logits
    agree through the whole stack's casts; the kernel itself is held
    element by element against its plain version on layer 0's q, k, v of
    each prompt (every query row, so also the causal mask and window)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.launch.serve import generate
    from repro_torch.models.api import build_model
    from repro_torch.nn.param import count_params

    fa = counted["flash_attention"]
    dev = torch.device("cuda")
    cfg = dataclasses.replace(get_config(LM_ARCH), attention_impl="kernel")
    model = build_model(cfg)
    params, init_s = _timed(lambda: model.init(
        torch.Generator(device=dev).manual_seed(0), device=dev))
    n_params = count_params(params)
    log(f"[serve] {cfg.name}: {n_params:,} parameters (float32, drawn on "
        f"the card from seed 0) in {init_s:.3f} s; compute dtype "
        f"{cfg.dtype}, attention_impl={cfg.attention_impl}")
    gen = torch.Generator(device=dev).manual_seed(1)
    prompts = [torch.randint(0, cfg.vocab_size, shape, device=dev,
                             generator=gen) for shape in PREFILLS]

    # the main path: two full-width prefills through the kernel, counted
    zero_counts(counted)
    first = [_timed(lambda p=p: model.prefill(params, {"tokens": p}))
             for p in prompts]
    launches = read_counts(counted)
    log(f"[serve] launches in the serve path: {launches}")
    if launches["flash_attention"] != 2 * cfg.num_layers:
        raise AssertionError(f"flash_attention launched "
                             f"{launches['flash_attention']} times in two "
                             f"prefills, not {2 * cfg.num_layers}")

    out = dict(params=n_params, init_s=init_s, launches=launches,
               prefill=[])
    dot = build_model(dataclasses.replace(cfg, attention_impl="dot"))
    for (b, s), p, (logits, first_s) in zip(PREFILLS, prompts, first):
        if logits.shape != (b, 1, cfg.vocab_size):
            raise AssertionError(f"prefill logits {tuple(logits.shape)}")
        before = fa.launches
        again, steady_s = _timed(lambda: model.prefill(params,
                                                       {"tokens": p}))
        if fa.launches != before + cfg.num_layers:
            raise AssertionError("a later prefill did not launch the "
                                 "kernel once per layer")
        if not torch.equal(again, logits):
            raise AssertionError(f"prefill {(b, s)} through the kernel is "
                                 f"not deterministic")
        ref, dot_s = _timed(lambda: dot.prefill(params, {"tokens": p}))
        diff, gap = _logit_gap(logits, ref,
                               f"prefill {(b, s)} kernel vs dot")
        del ref
        window = cfg.sliding_window if s > cfg.sliding_window else None
        l0_err, l0_moved, l0_rms = check_flash(
            fa_ops, *layer0_qkv(model, params, p), True, window,
            f"layer 0 of prefill {(b, s)}")
        out["prefill"].append(dict(
            shape=[b, s], window=window, first_s=first_s,
            steady_s=steady_s, tok_per_s=b * s / steady_s, dot_s=dot_s,
            max_abs_dlogit_vs_dot=diff, min_top2_gap=gap,
            layer0_max_abs_err=l0_err, layer0_out_rms=l0_rms,
            layer0_beyond_bar_without_window=l0_moved))
        log(f"[serve] prefill {(b, s)} through the kernel: first call "
            f"{first_s:.4f} s, again {steady_s:.4f} s "
            f"({b * s / steady_s:,.0f} tokens/s); through dot "
            f"{dot_s:.4f} s; max |dlogit| kernel vs dot {diff:.4g}, argmax "
            f"equal (smallest top-2 gap {gap:.4g})")
        log(f"[serve] layer 0 of prefill {(b, s)}: kernel vs plain on the "
            f"model's q, k, v: max abs err {l0_err:.3g} (output RMS "
            f"{l0_rms:.3g}, bar {FLASH_TOL[torch.bfloat16]})"
            + ("" if l0_moved is None else f"; without the window "
               f"{l0_moved} elements fall beyond the bar"))
        torch.cuda.empty_cache()

    # serve.generate: a (4, 64) prompt through decode_step, 32 greedy
    b, s, n_gen = 4, 64, 32
    prompt = torch.randint(0, cfg.vocab_size, (b, s), device=dev,
                           generator=gen)
    generate(model, params, prompt[:, :2], 2, 4)          # warm-up
    toks, gen_s = _timed(lambda: generate(model, params, prompt, n_gen,
                                          s + n_gen))
    steps = s + n_gen
    if toks.shape != (b, n_gen) or not bool(
            ((toks >= 0) & (toks < cfg.vocab_size)).all()):
        raise AssertionError(f"generate gave {tuple(toks.shape)} tokens "
                             f"out of range")
    # JAX's serving invariant: generate's token-by-token pass over the
    # prompt (decode_step from an empty cache) reaches prefill's logits
    cache = model.init_cache(b, s + n_gen, device=dev)
    for i in range(s):
        dec, cache = model.decode_step(params, cache, {
            "token": prompt[:, i:i + 1],
            "pos": torch.full((b,), i, device=dev)})
    before = fa.launches
    pre = model.prefill(params, {"tokens": prompt})
    if fa.launches != before + cfg.num_layers:
        raise AssertionError("the (4, 64) prefill did not launch the "
                             "kernel once per layer")
    diff, gap = _logit_gap(dec, pre, "decode vs prefill at the prompt's "
                           "last token")
    if not torch.equal(toks[:, 0], dec[:, 0].argmax(-1)):
        raise AssertionError("generate's first token is not the argmax of "
                             "the decode pass's logits")
    out["generate"] = dict(batch=b, prompt=s, gen=n_gen, wall_s=gen_s,
                           decode_steps=steps,
                           ms_per_decode_step=gen_s / steps * 1e3,
                           max_abs_dlogit_decode_vs_prefill=diff,
                           min_top2_gap=gap)
    log(f"[serve] generate {(b, s)} + {n_gen} greedy tokens: {gen_s:.3f} s,"
        f" {steps} decode steps, {gen_s / steps * 1e3:.3f} ms per step "
        f"(host clock); decode vs prefill at the prompt's last token: max "
        f"|dlogit| {diff:.4g}, argmax equal (smallest top-2 gap {gap:.4g})")
    report["serve"] = out
    return launches, model, params


def ssm_flops(b, l, h, dk, dv, chunk, variant):
    """Flops of one chunked-GLA call: per chunk and head, the live
    (query, key) pairs (C(C-1)/2 for rwkv, C(C+1)/2 for mamba) x
    (2 Dk + 2 Dv), plus 4 C Dk Dv for the state's readout and update;
    the last chunk counts its own rows only."""
    total = 0
    for n0 in range(0, l, chunk):
        c = min(chunk, l - n0)
        pairs = c * (c - 1) // 2 + (c if variant == "mamba" else 0)
        total += pairs * (2 * dk + 2 * dv) + 4 * c * dk * dv
    return total * b * h


def ssm_kernel_macs(b, l, h, dk, dv, chunk, v_bf16):
    """TF32 multiply-adds the kernels issue for one call (whole chunks):
    the readout and the state update in 3xTF32 (2 products for the update
    when v is bf16), the 16 x 16 score blocks on and below the diagonal
    and att . v with every product exact (6 products; 3 for att . v when
    v is bf16)."""
    blocks = (chunk // 16) * (chunk // 16 + 1) // 2
    per_chunk = (3 * chunk * dk * dv + (2 if v_bf16 else 3) * chunk * dk * dv
                 + blocks * 256 * (6 * dk + (3 if v_bf16 else 6) * dv))
    return per_chunk * b * h * -(-l // chunk)


def ssm_inputs(b, l, h, d, regime, dtype, gen):
    """q, k, v in ``dtype`` (std 1), log_w fp32 in one of three regimes:
    "init" (-softplus(N(0, 4e-4)), rwkv6's decay at JAX's init, ~ln 2 a
    step), "abs" (-|N(0, 1)|) or "strong" (-8 + N(0, 0.25): a 16-row
    block decays by ~128, past the factored diagonal's span); bonus and a
    nonzero initial state."""
    dev = torch.device("cuda")
    q, k, v = (torch.randn(b, l, h, d, device=dev, generator=gen).to(dtype)
               for _ in range(3))
    z = torch.randn(b, l, h, d, device=dev, generator=gen)
    lw = {"init": lambda: -torch.nn.functional.softplus(z * 4e-4),
          "abs": lambda: -z.abs(),
          "strong": lambda: -8.0 + 0.5 * z}[regime]()
    bonus = torch.randn(h, d, device=dev, generator=gen)
    s0 = torch.randn(b, h, d, d, device=dev, generator=gen)
    return q, k, v, lw, bonus, s0


def _over(out, ref, tol):
    """The largest |out - ref| over its bar atol + rtol |ref|."""
    d = (out.float() - ref.float()).abs()
    return float((d / (tol["atol"] + tol["rtol"] * ref.float().abs())).max())


def check_ssm(ss, q, k, v, lw, chunk, variant, bonus, s0, what):
    """The kernels against their plain version on the same inputs, and
    against the plain version with its products summed in float64 from
    the same fp32 factors (``gla_chunked_float64_sums``): against each, y
    within SSM_TOL of its dtype and the final state within SSM_STATE_TOL,
    all finite.  Returns the errors against the plain version (max abs of
    y and of the state, the largest over the bar), the largest over the
    bar against float64 sums, the plain version's own there, and y's
    RMS."""
    y, s = ss.gla_chunked(q, k, v, lw, chunk=chunk, variant=variant,
                          bonus=bonus, initial_state=s0)
    torch.cuda.synchronize()
    kw = dict(chunk=chunk, variant=variant, bonus=bonus, initial_state=s0)
    py, ps = ss.gla_chunked_plain(q, k, v, lw, **kw)
    xy, xs = ss.gla_chunked_float64_sums(q, k, v, lw, **kw)
    tol = SSM_TOL[v.dtype]
    finite = bool(torch.isfinite(y).all() and torch.isfinite(s).all())
    for name, ry, rs in (("the plain version", py, ps),
                         ("the plain version's float64 sums", xy, xs)):
        if y.dtype != v.dtype or not finite \
                or not torch.allclose(y.float(), ry.float(), **tol) \
                or not torch.allclose(s, rs, **SSM_STATE_TOL):
            raise AssertionError(
                f"ssm_scan {what} against {name}: y max abs err "
                f"{float((y.float() - ry.float()).abs().max())} (largest "
                f"error {_over(y, ry, tol):.3g} x the bar {tol}, "
                f"{_beyond(y, ry, tol)} elements beyond), state max abs "
                f"err {float((s - rs).abs().max())} (bar {SSM_STATE_TOL}, "
                f"{_beyond(s, rs, SSM_STATE_TOL)} beyond), finite {finite}")
    return dict(max_abs_err=float((y.float() - py.float()).abs().max()),
                state_max_abs_err=float((s - ps).abs().max()),
                err_over_bar=_over(y, py, tol),
                err_over_bar_vs_float64_sums=_over(y, xy, tol),
                plain_over_bar_vs_float64_sums=_over(py, xy, tol),
                y_rms=float(py.float().square().mean().sqrt()))


def ssm_note(c, tol):
    return (f"against the plain version y max abs err {c['max_abs_err']:.3g}"
            f" ({c['err_over_bar']:.3g} of the bar {tol}, y RMS "
            f"{c['y_rms']:.3g}), state {c['state_max_abs_err']:.3g}; "
            f"against its float64 sums {c['err_over_bar_vs_float64_sums']:.3g}"
            f" of the bar (the plain version "
            f"{c['plain_over_bar_vs_float64_sums']:.3g})")


def ssm_device_us(ss, run, calls=5, windows=3):
    """Device microseconds a call of each ssm_scan kernel, from a profiler
    window over ``calls`` calls, which must hold each of SSM_KERNELS
    exactly ``calls`` times and nothing else of ssm_scan (the count the
    wrapper keeps is checked against SSM_KERNELS too).  A window that
    lost a record is taken again, up to ``windows`` times."""
    from torch.profiler import ProfilerActivity, profile
    run()
    torch.cuda.synchronize()
    for _ in range(windows):
        before = ss.gla_chunked.launches
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                run()
            torch.cuda.synchronize()
        counted = ss.gla_chunked.launches - before
        us, seen = {}, {}
        for e in prof.key_averages():
            name = re.search(r"(ssm_\w+)", e.key)
            if e.device_type == torch.autograd.DeviceType.CUDA and name:
                us[name.group(1)] = e.self_device_time_total / calls
                seen[name.group(1)] = seen.get(name.group(1), 0) + e.count
        if counted != calls * len(SSM_KERNELS) \
                or set(seen) - set(SSM_KERNELS) \
                or any(n > calls for n in seen.values()):
            raise AssertionError(f"ssm_scan: {calls} calls counted "
                                 f"{counted} launches in the wrapper and "
                                 f"{seen} in the profiler, not {calls} of "
                                 f"each of {SSM_KERNELS}")
        if seen == {name: calls for name in SSM_KERNELS}:
            return us
    raise AssertionError(f"ssm_scan: the profiler saw {seen} in {calls} "
                         f"calls, not {calls} of each of {SSM_KERNELS}")


def phase_ssm(ss, report):
    """``ssm_scan`` against its plain version on the card: the rwkv serve
    path's two prefill shapes (32 heads of 64, chunk 128) and a ragged
    L = 300, both variants, three decay regimes, bf16 r/k/v with fp32
    log_w (the model's) and all fp32, with bonus and a nonzero initial
    state; timed at the serve shapes (rwkv, bf16, init decay) with each
    kernel's device time; and the kernel against the fp32 token-by-token
    recurrence at (1, 512)."""
    from repro_torch.nn.linear_attn import gla_decode
    gen = torch.Generator(device="cuda").manual_seed(0)
    h, d, chunk = 32, 64, 128
    rows = []
    for b, l in RWKV_PREFILLS + [(2, 300)]:
        for variant in ("rwkv", "mamba"):
            for regime in SSM_REGIMES:
                for dt in (torch.bfloat16, torch.float32):
                    x = ssm_inputs(b, l, h, d, regime, dt, gen)
                    dtype = str(dt).replace("torch.", "")
                    what = (f"({b}, {l}, {h}, {d}) {variant} {regime} "
                            f"{dtype}")
                    c = check_ssm(ss, *x[:4], chunk, variant, *x[4:], what)
                    row = dict(shape=[b, l, h, d], variant=variant,
                               regime=regime, dtype=dtype, **c)
                    note = ssm_note(c, SSM_TOL[dt])
                    timed = (variant == "rwkv" and regime == "init"
                             and dt == torch.bfloat16 and l > 300)
                    if timed:
                        q, k, v, lw, bonus, s0 = x
                        flops = ssm_flops(b, l, h, d, d, chunk, variant)
                        # q, k, v in, y out in their dtype; log_w fp32
                        # in; the state in and out fp32
                        nbytes = (q.numel() * (4 * q.element_size() + 4)
                                  + 2 * 4 * b * h * d * d)
                        # the function's work at the TF32 peak; beside it
                        # the 3xTF32 split's products, the products the
                        # kernels issue, and the fp32-FMA bound
                        b_ms, b_by = bound(nbytes, flops, PEAK_TF32_PER_S)
                        fma_ms, _ = bound(nbytes, flops)
                        macs = ssm_kernel_macs(b, l, h, d, d, chunk, True)
                        run = lambda: ss.gla_chunked(  # noqa: E731
                            q, k, v, lw, chunk=chunk, variant="rwkv",
                            bonus=bonus, initial_state=s0)
                        plain = lambda: ss.gla_chunked_plain(  # noqa: E731
                            q, k, v, lw, chunk=chunk, variant="rwkv",
                            bonus=bonus, initial_state=s0)
                        row.update(flops=flops, bytes=nbytes,
                                   ms=cuda_ms(run, 10),
                                   plain_ms=cuda_ms(plain, 2),
                                   library_ms=None, bound_ms=b_ms,
                                   bound_by=b_by, fp32_fma_bound_ms=fma_ms,
                                   split_products_ms=(
                                       3 * flops / PEAK_TF32_PER_S * 1e3),
                                   kernel_products_ms=(
                                       2 * macs / PEAK_TF32_PER_S * 1e3),
                                   device_us=ssm_device_us(ss, run))
                        parts = ", ".join(f"{k_} {v_:.1f}" for k_, v_ in
                                          row["device_us"].items())
                        log(f"[kernels] ssm_scan {row['shape']} rwkv bf16 "
                            f"init: {row['ms']:.4f} ms kernels, "
                            f"{row['plain_ms']:.4f} ms plain, library none, "
                            f"bound {b_ms:.4f} ms ({b_by}; the 3xTF32 "
                            f"split's products {row['split_products_ms']:.4f}"
                            f" ms, the kernels' products "
                            f"{row['kernel_products_ms']:.4f} ms at the TF32 "
                            f"peak, fp32-FMA bound {fma_ms:.4f} ms); device "
                            f"us a call: {parts}; {note}")
                    else:
                        log(f"[kernels] ssm_scan {what}: {note}")
                    rows.append(row)
                    del x
        torch.cuda.empty_cache()
    rows.sort(key=lambda r: "ms" not in r)       # the timed rows first

    # against JAX's fp32 recurrence, step by step, at rwkv6's init decay
    for variant in ("rwkv", "mamba"):
        q, k, v, lw, bonus, _ = ssm_inputs(1, 512, h, d, "init",
                                           torch.float32, gen)
        y, s = ss.gla_chunked(q, k, v, lw, chunk=chunk, variant=variant,
                              bonus=bonus)
        st = torch.zeros(1, h, d, d, device=q.device)
        ys = []
        for t in range(512):
            yt, st = gla_decode(q[:, t], k[:, t], v[:, t], lw[:, t], st,
                                variant=variant, bonus=bonus)
            ys.append(yt)
        ref = torch.stack(ys, 1)
        err = float((y - ref).abs().max())
        if not (torch.isfinite(y).all() and torch.allclose(y, ref, **RECUR_TOL)
                and torch.allclose(s, st, **RECUR_TOL)):
            raise AssertionError(f"ssm_scan {variant} against the fp32 "
                                 f"recurrence at (1, 512): max abs err "
                                 f"{err} beyond {RECUR_TOL}")
        log(f"[kernels] ssm_scan (1, 512, {h}, {d}) {variant} init, fp32: "
            f"against the token-by-token recurrence max abs err {err:.3g} "
            f"(y RMS {float(ref.square().mean().sqrt()):.3g}, bar "
            f"{RECUR_TOL}); every output finite")
        report.setdefault("ssm_scan_vs_recurrence", []).append(dict(
            shape=[1, 512, h, d], variant=variant, regime="init",
            dtype="float32", max_abs_err=err))
    return rows


def phase_guard(ac, dg, fa, ss):
    """No kernel wrapper hands autograd an output it cannot differentiate:
    with grad enabled, each raises for a CUDA input that requires grad;
    under ``torch.no_grad()`` each computes."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    r = lambda *shape: torch.randn(*shape, device=dev,  # noqa: E731
                                   generator=gen)
    preds = torch.randint(0, 4, (6, 300), device=dev, dtype=torch.int32,
                          generator=gen)
    qkv = [r(1, 64, 4, 64).to(torch.bfloat16) for _ in range(3)]
    calls = {
        "alpha_combine": lambda g: ac.alpha_combine(
            r(5, 1000).requires_grad_(g), r(5, 3).abs()),
        "disagreement_counts": lambda g: dg.disagreement_counts(
            preds, torch.ones(300, device=dev).requires_grad_(g)),
        "disagreement": lambda g: dg.disagreement(
            preds, torch.ones(300, device=dev).requires_grad_(g)),
        "flash_attention": lambda g: fa.flash_attention(
            qkv[0].clone().requires_grad_(g), qkv[1], qkv[2]),
        "ssm_scan": lambda g: ss.gla_chunked(
            qkv[0], qkv[1], qkv[2].clone().requires_grad_(g),
            -r(1, 64, 4, 64).abs(), chunk=32, variant="rwkv",
            bonus=r(4, 64)),
    }
    for name, call in calls.items():
        try:
            call(True)
        except RuntimeError as e:
            if "requires grad" not in str(e):
                raise
        else:
            raise AssertionError(f"{name}: a CUDA input requiring grad, "
                                 f"with grad enabled, did not raise")
        with torch.no_grad():
            call(True)
        call(False)
    torch.cuda.synchronize()
    log(f"[guard] {sorted(calls)}: each raises for a CUDA input that "
        f"requires grad with grad enabled, and computes under no_grad and "
        f"without grad")


def _decode_gap(dec, pre, what):
    """Decode's last-token logits against prefill's: within LM_TOL, and
    argmax equal in every row whose top-2 gap exceeds twice the measured
    max |dlogit|.  Returns (max |dlogit|, smallest top-2 gap, rows held
    to argmax equality)."""
    dec, pre = dec.float(), pre.float()
    diff = float((dec - pre).abs().max())
    top2 = pre.topk(2, dim=-1).values
    gaps = (top2[..., 0] - top2[..., 1]).flatten()
    held = gaps > 2 * diff
    same = (dec.argmax(-1) == pre.argmax(-1)).flatten()
    if not (torch.isfinite(dec).all() and torch.allclose(dec, pre, **LM_TOL)
            and bool(same[held].all())):
        raise AssertionError(f"{what}: max |dlogit| {diff:.4g} (tolerance "
                             f"{LM_TOL}), argmax equal {same.tolist()}, "
                             f"top-2 gaps {gaps.tolist()}")
    return diff, float(gaps.min()), int(held.sum())


def rwkv_layer0(model, params, tokens):
    """Layer 0's r, k, v, log_w and bonus as ``RWKVModel.prefill`` hands
    them to the scan: the prompt's embedding, rmsnorms, token shift from
    a zero state, projections."""
    from repro_torch.models.common import take_layer
    from repro_torch.nn import rwkv
    from repro_torch.nn.layers import rmsnorm
    cfg = model.cfg
    p = take_layer(params["layers"], 0)
    x = rmsnorm(model._embed(params, tokens), p["ln1"], cfg.norm_eps)
    r, k, v, _, log_w = rwkv._rkvgw(
        p["att"], x, rwkv._shift(x, torch.zeros_like(x[:, 0])),
        cfg.num_heads, cfg.resolved_head_dim(), torch.bfloat16)
    return r, k, v, log_w, p["att"]["bonus"]


def phase_serve_rwkv(counted, report):
    """rwkv6-1.6b at full width and depth through the port's serving entry
    points: ``RWKVModel.prefill`` (counted: 24 ``ssm_scan`` launches
    each), ``serve.generate``, JAX's prefill/decode invariant at (4, 64)
    and (2, 300), and the kernel against its plain version on layer 0's
    own inputs of both counted prompts."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.ssm_scan import ops as ss_ops
    from repro_torch.launch.serve import generate
    from repro_torch.models.api import build_model
    from repro_torch.nn.param import count_params

    ss = counted["ssm_scan"]
    dev = torch.device("cuda")
    cfg = get_config(RWKV_ARCH)
    model = build_model(cfg)
    params, init_s = _timed(lambda: model.init(
        torch.Generator(device=dev).manual_seed(0), device=dev))
    n_params = count_params(params)
    log(f"[serve-rwkv] {cfg.name}: {n_params:,} parameters (float32, drawn "
        f"on the card from seed 0) in {init_s:.3f} s; {cfg.num_layers} "
        f"layers, d_model {cfg.d_model}, {cfg.num_heads} heads of "
        f"{cfg.resolved_head_dim()}, chunk {cfg.ssm.chunk}; compute dtype "
        f"{cfg.dtype}")
    gen = torch.Generator(device=dev).manual_seed(1)
    prompts = [torch.randint(0, cfg.vocab_size, shape, device=dev,
                             generator=gen) for shape in RWKV_PREFILLS]

    # the main path: two full-width prefills through the kernels, counted
    # (kernels a call x a call a layer)
    per_call = len(SSM_KERNELS)
    zero_counts(counted)
    first = [_timed(lambda p=p: model.prefill(params, {"tokens": p}))
             for p in prompts]
    launches = read_counts(counted)
    log(f"[serve-rwkv] launches in the serve path: {launches} ({per_call} "
        f"ssm_scan kernels a call)")
    if launches["ssm_scan"] != 2 * per_call * cfg.num_layers:
        raise AssertionError(f"ssm_scan launched {launches['ssm_scan']} "
                             f"kernels in two prefills, not "
                             f"{2 * per_call * cfg.num_layers}")
    out = dict(params=n_params, init_s=init_s, launches=launches,
               prefill=[])
    for (b, s), p, (logits, first_s) in zip(RWKV_PREFILLS, prompts, first):
        if logits.shape != (b, 1, cfg.vocab_size) \
                or not torch.isfinite(logits).all():
            raise AssertionError(
                f"prefill logits {tuple(logits.shape)}, finite "
                f"{bool(torch.isfinite(logits).all())}")
        before = ss.launches
        torch.cuda.reset_peak_memory_stats()
        again, steady_s = _timed(lambda: model.prefill(params,
                                                       {"tokens": p}))
        peak = torch.cuda.max_memory_allocated()
        if ss.launches != before + per_call * cfg.num_layers:
            raise AssertionError("a later prefill did not launch the "
                                 "kernels once per layer")
        if not torch.equal(again, logits):
            raise AssertionError(f"prefill {(b, s)} is not deterministic")
        r, k, v, lw, bonus = rwkv_layer0(model, params, p)
        l0 = check_ssm(ss_ops, r, k, v, lw, cfg.ssm.chunk, "rwkv", bonus,
                       None, f"layer 0 of prefill {(b, s)}")
        del r, k, v, lw
        out["prefill"].append(dict(
            shape=[b, s], first_s=first_s, steady_s=steady_s,
            tok_per_s=b * s / steady_s, peak_gb=peak / 1e9,
            **{f"layer0_{k_}": v_ for k_, v_ in l0.items()}))
        log(f"[serve-rwkv] prefill {(b, s)}: first call {first_s:.4f} s, "
            f"again {steady_s:.4f} s ({b * s / steady_s:,.0f} tokens/s), "
            f"peak memory {peak / 1e9:.2f} GB")
        log(f"[serve-rwkv] layer 0 of prefill {(b, s)}: kernel vs plain on "
            f"the model's r, k, v, log_w: "
            f"{ssm_note(l0, SSM_TOL[torch.bfloat16])}")
        torch.cuda.empty_cache()

    # serve.generate: a (4, 64) prompt through decode_step, 32 greedy
    b, s, n_gen = 4, 64, 32
    prompt = torch.randint(0, cfg.vocab_size, (b, s), device=dev,
                           generator=gen)
    generate(model, params, prompt[:, :2], 2, 4)          # warm-up
    toks, gen_s = _timed(lambda: generate(model, params, prompt, n_gen,
                                          s + n_gen))
    steps = s + n_gen
    if toks.shape != (b, n_gen) or not bool(
            ((toks >= 0) & (toks < cfg.vocab_size)).all()):
        raise AssertionError(f"generate gave {tuple(toks.shape)} tokens "
                             f"out of range")
    out["generate"] = dict(batch=b, prompt=s, gen=n_gen, wall_s=gen_s,
                           decode_steps=steps,
                           ms_per_decode_step=gen_s / steps * 1e3)
    log(f"[serve-rwkv] generate {(b, s)} + {n_gen} greedy tokens: "
        f"{gen_s:.3f} s, {steps} decode steps, {gen_s / steps * 1e3:.3f} ms "
        f"per step (host clock)")

    # JAX's serving invariant: decode_step token by token from the zero
    # state reaches prefill's last-token logits; (4, 64) is one padded
    # chunk, (2, 300) crosses two chunk boundaries with a ragged tail
    out["decode_vs_prefill"] = []
    for b, s in ((4, 64), (2, 300)):
        prompt = prompt if (b, s) == (4, 64) else torch.randint(
            0, cfg.vocab_size, (b, s), device=dev, generator=gen)
        cache = model.init_cache(b, s, device=dev)
        for i in range(s):
            dec, cache = model.decode_step(params, cache, {
                "token": prompt[:, i:i + 1],
                "pos": torch.full((b,), i, device=dev)})
        pre = model.prefill(params, {"tokens": prompt})
        diff, gap, held = _decode_gap(dec, pre, f"decode vs prefill {(b, s)}")
        if (b, s) == (4, 64) and not torch.equal(toks[:, 0],
                                                  dec[:, 0].argmax(-1)):
            raise AssertionError("generate's first token is not the argmax "
                                 "of the decode pass's logits")
        out["decode_vs_prefill"].append(dict(
            shape=[b, s], max_abs_dlogit=diff, min_top2_gap=gap,
            rows_held_to_argmax=held))
        log(f"[serve-rwkv] decode vs prefill {(b, s)} at the prompt's last "
            f"token: max |dlogit| {diff:.4g} (bar {LM_TOL}), smallest top-2 "
            f"gap {gap:.4g}; argmax equal in the {held} of {b} rows whose "
            f"gap exceeds twice it")
    report["serve_rwkv"] = out
    return launches, model, params


def phase_main_path(ac, dg, counted, report):
    """The paper pipeline at full size through the port's entry points;
    ``counted`` maps every kernel's name to its wrapper."""
    from repro_torch.data import build_network
    from repro_torch.fl import pairwise_disagreement, prepare_round, run_stlf

    devices = build_network("M//MM", num_devices=10, samples_per_device=250,
                            seed=0)
    zero_counts(counted)
    t0 = time.perf_counter()
    state = prepare_round(devices, 0, train_iters=300, div_tau=4, div_T=25)
    t1 = time.perf_counter()
    hyp = pairwise_disagreement(state.params, state.clients).cpu().numpy()
    t2 = time.perf_counter()
    stlf = run_stlf(state)
    t3 = time.perf_counter()
    launches = read_counts(counted)
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
    for name in ("alpha_combine", "disagreement"):
        if launches[name] < 1:
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
    # (a CUDA tensor divided by a Python number is multiplied by its
    # reciprocal; by a tensor, divided: the kernel divides, as JAX does)
    m_t = torch.tensor(float(preds.shape[1]), device=preds.device)
    if not torch.equal(dg.disagreement(preds), plain / m_t):
        raise AssertionError("disagreement() on trained predictions is not "
                             "counts / M bit for bit")
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


def _cpu_copy(state):
    """The RoundState's clients and parameters on the CPU."""
    c = state.clients
    clients = type(c)(**{f.name: getattr(c, f.name).cpu()
                         for f in dataclasses.fields(c)})
    return clients, {k: v.cpu() for k, v in state.params.items()}


def phase_baselines(ac, counted, state, stlf, report):
    """The paper's comparison matrix (``run_all_baselines``) on the main
    path's full-size state, counted: ``alpha_combine`` runs once a method
    (each ``evaluate_assignment`` mixes the 10 devices in one call);
    FADA's columns sum to one at its targets; its gaps and weights, held
    against the port on the CPU on the same draws, agree within the bars
    below, and a planted fault (half the learning rate) breaks both."""
    from repro_torch.fl import baselines as bl
    from repro_torch.fl import cnn, run_all_baselines
    from repro_torch.fl.divergence import pair_draws
    from repro_torch.fl.round import column_normalize
    from repro_torch.rng import split_seed

    zero_counts(counted)
    t0 = time.perf_counter()
    res = run_all_baselines(state, stlf, 1)
    wall = time.perf_counter() - t0
    launches = read_counts(counted)
    # FADA's two calls again, alone, on the matrix's inputs and seeds
    fada_s = []
    for name, seed in zip(("FADA", "psi-FADA"), split_seed(1, 2)):
        t0 = time.perf_counter()             # returns numpy: synchronized
        again = bl.fada_alpha(res[name].psi, state.params, state.clients,
                              seed)
        fada_s.append(time.perf_counter() - t0)
        again = column_normalize(again, res[name].psi,
                                 energy_K=state.energy.K,
                                 eps_hat=state.eps_hat)
        if not np.array_equal(again, res[name].alpha):
            raise AssertionError(f"{name}: alpha differs between two calls "
                                 f"on the same inputs")
    n = len(stlf.psi)
    want = len(res) * ac._plan(n, n)[0]
    for name, r in res.items():
        log(f"[baselines] {name}: target_acc={r.target_acc:.4f} "
            f"energy={r.energy:.6f} transmissions={r.transmissions} "
            f"psi={r.psi.astype(int).tolist()}")
    log(f"[baselines] matrix wall {wall:.3f} s, FADA's two calls timed "
        f"alone {sum(fada_s):.3f} s ({sum(fada_s) / wall:.1%}); launches "
        f"{launches} (alpha_combine: {want} wanted, one a method at "
        f"T = {n})")
    if launches["alpha_combine"] != want or any(
            v for k, v in launches.items() if k != "alpha_combine"):
        raise AssertionError(f"baselines: launches {launches}, "
                             f"alpha_combine should be {want}")
    for name in ("FADA", "psi-FADA"):
        r = res[name]
        tg = r.psi == 1.0
        if not (tg.any() and np.allclose(r.alpha[:, tg].sum(0), 1.0)
                and np.isfinite(r.alpha).all() and np.isfinite(r.energy)
                and np.isfinite(r.per_device_acc).all()):
            raise AssertionError(f"{name}: alpha columns, accuracies or "
                                 f"energy invalid")

    # FADA's gaps on the card against the CPU port, on the same draws
    srcs, tgts = np.flatnonzero(stlf.psi == 0), np.flatnonzero(stlf.psi == 1)
    si, ti = (a.ravel() for a in np.meshgrid(srcs, tgts, indexing="ij"))
    counts = state.clients.counts.cpu().numpy()
    draws = pair_draws(split_seed(3, len(si)), counts[si], counts[ti],
                       steps=FADA_KW["iters"], batch=FADA_KW["batch"])
    runs = {}
    clients, params = _cpu_copy(state)
    for dev, c, p, kw in (
            ("cuda", state.clients, state.params, FADA_KW),
            ("cpu", clients, params, FADA_KW),
            ("fault", state.clients, state.params,
             dict(FADA_KW, lr=FADA_KW["lr"] / 2))):
        g, w, b = bl._domain_gap(p, c, si, ti, draws=draws, **kw)
        runs[dev] = (g.cpu().numpy(), w.cpu(), b.cpu())
    with torch.no_grad():                       # the sources' own rows
        feats = {dev: cnn._features_stacked(
            {k: v[torch.as_tensor(srcs, device=c.x.device)]
             for k, v in p.items()},
            c.x[torch.as_tensor(srcs, device=c.x.device)]).cpu()
            for dev, c, p in (("cuda", state.clients, state.params),
                              ("cpu", clients, params))}
    row = 4.0 / (counts[si] + counts[ti])       # one row of each pair's gap
    ref_g, ref_w, _ = runs["cpu"]

    def apart(dev):
        """(largest gap move in rows of its pair, max |dw| / max |w|)."""
        g, w, _ = runs[dev]
        return (float((np.abs(g - ref_g) / row).max()),
                float((w - ref_w).abs().max() / ref_w.abs().max()))

    seen = {dev: apart(dev) for dev in ("cuda", "fault")}
    feat_rel = float((feats["cuda"] - feats["cpu"]).abs().max()
                     / feats["cpu"].abs().max())
    for dev, what in (("cuda", "GPU vs CPU"),
                      ("fault", "planted fault (lr / 2) on the GPU vs CPU")):
        log(f"[baselines] FADA {what}, {len(si)} pairs on the same draws: "
            f"gaps {seen[dev][0]:.4g} rows apart at most (bar "
            f"{FADA_GAP_ROWS} rows), w {seen[dev][1]:.3g} of max |w| (bar "
            f"{FADA_W_TOL})")
    log(f"[baselines] FADA features GPU vs CPU: {feat_rel:.3g} of the "
        f"largest entry; gaps {np.round(runs['cuda'][0], 4).tolist()}")
    if not (np.isfinite(runs["cuda"][0]).all()
            and seen["cuda"][0] <= FADA_GAP_ROWS
            and seen["cuda"][1] <= FADA_W_TOL):
        raise AssertionError("FADA: the card's discriminators differ from "
                             "the CPU port's")
    if not (seen["fault"][0] > FADA_GAP_ROWS
            and seen["fault"][1] > FADA_W_TOL):
        raise AssertionError("FADA: the bars do not see a planted fault")
    report["baselines"] = dict(
        wall_s=wall, fada_s=fada_s, launches=launches,
        methods={k: dict(target_acc=r.target_acc, energy=r.energy,
                         transmissions=r.transmissions,
                         psi=r.psi.tolist()) for k, r in res.items()},
        fada_gpu_vs_cpu=dict(gap_rows=seen["cuda"][0], w_rel=seen["cuda"][1],
                             features_rel=feat_rel),
        fada_fault_lr_half=dict(gap_rows=seen["fault"][0],
                                w_rel=seen["fault"][1]))


def phase_sim(ac, counted, report, dev="cuda", runs=SIM_RUNS):
    """The simulator's sync path through its CLI's run
    (``repro_torch.sim.run.simulate``, what ``main`` runs) with
    ``--trace``, counted: every
    round's transfer launches ``alpha_combine`` (the kernels
    ``alpha_combine_plan`` gives for the pool), and nothing else does;
    then the kernel against its plain version on the last round's
    transfer: the round's alpha on the final parameters (the targets'
    rows, the only ones the mixture replaced, carry zero weight).
    Prints each round's phases from the trace fields and the solves'
    inner steps from the trace events."""
    from repro_torch.nn.param import flatten_to_vector
    from repro_torch.sim import run as sim_run
    from repro_torch.sim.metrics import RoundRecord, read_jsonl

    out_dir = ROOT / "build" / "sim"
    fields = [f.name for f in dataclasses.fields(RoundRecord)]
    out, engines = {}, {}
    for scenario, n, rounds in runs:
        tag = f"{scenario}-n{n}-r{rounds}"
        log_path, trace_path = out_dir / f"{tag}.jsonl", \
            out_dir / f"{tag}.trace.jsonl"
        zero_counts(counted)
        t0 = time.perf_counter()
        eng, _ = sim_run.simulate([
            "--scenario", scenario, "--devices", str(n), "--rounds",
            str(rounds), "--out", str(log_path), "--trace-out",
            str(trace_path), "--quiet", "--device", dev])
        wall = time.perf_counter() - t0
        launches = read_counts(counted)
        rows = read_jsonl(str(log_path))
        events = [json.loads(ln) for ln in open(trace_path)]
        theta, alpha = eng.state.params, eng.state.alpha
        engines[tag] = eng
        pool = len(alpha)
        per_call = ac._plan(pool, pool)[0]
        want = rounds * per_call
        solves = [e for e in events if e["phase"] == "solve"]
        steps = sum(e["inner_steps"] for e in solves)
        solve_s = sum(e["seconds"] for e in solves)
        phases = {k: [r[k] for r in rows] for k in (
            "wall_time_s", "train_wall_s", "div_wall_s",
            "solver_wall_s", "transfer_wall_s", "eval_wall_s")}
        for r in rows:
            log(f"[sim] {tag} round {r['round']}: wall "
                f"{r['wall_time_s']:.3f} s (train {r['train_wall_s']:.3f},"
                f" divergence {r['div_wall_s']:.3f}, solve "
                f"{r['solver_wall_s']:.3f}, transfer "
                f"{r['transfer_wall_s']:.4f}, eval "
                f"{r['eval_wall_s']:.4f}); active {r['n_active']}, "
                f"sources {r['n_sources']}, targets {r['n_targets']}, "
                f"resolve {r['resolve_reason']} "
                f"({r['solver_iters']} outer), tgt_acc "
                f"{r['mean_target_acc']:.4f}, energy {r['energy']:.6f}, "
                f"events {r['events']}")
        log(f"[sim] {tag}: {wall:.3f} s in main, pool {pool}; "
            f"{len(solves)} re-solves, {steps} inner steps in "
            f"{solve_s:.3f} s: {solve_s / max(steps, 1) * 1e3:.3f} ms "
            f"per solver step; launches {launches} (alpha_combine: "
            f"{rounds} rounds x {per_call} = {want} wanted)")
        if launches["alpha_combine"] != want or any(
                v for k, v in launches.items() if k != "alpha_combine"):
            raise AssertionError(f"sim {tag}: launches {launches}, "
                                 f"alpha_combine should be {want}")
        if not (len(rows) == rounds
                and all(list(r) == fields for r in rows)
                and all(r["n_sources"] + r["n_targets"] == r["n_active"]
                        and np.isfinite(r["energy"])
                        and r["resolved"] == (r["resolve_reason"]
                                              is not None)
                        for r in rows)
                and rows[0]["resolve_reason"] == "cold"
                and all(r["train_wall_s"] > 0 for r in rows)):
            raise AssertionError(f"sim {tag}: rows malformed")
        # the kernel against its plain version on the last round's alpha
        flat = flatten_to_vector(theta, lead=1).contiguous()
        a = torch.as_tensor(alpha, dtype=torch.float32,
                            device=flat.device)
        kern = ac.alpha_combine(flat, a)
        plain = ac.alpha_combine_plain(flat, a)
        err = float((kern - plain).abs().max())
        log(f"[sim] {tag}: alpha_combine on the last round's transfer "
            f"({pool} x {pool}, P = {flat.shape[1]}) vs plain: max abs "
            f"err {err:.3g}")
        if not torch.allclose(kern, plain, rtol=1e-5, atol=1e-5):
            raise AssertionError(f"sim {tag}: alpha_combine differs "
                                 f"from its plain version by {err}")
        times = {}
        if flat.is_cuda:        # the wrapper at the round's own shape
            times = dict(
                ms=cuda_ms(lambda: ac.alpha_combine(flat, a), 50),
                plain_ms=cuda_ms(lambda: ac.alpha_combine_plain(flat, a),
                                 50),
                library_ms=cuda_ms(lambda: torch.matmul(a.t(), flat),
                                   50))
            times["bound_ms"], times["bound_by"] = bound(
                4 * (flat.numel() + a.numel() + pool * flat.shape[1]),
                2 * pool * pool * flat.shape[1])
            log(f"[sim] {tag}: alpha_combine {pool} x {pool} x "
                f"{flat.shape[1]}: " + ", ".join(
                    f"{k} {v:.4f}" if isinstance(v, float) else
                    f"{k} {v}" for k, v in times.items()))
        out[tag] = dict(wall_s=wall, pool=pool, launches=launches,
                        alpha_combine=times,
                        kernels_per_round=per_call, resolves=len(solves),
                        inner_steps=steps, solve_s=solve_s,
                        ms_per_solver_step=solve_s / max(steps, 1) * 1e3,
                        phases=phases, max_abs_err=err,
                        n_targets=[r["n_targets"] for r in rows])
    report["sim"] = out
    return out, engines


def phase_small_sim(report, devs=("cuda", "cpu")):
    """Small sync runs on the GPU against the port on the CPU (which the
    CPU tests hold against the JAX package), on the port's own seeds:
    the decisions equal, the floats within the bars below."""
    from repro_torch.sim import SimConfig, SimulationEngine
    out = {}
    for scenario, seed in SMALL_SIM:
        a, b = (SimulationEngine(
            SimConfig(scenario=scenario, seed=seed, **SMALL_SIM_CFG),
            device=dev).run() for dev in devs)
        if not any(r["n_targets"] for r in b):
            raise AssertionError(f"small sim {scenario}: no targets")
        worst = {}
        for ra, rb in zip(a, b):
            for k in SIM_DECISIONS:
                if ra[k] != rb[k]:
                    raise AssertionError(
                        f"small sim {scenario} round {ra['round']}: {k} "
                        f"{ra[k]} on the GPU, {rb[k]} on the CPU")
            # an accuracy may move by one prediction of a 40-row device;
            # the rest are float32 noise through the solver (rtol 1e-3)
            for k, tol in (("mean_target_acc", 1.0 / 40),
                           ("mean_source_acc", 1.0 / 40)):
                d = abs(ra[k] - rb[k]) if np.isfinite(rb[k]) else 0.0
                if not (np.isnan(ra[k]) == np.isnan(rb[k]) and d <= tol):
                    raise AssertionError(f"small sim {scenario}: {k}")
                worst[k] = max(worst.get(k, 0.0), d)
            for k in ("drift", "energy", "energy_cum", "link_churn"):
                d = abs(ra[k] - rb[k])
                if d > 1e-3 * abs(rb[k]) + 1e-6:
                    raise AssertionError(f"small sim {scenario} round "
                                         f"{ra['round']}: {k} {ra[k]} vs "
                                         f"{rb[k]}")
                worst[k] = max(worst.get(k, 0.0), d)
        log(f"[small] sim {scenario} (seed {seed}, {len(a)} rounds): "
            f"decisions equal on GPU and CPU "
            f"(targets {[r['n_targets'] for r in a]}); max |d| "
            + ", ".join(f"{k} {v:.3g}" for k, v in worst.items()))
        out[scenario] = worst
    report["small_sim"] = out


def phase_profile(state, stlf, lm, rwkv_lm, sim_engines, report):
    """``--profile`` only: torch.profiler over short windows of each phase
    on the main path's state, of the two serve paths (``lm`` and
    ``rwkv_lm`` = model, params) and of one more round of each simulator
    run of ``[sim]`` (its engine carried on: a drift round re-solves warm
    at the run's own settings); the device's busy share of each window
    (kernel time summed over wall time) and its top kernels."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.problem import STLFProblem
    from repro_torch.core.solver import solve_stlf
    from repro_torch.fl import evaluate_assignment, train_local

    from repro_torch.kernels.alpha_combine import ops as ac
    from repro_torch.kernels.disagreement import ops as dg

    prob = STLFProblem(state.bounds, state.energy)
    dev = torch.device("cuda")
    windows = {}
    # launches and device time a call of each ST-LF kernel's wrappers, at
    # the main path's shapes (x20) and the simulator's scale (x5)
    for (s, p, n, m), calls in [((10, 48158, 10, 2500), 20),
                                ((256, 48158, 256, 64000), 5)]:
        theta = torch.randn(s, p, device=dev)
        alpha = torch.rand(s, s, device=dev)
        preds = torch.randint(0, 10, (n, m), device=dev, dtype=torch.int32)
        ones = torch.ones(m, device=dev)
        windows[f"alpha_combine_{s}x{s}x{p}_x{calls}"] = \
            lambda th=theta, al=alpha, c=calls: [
                ac.alpha_combine(th, al) for _ in range(c)]
        windows[f"disagreement_counts_{n}x{m}_x{calls}"] = \
            lambda pr=preds, v=ones, c=calls: [
                dg.disagreement_counts(pr, v) for _ in range(c)]
        windows[f"disagreement_{n}x{m}_x{calls}"] = \
            lambda pr=preds, c=calls: [dg.disagreement(pr)
                                       for _ in range(c)]
    windows.update({
        "train_20_steps": lambda: train_local(state.params, state.clients, 1,
                                              iters=20),
        "solve_1x128_steps": lambda: solve_stlf(
            prob, max_outer=1, inner_steps=128, polish=False),
        "transfer_eval": lambda: evaluate_assignment(
            state, "ST-LF", stlf.psi, stlf.alpha),
    })
    model, params = lm
    toks = torch.randint(0, model.cfg.vocab_size, (4, 2048), device=dev)
    cache = model.init_cache(4, 96, device=dev)
    pos = [torch.full((4,), i, device=dev) for i in range(10)]

    def decode_10():
        for i in range(10):
            model.decode_step(params, cache, {"token": toks[:, i:i + 1],
                                              "pos": pos[i]})
    long_toks = torch.randint(0, model.cfg.vocab_size, (1, 9216), device=dev)
    windows["prefill_4x2048"] = lambda: model.prefill(params,
                                                      {"tokens": toks})
    windows["prefill_1x9216"] = lambda: model.prefill(
        params, {"tokens": long_toks})
    windows["decode_10_steps_b4"] = decode_10
    r_model, r_params = rwkv_lm
    r_toks = toks % r_model.cfg.vocab_size
    r_cache = r_model.init_cache(4, 16, device=dev)

    def rwkv_decode_10():
        for i in range(10):
            r_model.decode_step(r_params, r_cache,
                                {"token": r_toks[:, i:i + 1], "pos": pos[i]})
    windows["rwkv_prefill_4x2048"] = lambda: r_model.prefill(
        r_params, {"tokens": r_toks})
    windows["rwkv_decode_10_steps_b4"] = rwkv_decode_10
    # the default run only: a churn round may re-solve at the full cold
    # budget, which would make a window of 10^6 kernel records
    eng = sim_engines[SIM_TAGS[0]]
    windows[f"sim_round_{SIM_TAGS[0]}"] = lambda: eng.step(eng.state.round)
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
        kern = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA]
        dev = [(e.self_device_time_total, e.key, e.count) for e in kern]
        launched = sum(e.count for e in kern)
        busy = sum(t for t, _, _ in dev)
        top = sorted(dev, reverse=True)[:5]
        out[name] = dict(wall_us=wall_us, device_us=busy,
                         busy_share=busy / wall_us, kernels=launched,
                         top=[[k, t, n] for t, k, n in top])
        log(f"[profile] {name}: wall {wall_us:.0f} us, device busy "
            f"{busy:.0f} us ({busy / wall_us:.1%}), {launched} kernels; top: "
            + "; ".join(f"{k[:40]} {t:.0f}us/{n}" for t, k, n in top))
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


def phase_small_lm():
    """The LM on the GPU (through the flash kernel) against the port on
    the CPU (its plain version; the CPU tests hold that against the JAX
    package), in float32 at 2 layers, d_model 128."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import generate
    from repro_torch.models.api import build_model

    cfg = dataclasses.replace(
        get_config(LM_ARCH).reduced(num_layers=2, d_model=128),
        dtype="float32", attention_impl="kernel")
    model = build_model(cfg)
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 80))
    out = {}
    for dev in ("cpu", "cuda"):
        params = model.init(torch.Generator().manual_seed(0), device=dev)
        t = torch.as_tensor(toks, device=dev)
        out[dev] = (model.prefill(params, {"tokens": t}).cpu(),
                    generate(model, params, t[:, :16], 8, 24).cpu())
    diff = float((out["cuda"][0] - out["cpu"][0]).abs().max())
    if not torch.allclose(out["cuda"][0], out["cpu"][0], atol=1e-3,
                          rtol=0.0):
        raise AssertionError(f"LM prefill: GPU differs from CPU by {diff}")
    if not torch.equal(out["cuda"][1], out["cpu"][1]):
        raise AssertionError("LM generate: GPU tokens differ from CPU")
    log(f"[small] LM prefill (window {cfg.sliding_window} < 80 tokens) "
        f"agrees on GPU and CPU (max |dlogit| {diff:.3g}); greedy tokens "
        f"equal")


def phase_small_rwkv():
    """rwkv6 on the GPU (through ``ssm_scan``) against the port on the CPU
    (its plain version; the CPU tests hold that against the JAX package),
    in float32 at ``reduced()`` (2 layers, d_model 256, chunk 32)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import generate
    from repro_torch.models.api import build_model

    cfg = dataclasses.replace(get_config(RWKV_ARCH).reduced(),
                              dtype="float32")
    model = build_model(cfg)
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 80))
    out = {}
    for dev in ("cpu", "cuda"):
        params = model.init(torch.Generator().manual_seed(0), device=dev)
        t = torch.as_tensor(toks, device=dev)
        out[dev] = (model.prefill(params, {"tokens": t}).cpu(),
                    generate(model, params, t[:, :16], 8, 24).cpu())
    diff = float((out["cuda"][0] - out["cpu"][0]).abs().max())
    if not torch.allclose(out["cuda"][0], out["cpu"][0], atol=1e-3,
                          rtol=0.0):
        raise AssertionError(f"rwkv prefill: GPU differs from CPU by {diff}")
    if not torch.equal(out["cuda"][1], out["cpu"][1]):
        raise AssertionError("rwkv generate: GPU tokens differ from CPU")
    log(f"[small] rwkv prefill (80 tokens, chunk {cfg.ssm.chunk}) agrees on "
        f"GPU and CPU (max |dlogit| {diff:.3g}); greedy tokens equal")


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
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.ssm_scan import ops as ss
    counted = {"alpha_combine": ac.alpha_combine,
               "disagreement": dg.disagreement_counts,
               "flash_attention": fa.flash_attention,
               "ssm_scan": ss.gla_chunked}

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
        fn = ""
        for line in text.splitlines():
            if "Compiling entry function" in line:
                fn = demangle(_build, line.split("'")[1])
            elif "registers" in line or "spill" in line:
                log(f"[build] {name} {fn}: {line.strip()}")
    hgmma = check_flash_sass(_build)
    report["flash_hgmma"] = hgmma
    log(f"[build] flash_attention bf16 kernel SASS: HGMMA instructions "
        f"{hgmma}")
    tf32 = check_alpha_sass(_build)
    report["alpha_combine_tf32_mma"] = tf32
    log(f"[build] alpha_combine kernel SASS: TF32 MMA instructions {tf32}")
    tf32 = check_ssm_sass(_build)
    report["ssm_scan_tf32_mma"] = tf32
    log(f"[build] ssm_scan kernel SASS: TF32 MMA instructions {tf32}")

    # 3. kernels against their plain versions
    rows = phase_kernels(ac, dg, report)
    rows["flash_attention"] = phase_flash(fa)
    torch.cuda.empty_cache()
    rows["ssm_scan"] = phase_ssm(ss, report)
    torch.cuda.empty_cache()
    # 3b. no wrapper cuts autograd
    phase_guard(ac, dg, fa, ss)

    # 4. main path at full size, counted
    launches, state, stlf = phase_main_path(ac, dg, counted, report)
    # 4b. the comparison matrix on that state, counted
    phase_baselines(ac, counted, state, stlf, report)
    # 4c. the simulator's sync path through its CLI, counted
    sim, sim_engines = phase_sim(ac, counted, report)

    # 5. the serve path at full width, counted
    serve_launches, model, params = phase_serve(counted, report)
    # 5b. the rwkv serve path at full width and depth, counted
    rwkv_launches, rwkv_model, rwkv_params = phase_serve_rwkv(counted,
                                                              report)
    # each kernel's count from the path that runs it
    launches = dict(launches,
                    flash_attention=serve_launches["flash_attention"],
                    ssm_scan=rwkv_launches["ssm_scan"])

    # 6. GPU against the CPU port on small inputs
    phase_small_reference()
    phase_small_sim(report)
    phase_small_lm()
    phase_small_rwkv()
    if "--profile" in sys.argv[1:]:
        phase_profile(state, stlf, (model, params),
                      (rwkv_model, rwkv_params), sim_engines, report)

    paths = {"alpha_combine": "ST-LF round (prepare_round, run_stlf)",
             "disagreement": "ST-LF round (prepare_round, run_stlf)",
             "flash_attention": f"{LM_ARCH} prefills {PREFILLS}",
             "ssm_scan": f"{RWKV_ARCH} prefills {RWKV_PREFILLS}"}
    kernels = []
    for name, rs in rows.items():
        main = rs[0]                # the main path's shape comes first
        kernels.append(dict(
            name=name, route="cuda", **KERNEL_META[name],
            launches=launches[name], launches_path=paths[name],
            max_abs_err=max(r["max_abs_err"] for r in rs),
            ms=main["ms"], plain_ms=main["plain_ms"],
            bound_ms=main["bound_ms"], bound_by=main["bound_by"],
            library_ms=main["library_ms"]))
        if "device_us" in main:     # the CUDA kernels behind the wrapper
            kernels[-1]["cuda_kernels"] = main["device_us"]
    # alpha_combine's other paths: the comparison matrix and the sim runs
    ac_row = next(k for k in kernels if k["name"] == "alpha_combine")
    ac_row["launches_by_path"] = dict(
        {"ST-LF round": launches["alpha_combine"],
         "run_all_baselines": report["baselines"]["launches"][
             "alpha_combine"]},
        **{f"sim {tag}": r["launches"]["alpha_combine"]
           for tag, r in sim.items()})
    log("[report] " + json.dumps(report))
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
