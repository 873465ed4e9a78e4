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
             card (``alpha_combine`` to rtol/atol 1e-5 at nine shapes, T
             past 256, S no multiple of 8 and the sharded pool's slabs
             (1024, 128), (256, 32), (8, 2) among them;
             ``disagreement_counts`` and ``disagreement()`` exactly,
             fractional weights bit-equal on two launches and within
             rtol 1e-6, with both versions' error against a float64 sum;
             the host's share of a (10, 2500) call split into its parts)
             and times kernel, plain version and one PyTorch library
             call with CUDA events.
             ``flash_attention`` is held against its plain version at
             the serve paths' two prefill shapes, (4, 2048) causal and
             (1, 9216) with a window of 8192, at llama3.2-1b's D = 64,
             zamba2-7b's 112 (32/32 heads) and gemma-7b's 256 (16/16),
             and at D = 128 with the MoE and vlm decoders' GQA ratios
             (grok-1 48/8, llama4-scout 40/8, internvl2-2b 16/8; bf16),
             in bf16 (within one bf16 ulp: rtol 2^-7, atol 1e-5; the
             tensor-core kernel) and in fp32 (the SIMT kernel), and on
             the JAX package's test grid in fp32 (atol 3e-5, rtol
             1e-4), and timed (bf16; fp32 too at D = 112 and 256) beside
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
             1e-5 / 1e-4; the plain version sums its products in
             float64 from the same fp32 factors); timed at the serve
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
             on the card, in float64, its gaps agree with the CPU port's
             on the same draws within 2 rows of a pair's data and its
             weights within 1e-2 of their largest entry, and half the
             learning rate (a planted fault) breaks both bars; its
             float32 features agree within 1e-5 of their largest entry
             (the discriminators' SGD amplifies float32 rounding past
             any bar, see ``FADA_KW``: the float32 gaps and weights are
             reported beside the CPU's own float32-to-float64 distance).
4c. sim    — the simulator's sync path through its CLI
             (``python -m repro_torch.sim.run``, ``--trace``): the
             default run (channel-drift, 8 devices, 5 rounds; a pool of
             8, one ``alpha_combine`` kernel a round), then device-churn
             at 16 devices for 3 rounds (4 spares, a pool of 20: two
             kernels a round; every solve capped at CUT_SOLVER's 2
             outer iterations, cold ones at 2 x 150 inner steps),
             counted; each round's phase walls from
             the trace fields, the solves' inner steps from the trace
             events; the kernel against its plain version on the last
             round's own transfer inputs (rtol/atol 1e-5).
4d. sim-async — the simulator's async, drift and fault/resume paths
             through the same CLI run (``--trace``), every cold solve
             at CUT_SOLVER's budget (2 x 150 inner steps), counted:
             async-gossip (8 devices, the CLI's async defaults, 6
             ticks) and feature-drift-async (8 devices, 5 ticks), where
             no kernel of the port runs (every count stays 0); each
             tick's trained devices, gossip pairs, re-solve reason,
             dirty backlog and re-estimates (within the budget) and
             phase walls; a cost model fitted from the first run's own
             trace and the autotuner's choice under it (its knobs must
             reproduce its predicted seconds and keep its guardrails).
             Then 'faulty'
             (sync, 8 devices, 4 rounds): uninterrupted, then with
             ``--checkpoint-every 1 --kill-after 2`` in a child process
             that SIGKILLs itself and ``--resume`` to the end, counted
             (``alpha_combine`` as ``alpha_combine_plan`` gives it, each
             round run); ``restore_run`` must put back bit for bit the
             arrays ``save_run`` wrote; whether two uninterrupted card
             runs agree, and the resumed rounds with the uninterrupted
             ones, on the decisions; the kernel against its plain
             version on the last round's transfer inputs.
4e. sim-shard — the sharded device pool, counted, every cold solve at
             CUT_SOLVER's budget (2 x 150 inner steps): the
             default run cut to 2 rounds through ``--mesh 1``, then at
             an emulated mesh of 4 (every shard on this card) and on
             the single-device pool through the Python API: equal
             decisions,
             ``alpha_combine`` one slab a shard a round, the three
             pools' transfers of one state within 1e-5; 'faulty' with
             shard losses at an emulated mesh of 2 (6 devices, 4
             rounds): devices recovered, SIGKILLed after round 1 in a
             child and resumed to the straight run's decisions; the
             pool's phases at N = 512 (train, a 64-pair Algorithm-1
             batch, the transfer, the accuracy sweep) at mesh 1 and an
             emulated mesh of 8, timed, each shard's (512, 64) slab
             against the plain version (1e-5) and the transfer against
             the single-device pool's; the packed solver
             (``inner_impl="packed"``) against the structured one on the
             main path's problem, capped at 2 x 150 steps (equal psi,
             alpha within 1e-3), ms per Adam step of each.
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
5c. serve-zamba — zamba2-7b at full width and depth (81 mamba layers in
             14 groups, each followed by one of 2 shared attention
             blocks; seeded weights drawn on the card), through the
             kernels: prefill of PREFILLS, counted: 14 ``flash_attention``
             launches (D = 112) and 81 x 3 ``ssm_scan`` kernels a
             prefill; the logits against the same model through
             ``"dot"`` and the plain scan (LM_TOL, argmax equal); layer
             0's SSD inputs through ``ssm_scan`` against its plain
             version (float64 sums; as the model makes them, and
             with C, B and v at unit RMS), timed; shared block 0's q, k,
             v through the kernel against its plain version; then
             ``serve.generate`` (32 greedy tokens after a (4, 64)
             prompt, ms per decode step) and JAX's serving invariant in
             float32 compute (the bf16 gap reported beside it).  Freed.
5d. serve-gemma — gemma-7b at full width and depth (28 layers of 16
             heads of 256, GeGLU, tied embeddings) the same way: 28
             ``flash_attention`` launches a prefill, logits against
             ``"dot"``, layer 0's q, k, v, generate, the invariant.
             Freed.
5e. serve-grok, serve-llama4 — the MoE decoders at full width, depth
             cut to fit the card with fp32 weights (grok-1-314b 2 of 64
             layers, llama4-scout-17b-a16e 4 of 48): PREFILLS counted
             (one ``flash_attention`` launch a layer, D = 128 at GQA 6
             and 5); the logits against ``"dot"`` with the expert ids
             pinned to the kernel route's (the dot route's own routing
             flips near-ties: the flips and the share of choices the
             capacity drops printed); layer 0's q, k, v; generate; the
             invariant in float32 compute on JAX's dropless config
             (capacity factor = experts).  Each freed.
5f. serve-vlm — internvl2-2b at full width and depth (24 layers, 16/8
             heads of 128): prompts of 256 seeded frontend rows + text,
             PREFILLS long, 24 launches a prefill, against ``"dot"``;
             layer 0's q, k, v; generate on text; the invariant.  Freed.
5g. serve-encdec — seamless-m4t-large-v2 at full width and depth (24 +
             24 layers): prefill of (4, 2048) tokens over (4, 1024, 1024)
             seeded frames, counted (no kernel: JAX's encoder-decoder
             runs its attention plainly); the cross cache from the
             encoder's memory, ``decode_step`` over a (4, 64) prompt and
             32 greedy tokens (ms a step); decode against prefill in
             float32 compute.  Freed.
7. train   — (run after 5g, before 6) repro-100m at full width and
             depth (12 layers, d_model 768, ~129 M parameters) through
             ``python -m repro_torch.launch.train``'s ``main``: 30 steps
             at (8, 512) on ``LMStream``, counted (no kernel runs: JAX
             trains through plain code too); every logged loss finite,
             the last below the first by 0.5 nat; ms a step and tokens/s
             over steps 2-30 (host clock between synchronizes, the first
             step apart, checkpoint writes left out), peak memory, a
             profiler window over three more steps; a second run to step
             25 restores step 20's checkpoint (bit for bit) and trains
             on.  Three fp32 train steps of repro-100m, rwkv6-1.6b,
             zamba2-7b and grok-1-314b (MoE: ce + the load-balance aux)
             at ``reduced()`` on the card and on the CPU port
             (loss within 1e-5 relative, each leaf's change within 1e-3
             of its norm).  ``attention_impl="kernel"`` under grad
             raises; under ``no_grad`` its loss runs ``flash_attention``
             once a layer, within 2e-2 of the dot route's.
7d. stlf-lm — ST-LF over LM clients (``python -m
             repro_torch.stlf_lm_clients``), counted: ``alpha_combine``
             once, at S = T = 6 and P = 590,464, held against its plain
             version (1e-5) on the run's own inputs and timed beside
             ``matmul``; at least one target, unit alpha columns there,
             each target's error falling; the phase split.
8. accounting — (run after 7d, before 6) (a) one call of each kernel op
             (``torch.ops.repro_torch.*``) at its PERF.md §6 shape under
             ``launch.hlo.StepCounter`` on the card: the counted FLOPs and
             bytes give the table's bound within ACCT_BOUND_TOL, the call
             launched its kernels; the op's device ms and host µs a call
             against its raw C-entry launch.  (b) llama3.2-1b's prefill at
             (4, 2048) on the kernel route, one decode step at batch 4 and
             repro-100m's train step at (8, 512), each counted on the card
             and through its bundle on ``meta`` (FLOPs equal exactly, bytes
             within ACCT_BYTES_TOL), timed without the counter: TFLOP/s,
             the roofline's compute and memory terms and their shares,
             ``roofline.mfu``, peak memory beside the dry run's 1x1
             argument bytes.  (c) the partitioned dry run
             (``repro_torch.launch.dryrun``) for llama3.2-1b x the four
             input shapes at 16x16 on ``meta``, rank 0 of each step on a
             fake process group of 256 ranks, and the same on one card,
             in a child process started after the build: every record
             ok, each 16x16 record rank 0's (``per_device`` "rank0") with
             its collectives counted (bytes above 0), and rank 0's FLOPs
             x 256 at least the one-card record's.
6. checks  — the disagreement kernel on the trained models' predictions
             and the transfer against their plain versions, and the GPU
             against the port on the CPU at a small size (the ST-LF
             pieces, four small simulator runs with equal decisions:
             channel-drift, device-churn, async-gossip and feature-drift,
             and the LM's and rwkv6's prefill and greedy tokens).

9. mesh    — (run after 8) every family on a ('data', 'model')
             ``DeviceMesh`` through the bundles on DTensor
             (``launch.steps.on_mesh``).  9a, on every host: a world of
             one rank under ``nccl`` in this process; llama3.2-1b at full
             width, parameters drawn shard by shard on the mesh, its
             MESH_PREFILL prefill on the kernel route (16
             ``flash_attention`` launches through the op's sharding rule)
             and MESH_DECODE decode steps at batch 4, against the same
             calls without a mesh (bf16: LM_TOL, argmax equal; fp32
             compute, the dot route too: MESH_F32_TOL); repro-100m's
             MESH_TRAIN fp32 train steps against ``make_train_step`` (losses
             within MESH_F32_TOL, each leaf's change within 1e-3 of its
             norm); each time beside its time without a mesh; then
             MESH_FAMILIES the same way: rwkv6-1.6b, zamba2-7b and
             seamless-m4t at full width and depth, grok-1 at full width
             on 2 of 64 layers (under the default rules: on (1, 1)
             expert_parallel lays everything out alike), each prefill
             on the kernel route counted on rank 0
             through the ``ssm_scan`` and flash rules (rwkv6 24 scan
             calls, zamba2-7b 81 and 14 flash launches, grok-1 2 flash
             launches) with the scans' local q shapes, the MoE prefill
             held with its routing pinned (flips counted), and their
             reduced() train steps; then two gloo ranks on the one card
             (the outcome is recorded).  9b, on two or more cards:
             llama3.2-1b on (1, k), (k, 1) and (2, 2) against 9a (the
             parameters drawn equal, LM_TOL in bf16, MESH_F32_TOL_SHARDED
             in fp32), repro-100m's steps on (1, k) and (k, 1) and
             ``launch.train --devices k --model-axis m``; the other
             families on (1, k) and (k, 1) (grok-1 also under
             expert_parallel on (k, 1)) against 9a (bf16 at LM_TOL with
             argmax equal, zamba2-7b at MESH_BF16_TOL_DEEP; fp32 at
             MESH_F32_TOL_FAMILIES), rank 0's scans on H/k heads on
             (1, k), the bytes of the collectives on rank 0 and their
             largest buffers (a prefill; zamba2-7b's first mamba layer;
             read by ``launch.hlo.StepCounter``: a collective's result
             bytes, twice that for an all-reduce);
             tokens/s, ms a step, each card's peak memory.  9c, on four or more cards:
             granite-34b at full width and depth on (1, 4), the kernel
             route against dot (LM_TOL), decode steps; grok-1 at full
             width on 6 of 64 layers on (1, 4) (default rules) and on
             (4, 1) (expert_parallel); each card's peak memory over the
             calls below 80 GB, the collectives' bytes and largest
             buffers on rank 0.  On a host with fewer cards
             9b and 9c each print how many they need.
             ``python3 chip_smoke.py --only-mesh`` builds the kernels and
             runs phase 9 alone.

``python3 chip_smoke.py --profile`` adds a torch.profiler window over
each phase (the device's busy share, top kernels; the ST-LF kernels'
launches and device time a call) after phase 6.

The last three lines of standard output are the ``nvidia-smi`` name and
power limit, one JSON object describing every kernel, and the device
JSON; the line before them, ``[report] {...}``, holds every number the
run took.
"""
from __future__ import annotations

import atexit
import dataclasses
import json
import os
import re
import shutil
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
# the hybrid and the dense model whose attention runs flash_attention at
# the head dims llama's does not (zamba2-7b's shared attention, 32 heads
# of 112; gemma-7b, 16 of 256): (arch, heads, head dim).  Both prefill
# PREFILLS, the second past their 8192-token window
ZAMBA_ARCH, GEMMA_ARCH = "zamba2-7b", "gemma-7b"
HEAD_DIM_PATHS = [(ZAMBA_ARCH, 32, 112), (GEMMA_ARCH, 16, 256)]
# the MoE decoders at full width, their depth cut to fit one card with
# fp32 weights (JAX's param_dtype): (arch, layers kept).  grok-1: 2 of 64
# layers (19.7 GB each: 8 experts x 3 x 6144 x 32768) + 6.4 GB of
# embeddings; llama4-scout: 4 of 48 (8.3 GB each) + 8.3 GB
MOE_PATHS = [("grok-1-314b", 2), ("llama4-scout-17b-a16e", 4)]
# the stub-frontend decoder (its prompts: 256 frontend rows, then text)
# and the encoder-decoder, both at full width and depth
VLM_ARCH, ENCDEC_ARCH = "internvl2-2b", "seamless-m4t-large-v2"
# (B, S) of the encoder-decoder's prefill, over (B, 1024, 1024) frames
ENCDEC_PREFILL = (4, 2048)
# the decoders whose attention runs flash_attention at D = 128 with GQA
# ratios 6, 5 and 2: (arch, heads, kv heads); each prefills PREFILLS
GQA_PATHS = [(MOE_PATHS[0][0], 48, 8), (MOE_PATHS[1][0], 40, 8),
             (VLM_ARCH, 16, 8)]
# phase 7, training: repro-100m (JAX's train.py default) at full width
# and depth through launch.train: (steps, batch, seq, log every,
# checkpoint every, the restored run's last step); the loss must fall by
# TRAIN_MIN_DROP nat over the logged steps (ln 32768 ~ 10.4 at init)
TRAIN_ARCH = "repro-100m"
TRAIN_RUN = (30, 8, 512, 5, 20, 25)
TRAIN_MIN_DROP = 0.5
# the families whose train steps are held card against CPU at reduced(),
# three fp32 steps of adamw(TRAIN_LR): the losses within 1e-5 relative;
# the first step's gradients, each leaf within TRAIN_GRAD_TOL of its norm;
# each leaf's change after three steps within TRAIN_DELTA_TOL of its norm
# over the elements whose changes agree within TRAIN_LR, and at most
# TRAIN_FLIP_SHARE of a leaf's elements apart by more (Adam's first steps
# are about +-lr by the gradient's sign: a near-zero gradient whose sign
# the summation order flips moves its element a whole step; 11 of the
# 262,144 in rwkv6's embedding, 2 in zamba2-7b's, in a development run).
# rwkv6 and zamba2-7b keep bf16 rounding points in an fp32 config, as in
# JAX (their projections' weights are cast to bf16 at use, rwkv6's
# receptance gate is rounded to bf16): their gradients agree to 4.1e-4
# and 5.6e-5 of a leaf (repro-100m 1.4e-6), and Adam's normalisation
# carries that into their changes (rwkv6 1.1e-3 on att/wg with no flip;
# zamba2-7b 1.3e-3 on another batch, the card tests')
# grok-1-314b (MoE, top-2 of 4 experts at reduced()) keeps no bf16
# rounding point in an fp32 config (its experts cast their weights to the
# compute dtype), so it has repro-100m's bar; its router is fp32 in both
# (a token whose top-2 flipped between card and CPU would move its
# experts' changes far past it)
TRAIN_CARD_CPU = ["repro-100m", "rwkv6-1.6b", "zamba2-7b", "grok-1-314b"]
TRAIN_LR = 3e-4
# phase 9, the mesh: llama3.2-1b's prefill (B, S) and decode steps at
# batch B, repro-100m's train steps (steps, B, S); fp32 compute on a
# one-rank mesh against no mesh, and on sharded meshes against the
# one-rank mesh (sums split over the cards: another order); how long two
# gloo ranks on one card may take; the model 9c runs on four cards
MESH_PREFILL, MESH_DECODE, MESH_TRAIN = (4, 2048), 8, (3, 8, 512)
MESH_F32_TOL = dict(atol=1e-6, rtol=1e-6)
MESH_F32_TOL_SHARDED = dict(atol=1e-5, rtol=1e-5)
MESH_GLOO_S = 30
GRANITE_ARCH = "granite-34b"
# phase 9's other families, each at full width on the mesh, the bf16
# prefill (MESH_PREFILL) on the kernel route and MESH_FAMILY_DECODE
# decode steps at its batch, then an fp32-compute prefill of
# MESH_FAMILY_F32 and two decode steps: (arch, config overrides, rule
# sets).  grok-1 keeps phase 5's 2 of 64 layers (46 GB of fp32 weights)
MESH_FAMILIES = [("rwkv6-1.6b", {}, ("default",)),
                 ("zamba2-7b", {}, ("default",)),
                 ("grok-1-314b", {"num_layers": 2},
                  ("default", "expert_parallel")),
                 ("seamless-m4t-large-v2", {}, ("default",))]
MESH_FAMILY_DECODE = 4
MESH_FAMILY_F32 = (2, 256)
# their train steps at reduced(), fp32, on the mesh against
# make_train_step (one rank) or against the one-rank mesh (9b): (steps,
# B, S).  A data split rounds each rank's partial bf16 gradient of
# rwkv6's and mamba's bf16-cast projections apart from one process's
# single rounding (<= 3.4e-3 of a leaf's norm on a (2, 2) CPU mesh,
# tests/_torch_mesh_families.py), so sharded meshes are held to
# MESH_GRAD_TOL_SHARDED
MESH_FAMILY_TRAIN = (3, 4, 128)
MESH_GRAD_TOL_SHARDED = 5e-3
# their fp32-compute calls on a sharded mesh against the one-rank mesh:
# the sums split over the ranks round elsewhere in every block, and
# zamba2-7b's 95 blocks put its prefill 2.5e-5 apart on (1, 4), past
# MESH_F32_TOL_SHARDED, which llama3.2-1b's 16 layers just meet
# (1.01e-5); tests/test_torch_lm.py's bar against JAX.  One process's
# own floor, its fp32 prefill at MESH_FAMILY_F32 with the products in
# fp64 against as it runs (tools/mesh_bf16_gap.py floor, one H100):
# zamba2-7b 2.551e-5, rwkv6 1.073e-6
MESH_F32_TOL_FAMILIES = dict(atol=1e-4, rtol=1e-4)
# their bf16 calls on a sharded mesh against the one-rank mesh are held
# at LM_TOL with equal argmax, but zamba2-7b's: each rank rounds its
# partial bf16 products before they are summed, and its 95 blocks grow
# that to 0.285 (prefill) and 0.231 (decode, an argmax flipped) on
# (1, 4) on four H100s.  With every bf16 product taken in fp32 and its
# partial sums reduced before the one rounding, the gap falls to the
# floor of fp32's reordering (tools/mesh_bf16_gap.py at reduced() on
# the CPU: (1, 4) 0.0169 -> 0.0052, floor 0.0048; rwkv6 0.0072 -> 0),
# so it is rounding, not the mesh code; at full depth any reordering
# moves zamba2-7b's bf16 prefill that far (one process, its products in
# fp64 against as it runs: 0.1959 at (4, 2048), tools/mesh_bf16_gap.py
# floor), and fp32 partial sums on four H100s read 0.2029 with a
# prefill row flipped.  Held at twice the reading, with the argmax
# equal in MESH_BF16_ARGMAX_DEEP of the rows (a prefill's 4; a decode's
# 16, of which one flipped)
MESH_BF16_TOL_DEEP = {"zamba2-7b": dict(atol=0.6, rtol=0.05)}
MESH_BF16_ARGMAX_DEEP = {"prefill": 0.99, "decode": 0.75}
# 9c: grok-1 at full width on 6 of 64 layers (three times phase 5's
# depth) on four cards, under the default rules on (1, 4) and under
# expert_parallel on (4, 1)
MESH_GROK_LAYERS = 6
TRAIN_GRAD_TOL = 1e-3
TRAIN_DELTA_TOL = {"repro-100m": 1e-3, "rwkv6-1.6b": 5e-3,
                   "zamba2-7b": 5e-3, "grok-1-314b": 1e-3,
                   "seamless-m4t-large-v2": 1e-3}
TRAIN_FLIP_SHARE = 1e-4
# the loss through the flash kernel (no_grad) against the dot route,
# bf16 compute at full width
KERNEL_LOSS_TOL = 2e-2
RWKV_ARCH = "rwkv6-1.6b"
# (B, L) of the rwkv serve path's two prefills: a batch of 2k prompts,
# and one long prompt at batch 1, the case a linear-attention model is
# chosen for
RWKV_PREFILLS = [(4, 2048), (1, 16384)]
# ssm_scan against its plain version, which sums its products in float64
# from the same fp32 factors: y in bf16 within one bf16 ulp (both round
# once), y in fp32 within the kernels' fp32 summation order, the final
# state (fp32) likewise (fp32 sums in cuBLAS's order lay up to 0.87 of
# the fp32 bar from the float64 ones at rwkv6's scale, the kernels' up to
# 0.69: tools/ssm_scan_fp32_bar.py)
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
# ~850 at lr 0.05), so it amplifies rounding 1e3-1e7 times: in float32
# the CPU port's own run lies 1-4 rows and 3e-3 to 1.2e-2 of max |w|
# from its float64 run on ST-LF's pairs, and 113-237 rows and 0.11-0.20
# over all 90 pairs (tools/fada_fp32_noise.py).  A float32 bar measures
# that noise, not the card, so the card is held to the CPU in float64
# (the same code on float64 parameters and data; a 1e-15 relative nudge
# moves w by at most 1.7e-8 of its largest entry, the card 4e-10 from
# the CPU): gaps at most 2 rows of a pair apart, w within
# 1e-2 of its largest entry; half the learning rate moves both far past
# the bars (PERF.md §6).  The float32 features (cuDNN's against the
# CPU's: 5.1e-7 to 5.6e-7 of the largest entry in four runs) are held to
# 1e-5, and the float32 gaps and weights are reported beside the CPU's
# own float32-to-float64 distance.
FADA_GAP_ROWS = 2
FADA_W_TOL = 1e-2
FADA_FEAT_TOL = 1e-5
# the simulator's runs on the card: (scenario, devices, rounds); the
# default run (8 devices, no spares: a pool of 8, the transfer's one
# mma.sync kernel a round), then device-churn at 16 devices (4 spares: a
# pool of 20, split + wgmma, two kernels a round), its cold solves at
# CUT_SOLVER's budget: (scenario, devices, rounds, cut)
SIM_RUNS = [("channel-drift", 8, 5, False), ("device-churn", 16, 3, True)]
SIM_TAGS = [f"{s}-n{n}-r{r}" for s, n, r, _ in SIM_RUNS]
# the simulator's async and drift runs on the card, through the CLI with
# its defaults (8 devices, 100 samples, 30 SGD steps, solver 150 warm,
# clocks (1, 2, 4), n_active // 4 gossip pairs) but CUT_SOLVER's cold
# solves (4d's fault/resume runs too): (scenario,
# engine, devices, ticks), ticks cut for the script's time limit (12 and
# 8 ticks until phase 4e took its share)
SIM_ASYNC_RUNS = [("async-gossip", "async-gossip", 8, 6),
                  ("feature-drift-async", "async-gossip", 8, 5)]
# the fault/resume run: sync 'faulty' at the CLI's fault defaults,
# (devices, rounds, the round after which the first run is SIGKILLed);
# 5 rounds until phase 4e took its share
SIM_FAULTY = (8, 4, 2)
# phase 4e, the sharded pool: the CLI's default run cut to 2 rounds
# ((scenario, devices, rounds)) at mesh 1 through the CLI, then at an
# emulated mesh of SHARD_MESH (every shard on the one card) and on the
# single-device pool through the Python API
SHARD_RUN = ("channel-drift", 8, 2)
SHARD_MESH = 4
# sync 'faulty' with shard losses at an emulated mesh of 2, the CLI's
# defaults otherwise: (devices, rounds, the round after which the child
# run is SIGKILLed)
SHARD_FAULTY = (6, 4, 1)
# the solves of phase 4e, of 4d and of 4c's device-churn run, for the
# script's time limit: (solver_max_outer, solver_inner_steps), every
# solve capped at 2 outer iterations, a cold one at 150 inner steps (a
# sixteenth of the CLI's default 8 x 600), the warm inner budget (150)
# unchanged; the three pools of 4e (1) still share one budget.
# The CLI's default run (4c's first) keeps the whole budget
CUT_SOLVER = (2, 150)
CUT_ARGS = ["--solver-max-outer", str(CUT_SOLVER[0]),
            "--solver-inner-steps", str(CUT_SOLVER[1])]
SHARD_FAULTY_CFG = dict(scenario="faulty", mesh=2, fault_shard_p=0.7,
                        fault_crash_p=0.0,
                        solver_max_outer=CUT_SOLVER[0],
                        solver_inner_steps=CUT_SOLVER[1])
# the pool's phases at simulator scale (no bootstrap, no solve), as
# benchmarks/sim_scale.py's dry rows take them: pool size, the emulated
# mesh timed beside mesh 1, and the Algorithm-1 batch's pairs
POOL_SCALE = (512, 8, 64)
# the packed solver against the structured one on the main path's
# problem, capped: (max_outer, inner_steps)
PACKED_SOLVE = (2, 150)
# the small runs held GPU against CPU: (scenario, engine, seed), each with
# targets in some round under the port's seeds
SMALL_SIM = [("channel-drift", "sync", 0), ("device-churn", "sync", 2),
             ("async-gossip", "async-gossip", 3),
             ("feature-drift", "sync", 2)]
SMALL_SIM_CFG = dict(devices=5, rounds=3, samples_per_device=40,
                     train_iters=30, div_tau=1, div_T=3, solver_max_outer=4,
                     solver_inner_steps=300, solver_inner_steps_warm=150)
# RoundRecord fields that are decisions: GPU and CPU runs must agree
SIM_DECISIONS = ("n_active", "n_sources", "n_targets", "transmissions",
                 "events", "resolved", "warm", "resolve_reason",
                 "n_trained", "trained", "gossip", "n_drifted",
                 "n_dirty_pairs", "n_reestimated", "n_faults",
                 "n_recovered")


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


def check_flash_sass(_build, head_dims):
    """The bf16 flash kernel compiled to Hopper's warpgroup MMAs: the
    instance of ``flash_fwd_tc_kernel`` for each of ``head_dims`` must
    hold HGMMA instructions (a kernel compiled to FMAs fails).  Returns
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
    if sorted(counts) != sorted(f"flash_fwd_tc_kernel<{d}>"
                                for d in head_dims) \
            or not all(counts.values()):
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


def alpha_device_us(ac, theta, alpha, calls=5, windows=3):
    """Device microseconds a call of each alpha_combine kernel, from a
    profiler window over ``calls`` calls that must hold as many kernel
    records as the wrapper counted launches (a window that lost a record
    is taken again, up to ``windows`` times)."""
    from torch.profiler import ProfilerActivity, profile
    ac.alpha_combine(theta, alpha)
    torch.cuda.synchronize()
    for _ in range(windows):
        before = ac.alpha_combine.launches
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                ac.alpha_combine(theta, alpha)
            torch.cuda.synchronize()
        counted = ac.alpha_combine.launches - before
        us, seen = {}, 0
        for e in prof.key_averages():
            name = re.search(r"(alpha_combine_\w+_kernel|split_alpha\w*)",
                             e.key)
            if e.device_type == torch.autograd.DeviceType.CUDA and name:
                us[name.group(1)] = e.self_device_time_total / calls
                seen += e.count
        if seen == counted:
            return us
    raise AssertionError(f"alpha_combine: the profiler saw {seen} kernel "
                         f"records in {calls} calls, the wrapper counted "
                         f"{counted}")


def phase_kernels(ac, dg, report):
    """Each kernel against its plain version at the main path's shape and
    at the others the port is built for; timings of all three."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = {"alpha_combine": [], "disagreement": []}
    # the main path's shape first, the simulator's scale, ragged P, an S
    # that is no multiple of 8, and T past one block's 256 targets
    # T past one block's 256 targets; then the sharded pool's slabs
    # (S = N_pad, T = N_pad / k): N = 1024 over 8 shards, held here on
    # its own (phase 4e runs N = 512), then 256 over 8 and 8 over 4
    # (phase 4e's runs)
    for s, t, p in [(10, 10, 48158), (256, 256, 48158), (7, 5, 1001),
                    (13, 9, 48158), (300, 300, 1001), (64, 300, 48158),
                    (1024, 128, 48158), (256, 32, 48158), (8, 2, 48158)]:
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
        if p == 48158:      # the device time of each kernel a call
            row["device_us"] = alpha_device_us(ac, theta, alpha)
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
            if "device_us" in r and name == "alpha_combine":
                extra += "; device us a call " + ", ".join(
                    f"{k} {v:.1f}" for k, v in r["device_us"].items())
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


def flash_device_us(fa, run, calls=5, windows=3):
    """Device microseconds a call of the flash kernel, from a profiler
    window over ``calls`` calls (the wrapper must count ``calls``
    launches, and the profiler see no other flash kernel and none more
    often).  A window that lost records (the profiler does, now and then)
    is taken again, up to ``windows`` times; then (None, records seen):
    the CUDA-event ms beside it stand."""
    from torch.profiler import ProfilerActivity, profile
    run()
    torch.cuda.synchronize()
    seen = 0
    for _ in range(windows):
        before = fa.flash_attention.launches
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                run()
            torch.cuda.synchronize()
        counted = fa.flash_attention.launches - before
        recs = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and "flash_fwd" in e.key]
        seen = sum(e.count for e in recs)
        if counted != calls or len(recs) > 1 or seen > calls:
            raise AssertionError(f"flash_attention: {calls} calls counted "
                                 f"{counted} launches in the wrapper and "
                                 f"{[(e.key, e.count) for e in recs]} in "
                                 f"the profiler")
        if seen == calls:
            return recs[0].self_device_time_total / calls, seen
    return None, seen


def phase_flash(fa):
    """``flash_attention`` against its plain version at the serve paths'
    prefill shapes (bf16 and fp32, GQA K/V as ``attend`` passes them):
    llama3.2-1b's D = 64, zamba2-7b's shared attention at D = 112 and
    gemma-7b's D = 256 (the bf16 rows, and at D = 112 and 256 the fp32
    rows too, timed beside ``scaled_dot_product_attention``), D = 128 at
    grok-1's, llama4-scout's and internvl2-2b's GQA ratios (bf16, timed),
    and on the JAX package's test grid (``tests/test_kernels.py``,
    fp32)."""
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
    ] + [(b, s, s, h, h, d, True, w, dt)
         for _, h, d in HEAD_DIM_PATHS for dt in (bf16, f32)
         for (b, s), w in zip(PREFILLS, (None, 8192))] \
        + [(b, s, s, h, kv, 128, True, w, bf16)
           for _, h, kv in GQA_PATHS
           for (b, s), w in zip(PREFILLS, (None, 8192))]
    paths = {(h, kv, d): f"{arch} prefills {PREFILLS}"
             for arch, h, kv, d in [(LM_ARCH, 32, 8, 64)]
             + [(a, h, h, d) for a, h, d in HEAD_DIM_PATHS]
             + [(a, h, kv, 128) for a, h, kv in GQA_PATHS]}
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
        if sq == sk and sq in (2048, 9216):
            row["path"] = paths[(h, kv, d)]
        note = f"max abs err {err:.3g} (output RMS {rms:.3g}, bar " \
               f"{FLASH_TOL[dt]})" + ("" if moved is None else
                                      f"; without the window {moved} "
                                      f"elements fall beyond the bar")
        if "path" in row and (dt == bf16 or d != 64):   # timed
            pairs = live_pairs(sq, sk, causal, window) * b * h
            nbytes = (2 * q.numel() + k.numel() + v.numel()) \
                * q.element_size()
            b_ms, b_by = bound(nbytes, 4 * d * pairs,
                               PEAK_BF16_PER_S if dt == bf16
                               else PEAK_FP32_PER_S)
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
            row["device_us"], row["device_records"] = flash_device_us(
                fa, lambda: fa.flash_attention(q, k, v, causal=causal,
                                               window=window))
            log(f"[kernels] flash_attention {shape} {dtype} window="
                f"{window} on the {route}: {row['ms']:.4f} ms kernel "
                f"({row['tflops']:.1f} TFLOP/s of 4 D per live pair; "
                f"device {row['device_us']} us a call), "
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


def layer0_qkv(model, params, batch):
    """Layer 0's q, k, v as ``DecoderLM.prefill`` hands them to the
    attention impl: the prompt's embedding (after a frontend's
    ``embeds``), rmsnorm, projection, rope."""
    from repro_torch.models.common import take_layer
    from repro_torch.nn.attention import project_qkv
    from repro_torch.nn.layers import rmsnorm
    cfg = model.cfg
    dtype = getattr(torch, cfg.dtype)
    x = model._embed_inputs(params, batch, dtype)
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
            fa_ops, *layer0_qkv(model, params, {"tokens": p}), True, window,
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
    """The kernels against their plain version on the same inputs, which
    sums its products in float64 from the same fp32 factors: y within
    SSM_TOL of its dtype and the final state within SSM_STATE_TOL, all
    finite.  Returns the errors (max abs of y and of the state, the
    largest over the bar) and y's RMS."""
    y, s = ss.gla_chunked(q, k, v, lw, chunk=chunk, variant=variant,
                          bonus=bonus, initial_state=s0)
    torch.cuda.synchronize()
    py, ps = ss.gla_chunked_plain(q, k, v, lw, chunk=chunk, variant=variant,
                                  bonus=bonus, initial_state=s0)
    tol = SSM_TOL[v.dtype]
    finite = bool(torch.isfinite(y).all() and torch.isfinite(s).all())
    if y.dtype != v.dtype or not finite \
            or not torch.allclose(y.float(), py.float(), **tol) \
            or not torch.allclose(s, ps, **SSM_STATE_TOL):
        raise AssertionError(
            f"ssm_scan {what} against the plain version: y max abs err "
            f"{float((y.float() - py.float()).abs().max())} (largest "
            f"error {_over(y, py, tol):.3g} x the bar {tol}, "
            f"{_beyond(y, py, tol)} elements beyond), state max abs "
            f"err {float((s - ps).abs().max())} (bar {SSM_STATE_TOL}, "
            f"{_beyond(s, ps, SSM_STATE_TOL)} beyond), finite {finite}")
    return dict(max_abs_err=float((y.float() - py.float()).abs().max()),
                state_max_abs_err=float((s - ps).abs().max()),
                err_over_bar=_over(y, py, tol),
                y_rms=float(py.float().square().mean().sqrt()))


def ssm_note(c, tol):
    return (f"against the plain version (float64 sums) y max abs err "
            f"{c['max_abs_err']:.3g} ({c['err_over_bar']:.3g} of the bar "
            f"{tol}, y RMS {c['y_rms']:.3g}), state "
            f"{c['state_max_abs_err']:.3g}")


def ssm_device_us(ss, run, calls=5, windows=3):
    """Device microseconds a call of each ssm_scan kernel, from a profiler
    window over ``calls`` calls: each kernel's device time summed over
    its records and divided by their number.  The wrapper must count
    ``calls`` x 3 launches, and the profiler must see nothing of ssm_scan
    but SSM_KERNELS, none more than ``calls`` times.  It keeps every
    record early in a run, but after heavy card work it loses the first
    records of some windows (in phase 3 of full runs of this script: one
    of five ``ssm_chunk_state_kernel`` records, three windows in a row),
    so a kernel is timed on the records seen; a window that saw one of the
    kernels not at all is taken again, up to ``windows`` times.  Returns
    ({kernel: us}, {kernel: records seen})."""
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
                n = name.group(1)
                us[n] = us.get(n, 0.0) + e.self_device_time_total
                seen[n] = seen.get(n, 0) + e.count
        if counted != calls * len(SSM_KERNELS) \
                or set(seen) - set(SSM_KERNELS) \
                or any(n > calls for n in seen.values()):
            raise AssertionError(f"ssm_scan: {calls} calls counted "
                                 f"{counted} launches in the wrapper and "
                                 f"{seen} in the profiler, not {calls} of "
                                 f"each of {SSM_KERNELS}")
        if set(seen) == set(SSM_KERNELS):
            return {n: us[n] / seen[n] for n in SSM_KERNELS}, seen
    raise AssertionError(f"ssm_scan: the profiler saw {seen} in {calls} "
                         f"calls, not each of {SSM_KERNELS}")


def device_parts(row, calls=5):
    """A timed ssm_scan row's device us a call, kernel by kernel, with the
    records a kernel was timed on where the profiler lost some."""
    return ", ".join(
        f"{k_} {v_:.1f}" + ("" if row["device_records"][k_] == calls else
                            f" ({row['device_records'][k_]} of {calls} "
                            f"records)")
        for k_, v_ in row["device_us"].items())


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
                        row.update(path=f"{RWKV_ARCH} prefills "
                                        f"{RWKV_PREFILLS}",
                                   flops=flops, bytes=nbytes,
                                   ms=cuda_ms(run, 10),
                                   plain_ms=cuda_ms(plain, 2),
                                   library_ms=None, bound_ms=b_ms,
                                   bound_by=b_by, fp32_fma_bound_ms=fma_ms,
                                   split_products_ms=(
                                       3 * flops / PEAK_TF32_PER_S * 1e3),
                                   kernel_products_ms=(
                                       2 * macs / PEAK_TF32_PER_S * 1e3))
                        row["device_us"], row["device_records"] = \
                            ssm_device_us(ss, run)
                        parts = device_parts(row)
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


def moe_routing_stats(moe, ids, other):
    """Expert ids (L, B, S, k) of one route against another's: the
    assignments that differ (each token's k choices compared as a set)
    and the share of ``ids``'s choices the capacity drops."""
    from repro_torch.nn import moe as moe_lib
    flips = int((ids.sort(-1).values != other.sort(-1).values).sum())
    cap = moe_lib.capacity(ids.shape[2], moe)
    kept = torch.stack([moe_lib.dispatch_slots(x, cap, moe.num_experts)[1]
                        for x in ids])
    return flips, ids.numel(), float(1 - kept.float().mean())


def _serve_prefills(tag, model, ref_model, params, counted, per_prefill,
                    make_batch=None, pin=False):
    """The big models' prefills of PREFILLS through the kernels, counted
    (``per_prefill``: each kernel's launches a prefill, checked over the
    two and again on a later prefill of each), deterministic, and
    against ``ref_model`` (the plain routes) on the same weights: within
    LM_TOL, argmax equal.  ``make_batch(b, s, gen)`` makes a prompt of
    total length s (default: s random tokens).  With ``pin`` (MoE) the
    reference replays the kernel route's expert ids: a near-tie routes
    differently on the other route's roundings, and a flipped token's
    output differs by O(1); the flips (against the reference's own
    routing) and the share the capacity drops are reported.  Returns
    (launches, batches, rows)."""
    dev = torch.device("cuda")
    cfg = model.cfg
    gen = torch.Generator(device=dev).manual_seed(1)
    if make_batch is None:
        def make_batch(b, s, g):
            return {"tokens": torch.randint(0, cfg.vocab_size, (b, s),
                                            device=dev, generator=g)}
    batches = [make_batch(b, s, gen) for b, s in PREFILLS]
    zero_counts(counted)
    first = [_timed(lambda x=x: model.prefill(params, x)) for x in batches]
    launches = read_counts(counted)
    log(f"[{tag}] launches in the serve path: {launches}")
    for name, n in per_prefill.items():
        if launches[name] != 2 * n:
            raise AssertionError(f"{tag}: {name} launched {launches[name]} "
                                 f"times in two prefills, not {2 * n}")
    rows = []
    for (b, s), x, (logits, first_s) in zip(PREFILLS, batches, first):
        if logits.shape != (b, 1, cfg.vocab_size):
            raise AssertionError(f"prefill logits {tuple(logits.shape)}")
        before = read_counts(counted)
        torch.cuda.reset_peak_memory_stats()
        again, steady_s = _timed(lambda: model.prefill(params, x))
        peak = torch.cuda.max_memory_allocated()
        after = read_counts(counted)
        again_n = {k: after[k] - before[k] for k in per_prefill}
        if again_n != per_prefill:
            raise AssertionError(f"{tag}: a later prefill launched "
                                 f"{again_n}, not {per_prefill}")
        if not torch.equal(again, logits):
            raise AssertionError(f"{tag}: prefill {(b, s)} through the "
                                 f"kernels is not deterministic")
        row, ref_x, note = {}, x, ""
        if pin:
            ids = model.routing(params, x)
            flips, n, drop = moe_routing_stats(
                cfg.moe, ids, ref_model.routing(params, x))
            row.update(routing_flips=flips, routing_assignments=n,
                       dropped_share=drop)
            ref_x = dict(x, expert_ids=ids)
            note = (f"; the plain routes' own routing differs in {flips} "
                    f"of {n} expert assignments (pinned to the kernel "
                    f"route's for the check); the capacity drops "
                    f"{drop:.4%} of the choices")
        ref, ref_s = _timed(lambda: ref_model.prefill(params, ref_x))
        diff, gap = _logit_gap(logits, ref, f"{tag} prefill {(b, s)} "
                               f"kernels vs plain routes")
        del ref, ref_x
        row = dict(shape=[b, s], first_s=first_s, steady_s=steady_s,
                   tok_per_s=b * s / steady_s, peak_gb=peak / 1e9,
                   plain_routes_s=ref_s, max_abs_dlogit_vs_plain=diff,
                   min_top2_gap=gap, **row)
        rows.append(row)
        log(f"[{tag}] prefill {(b, s)} through the kernels: first call "
            f"{first_s:.4f} s, again {steady_s:.4f} s "
            f"({b * s / steady_s:,.0f} tokens/s), peak memory "
            f"{peak / 1e9:.2f} GB; through the plain routes {ref_s:.4f} s; "
            f"max |dlogit| {diff:.4g}, argmax equal (smallest top-2 gap "
            f"{gap:.4g}){note}")
        torch.cuda.empty_cache()
    return launches, batches, rows


def _decode_pass(model, params, prompt):
    """decode_step over ``prompt`` token by token from an empty cache:
    the last step's logits."""
    b, s = prompt.shape
    cache = model.init_cache(b, s, device=prompt.device)
    for i in range(s):
        dec, cache = model.decode_step(params, cache, {
            "token": prompt[:, i:i + 1],
            "pos": torch.full((b,), i, device=prompt.device)})
    return dec


def _serve_generate(tag, model, params, f32_over=None):
    """``serve.generate``: a (4, 64) prompt, 32 greedy tokens, timed.
    Then JAX's serving invariant, decode_step token by token from an
    empty cache reaching prefill's last-token logits, held
    (``_decode_gap``) with the same weights in float32 compute, where it
    tests the caches and the two routes' algorithms (``f32_over``: more
    config fields of that check, e.g. an MoE's dropless capacity); in
    bfloat16 the two routes round differently at every one of the
    model's blocks, and that gap is reported beside it."""
    from repro_torch.launch.serve import generate
    dev = torch.device("cuda")
    cfg = model.cfg
    gen = torch.Generator(device=dev).manual_seed(2)
    b, s, n_gen = 4, 64, 32
    prompt = torch.randint(0, cfg.vocab_size, (b, s), device=dev,
                           generator=gen)
    generate(model, params, prompt[:, :2], 2, 4)          # warm-up
    toks, gen_s = _timed(lambda: generate(model, params, prompt, n_gen,
                                          s + n_gen))
    steps = s + n_gen
    if toks.shape != (b, n_gen) or not bool(
            ((toks >= 0) & (toks < cfg.vocab_size)).all()):
        raise AssertionError(f"{tag}: generate gave {tuple(toks.shape)} "
                             f"tokens out of range")
    dec = _decode_pass(model, params, prompt)
    if not torch.equal(toks[:, 0], dec[:, 0].argmax(-1)):
        raise AssertionError(f"{tag}: generate's first token is not the "
                             f"argmax of the decode pass's logits")
    pre = model.prefill(params, {"tokens": prompt})
    bf16_diff = float((dec.float() - pre.float()).abs().max())
    bf16_same = int((dec.argmax(-1) == pre.argmax(-1)).sum())
    f32 = type(model)(dataclasses.replace(cfg, dtype="float32",
                                          **(f32_over or {})))
    diff, gap, held = _decode_gap(
        _decode_pass(f32, params, prompt),
        f32.prefill(params, {"tokens": prompt}),
        f"{tag} decode vs prefill in float32 compute")
    log(f"[{tag}] generate {(b, s)} + {n_gen} greedy tokens: {gen_s:.3f} s, "
        f"{steps} decode steps, {gen_s / steps * 1e3:.3f} ms per step (host "
        f"clock); decode vs prefill at the prompt's last token, float32 "
        f"compute: max |dlogit| {diff:.4g} (bar {LM_TOL}), smallest top-2 "
        f"gap {gap:.4g}, argmax equal in the {held} of {b} rows whose gap "
        f"exceeds twice it; bfloat16 compute: max |dlogit| {bf16_diff:.4g}, "
        f"argmax equal in {bf16_same} of {b} rows")
    return dict(batch=b, prompt=s, gen=n_gen, wall_s=gen_s,
                decode_steps=steps, ms_per_decode_step=gen_s / steps * 1e3,
                max_abs_dlogit_decode_vs_prefill_f32=diff, min_top2_gap=gap,
                rows_held_to_argmax=held,
                max_abs_dlogit_decode_vs_prefill_bf16=bf16_diff,
                argmax_equal_rows_bf16=bf16_same)


def zamba_layer0(model, params, tokens):
    """Layer 0's q = C, k = B, v and log_w as ``ZambaModel.prefill`` hands
    them to the scan (q and k broadcast over heads, log_w contiguous)."""
    from repro_torch.models.common import take_layer
    from repro_torch.nn import mamba
    from repro_torch.nn.layers import embed, rmsnorm
    cfg = model.cfg
    x = embed(tokens, params["embedding"], torch.bfloat16)
    lp = take_layer(params["layers"], 0)
    _, q, k, v, log_w, _, _ = mamba._conv_ssd(
        lp["mix"], rmsnorm(x, lp["ln"], cfg.norm_eps), cfg, None,
        torch.bfloat16)
    return q, k, v, log_w.contiguous()


def zamba_shared0_qkv(model, params, tokens):
    """Shared block 0's q, k, v at its first application, as
    ``ZambaModel.prefill`` hands them to the attention impl: the first
    group's mamba layers, rmsnorm, projection, rope."""
    from repro_torch.models.common import take_layer
    from repro_torch.nn import mamba
    from repro_torch.nn.attention import project_qkv
    from repro_torch.nn.layers import embed, rmsnorm
    cfg = model.cfg
    x = embed(tokens, params["embedding"], torch.bfloat16)
    b, s, _ = x.shape
    for i in range(model.group_sizes[0]):
        lp = take_layer(params["layers"], i)
        m, _ = mamba.mamba_block(lp["mix"], rmsnorm(x, lp["ln"],
                                                    cfg.norm_eps), cfg)
        x = x + m
    sp = take_layer(params["shared"], 0)
    positions = torch.arange(s, device=x.device).expand(b, s)
    return project_qkv(sp["attn"], rmsnorm(x, sp["ln1"], cfg.norm_eps),
                       positions, cfg.rope_theta, torch.bfloat16)


def _flash_layer_check(tag, fa_ops, qkv, s, window_cfg, what):
    window = window_cfg if window_cfg and s > window_cfg else None
    err, moved, rms = check_flash(fa_ops, *qkv, True, window, what)
    log(f"[{tag}] {what}: kernel vs plain on the model's q, k, v (D = "
        f"{qkv[0].shape[-1]}): max abs err {err:.3g} (output RMS "
        f"{rms:.3g}, bar {FLASH_TOL[torch.bfloat16]})"
        + ("" if moved is None else f"; without the window {moved} "
           f"elements fall beyond the bar"))
    return dict(max_abs_err=err, out_rms=rms, window=window,
                beyond_bar_without_window=moved)


def phase_serve_zamba(counted, report):
    """zamba2-7b at full width and depth (81 mamba layers, 2 shared
    attention blocks applied 14 times) through the port's serving entry
    points: ``ZambaModel.prefill`` counted (a prefill: 14
    ``flash_attention`` launches at D = 112, 81 ``ssm_scan`` calls of 3
    kernels), against the same model through ``"dot"`` and the plain
    scan; layer 0's SSD inputs through ``ssm_scan`` against its plain
    version (and timed there, at zamba's shapes), shared block 0's q, k,
    v through the kernel against its plain version; ``serve.generate``
    and decode against prefill.  The model is freed afterwards."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.ssm_scan import ops as ss_ops
    from repro_torch.models.api import build_model
    from repro_torch.models.zamba import ZambaModel
    from repro_torch.nn.mamba import dims
    from repro_torch.nn.param import count_params

    tag = "serve-zamba"
    dev = torch.device("cuda")
    cfg = dataclasses.replace(get_config(ZAMBA_ARCH),
                              attention_impl="kernel")
    model = build_model(cfg)
    params, init_s = _timed(lambda: model.init(
        torch.Generator(device=dev).manual_seed(0), device=dev))
    n_params = count_params(params)
    groups = len(model.group_sizes)
    log(f"[{tag}] {cfg.name}: {n_params:,} parameters (float32, drawn on "
        f"the card from seed 0) in {init_s:.3f} s; {cfg.num_layers} mamba "
        f"layers in {groups} groups {model.group_sizes}, "
        f"{cfg.hybrid.num_shared_blocks} shared blocks of {cfg.num_heads} "
        f"heads of {cfg.resolved_head_dim()}, SSD {model.cfg.ssm}; compute "
        f"dtype {cfg.dtype}, attention_impl={cfg.attention_impl}, "
        f"scan_impl={model.scan_impl}")
    per_call = len(SSM_KERNELS)
    per_prefill = {"flash_attention": groups,
                   "ssm_scan": per_call * cfg.num_layers}
    plain = ZambaModel(dataclasses.replace(cfg, attention_impl="dot"),
                       scan_impl="plain")
    launches, batches, rows = _serve_prefills(tag, model, plain, params,
                                              counted, per_prefill)
    prompts = [x["tokens"] for x in batches]
    out = dict(params=n_params, init_s=init_s, launches=launches,
               per_prefill=per_prefill, prefill=rows, ssm_rows=[])
    nheads = dims(cfg)[1]
    n, hd, chunk = cfg.ssm.state_dim, cfg.ssm.head_dim, cfg.ssm.chunk
    for (b, s), p, row in zip(PREFILLS, prompts, rows):
        q, k, v, lw = zamba_layer0(model, params, p)
        c = check_ssm(ss_ops, q, k, v, lw, chunk, "mamba", None, None,
                      f"{tag} layer 0 of prefill {(b, s)}")
        # JAX's init takes a stacked leaf's fan-in over the layer axis
        # too, so the 81 layers' projections draw 9x smaller and layer
        # 0's y is ~2e-7, under the bar's atol; the same inputs with C, B
        # and v scaled to unit RMS (the broadcasts and decays kept) hold
        # the kernels to the bar's rtol
        unit = [t / t.float().square().mean().sqrt().to(t.dtype)
                for t in (q[:, :, :1], k[:, :, :1], v)]
        cu = check_ssm(ss_ops, unit[0].expand_as(q), unit[1].expand_as(k),
                       unit[2], lw, chunk, "mamba", None, None,
                       f"{tag} layer 0 of prefill {(b, s)}, unit RMS")
        del unit
        row.update({f"layer0_ssm_{k_}": v_ for k_, v_ in c.items()})
        row.update({f"layer0_unit_ssm_{k_}": v_ for k_, v_ in cu.items()})
        # the function's bytes: C and B once each (broadcast over heads),
        # v, log_w (as the model materializes it) and y; the state out
        flops = ssm_flops(b, s, nheads, n, hd, chunk, "mamba")
        nbytes = (2 * b * s * n * q.element_size()
                  + 2 * v.numel() * v.element_size() + lw.numel() * 4
                  + 4 * b * nheads * n * hd)
        b_ms, b_by = bound(nbytes, flops, PEAK_TF32_PER_S)
        macs = ssm_kernel_macs(b, s, nheads, n, hd, chunk, True)
        run = lambda: ss_ops.gla_chunked(  # noqa: E731
            q, k, v, lw, chunk=chunk, variant="mamba")
        srow = dict(shape=[b, s, nheads, n, hd], variant="mamba",
                    regime="zamba layer 0", dtype="bfloat16",
                    path=f"{ZAMBA_ARCH} prefills {PREFILLS}", **c,
                    **{f"unit_rms_{k_}": v_ for k_, v_ in cu.items()},
                    flops=flops, bytes=nbytes, ms=cuda_ms(run, 10),
                    plain_ms=cuda_ms(lambda: ss_ops.gla_chunked_plain(
                        q, k, v, lw, chunk=chunk, variant="mamba"), 2),
                    library_ms=None, bound_ms=b_ms, bound_by=b_by,
                    kernel_products_ms=2 * macs / PEAK_TF32_PER_S * 1e3)
        srow["device_us"], srow["device_records"] = ssm_device_us(ss_ops,
                                                                  run)
        out["ssm_rows"].append(srow)
        parts = device_parts(srow)
        log(f"[{tag}] ssm_scan on layer 0's inputs of prefill {(b, s)} "
            f"({b}, {s}, {nheads}, {n}, {hd}) mamba bf16, q = C and k = B "
            f"broadcast over heads: {srow['ms']:.4f} ms kernels, "
            f"{srow['plain_ms']:.4f} ms plain, bound {b_ms:.4f} ms "
            f"({b_by}; the kernels' products "
            f"{srow['kernel_products_ms']:.4f} ms at the TF32 peak); "
            f"device us a call: {parts}; "
            f"{ssm_note(c, SSM_TOL[torch.bfloat16])}; C, B and v at unit "
            f"RMS: {ssm_note(cu, SSM_TOL[torch.bfloat16])}")
        del q, k, v, lw
        row["shared0_flash"] = _flash_layer_check(
            tag, fa_ops, zamba_shared0_qkv(model, params, p), s,
            cfg.sliding_window, f"shared block 0 of prefill {(b, s)}")
        torch.cuda.empty_cache()
    out["generate"] = _serve_generate(tag, model, params)
    report["serve_zamba"] = out
    del params, model, plain
    torch.cuda.empty_cache()
    return out


def phase_serve_gemma(counted, report):
    """gemma-7b at full width and depth (28 layers, 16 heads of 256,
    GeGLU, tied embeddings) through the port's serving entry points:
    ``DecoderLM.prefill`` counted (28 ``flash_attention`` launches at
    D = 256 a prefill) against the same model through ``"dot"``, layer
    0's q, k, v through the kernel against its plain version,
    ``serve.generate`` and decode against prefill.  The model is freed
    afterwards."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.models.api import build_model
    from repro_torch.nn.param import count_params

    tag = "serve-gemma"
    dev = torch.device("cuda")
    cfg = dataclasses.replace(get_config(GEMMA_ARCH),
                              attention_impl="kernel")
    model = build_model(cfg)
    params, init_s = _timed(lambda: model.init(
        torch.Generator(device=dev).manual_seed(0), device=dev))
    n_params = count_params(params)
    log(f"[{tag}] {cfg.name}: {n_params:,} parameters (float32, drawn on "
        f"the card from seed 0) in {init_s:.3f} s; {cfg.num_layers} layers, "
        f"d_model {cfg.d_model}, {cfg.num_heads} heads of "
        f"{cfg.resolved_head_dim()}, {cfg.mlp_activation}, tied embeddings "
        f"{cfg.tie_embeddings}; compute dtype {cfg.dtype}")
    per_prefill = {"flash_attention": cfg.num_layers}
    dot = build_model(dataclasses.replace(cfg, attention_impl="dot"))
    launches, batches, rows = _serve_prefills(tag, model, dot, params,
                                              counted, per_prefill)
    for (b, s), x, row in zip(PREFILLS, batches, rows):
        row["layer0_flash"] = _flash_layer_check(
            tag, fa_ops, layer0_qkv(model, params, x), s,
            cfg.sliding_window, f"layer 0 of prefill {(b, s)}")
        torch.cuda.empty_cache()
    out = dict(params=n_params, init_s=init_s, launches=launches,
               per_prefill=per_prefill, prefill=rows,
               generate=_serve_generate(tag, model, params))
    report["serve_gemma"] = out
    del params, model, dot
    torch.cuda.empty_cache()
    return out


def phase_serve_moe(counted, report):
    """The MoE decoders at full width, depth cut (MOE_PATHS), through the
    port's serving entry points: ``DecoderLM.prefill`` counted (one
    ``flash_attention`` launch a layer, D = 128 at GQA 6 and 5), against
    the same weights through ``"dot"`` with the routing pinned to the
    kernel route's (the flips and the capacity's drops reported), layer
    0's q, k, v through the kernel against its plain version,
    ``serve.generate``, and decode against prefill in float32 compute on
    JAX's dropless config (``capacity_factor = num_experts``: at 1.25 a
    prefill may drop choices that decode, one token a group, keeps).
    Each model is freed before the next loads."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.models.api import build_model
    from repro_torch.nn.param import count_params

    dev = torch.device("cuda")
    out = {}
    for arch, layers in MOE_PATHS:
        tag = f"serve-{arch.split('-')[0]}"
        full = get_config(arch)
        cfg = dataclasses.replace(full, num_layers=layers,
                                  attention_impl="kernel")
        model = build_model(cfg)
        params, init_s = _timed(lambda: model.init(
            torch.Generator(device=dev).manual_seed(0), device=dev))
        n_params = count_params(params)
        moe = cfg.moe
        log(f"[{tag}] {cfg.name}: {n_params:,} parameters (float32, drawn "
            f"on the card from seed 0) in {init_s:.3f} s; {layers} of "
            f"{full.num_layers} layers (the depth cut; JAX's init takes a "
            f"stacked leaf's fan-in over the layers kept, so each draw is "
            f"{(full.num_layers / layers) ** 0.5:.2f}x the full model's), "
            f"d_model {cfg.d_model}, {cfg.num_heads}/{cfg.num_kv_heads} "
            f"heads of {cfg.resolved_head_dim()}, {moe.num_experts} "
            f"experts top-{moe.top_k} of d_ff {cfg.d_ff} "
            f"({cfg.mlp_activation}), capacity factor "
            f"{moe.capacity_factor}; compute dtype {cfg.dtype}")
        per_prefill = {"flash_attention": cfg.num_layers}
        dot = build_model(dataclasses.replace(cfg, attention_impl="dot"))
        launches, batches, rows = _serve_prefills(
            tag, model, dot, params, counted, per_prefill, pin=True)
        for (b, s), x, row in zip(PREFILLS, batches, rows):
            row["layer0_flash"] = _flash_layer_check(
                tag, fa_ops, layer0_qkv(model, params, x), s,
                cfg.sliding_window, f"layer 0 of prefill {(b, s)}")
            torch.cuda.empty_cache()
        del batches
        dropless = dict(moe=dataclasses.replace(
            moe, capacity_factor=float(moe.num_experts)))
        out[arch] = dict(layers=layers, params=n_params, init_s=init_s,
                         launches=launches, per_prefill=per_prefill,
                         prefill=rows,
                         generate=_serve_generate(tag, model, params,
                                                  f32_over=dropless))
        del params, model, dot
        torch.cuda.empty_cache()
    report["serve_moe"] = out
    return out


def phase_serve_vlm(counted, report):
    """internvl2-2b at full width and depth (24 layers, 16/8 heads of
    128) through the port's serving entry points: ``DecoderLM.prefill``
    of 256 seeded frontend rows (the stub vision encoder's output)
    followed by text, PREFILLS the prompts' whole length, counted (24
    ``flash_attention`` launches a prefill, GQA 2), against the same
    model through ``"dot"``; layer 0's q, k, v through the kernel against
    its plain version; ``serve.generate`` on text, and decode against
    prefill.  The model is freed afterwards."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.models.api import build_model
    from repro_torch.nn.param import count_params

    tag = "serve-vlm"
    dev = torch.device("cuda")
    cfg = dataclasses.replace(get_config(VLM_ARCH), attention_impl="kernel")
    model = build_model(cfg)
    params, init_s = _timed(lambda: model.init(
        torch.Generator(device=dev).manual_seed(0), device=dev))
    n_params = count_params(params)
    rows_in = cfg.frontend.num_embeds
    log(f"[{tag}] {cfg.name}: {n_params:,} parameters (float32, drawn on "
        f"the card from seed 0) in {init_s:.3f} s; {cfg.num_layers} layers, "
        f"d_model {cfg.d_model}, {cfg.num_heads}/{cfg.num_kv_heads} heads "
        f"of {cfg.resolved_head_dim()}; {rows_in} {cfg.frontend.kind} "
        f"frontend rows of {cfg.frontend.embed_dim} before the text; "
        f"compute dtype {cfg.dtype}")

    def make_batch(b, s, g):
        return {"tokens": torch.randint(0, cfg.vocab_size, (b, s - rows_in),
                                        device=dev, generator=g),
                "embeds": torch.randn(b, rows_in, cfg.frontend.embed_dim,
                                      device=dev, generator=g)}
    per_prefill = {"flash_attention": cfg.num_layers}
    dot = build_model(dataclasses.replace(cfg, attention_impl="dot"))
    launches, batches, rows = _serve_prefills(
        tag, model, dot, params, counted, per_prefill, make_batch=make_batch)
    for (b, s), x, row in zip(PREFILLS, batches, rows):
        row["layer0_flash"] = _flash_layer_check(
            tag, fa_ops, layer0_qkv(model, params, x), s,
            cfg.sliding_window, f"layer 0 of prefill {(b, s)}")
        torch.cuda.empty_cache()
    out = dict(params=n_params, init_s=init_s, launches=launches,
               per_prefill=per_prefill, frontend_rows=rows_in, prefill=rows,
               generate=_serve_generate(tag, model, params))
    report["serve_vlm"] = out
    del params, model, dot, batches
    torch.cuda.empty_cache()
    return out


def _encdec_decode(model, params, src, prompt, n_gen):
    """The encoder-decoder's serving loop: the cross cache from
    ``_encode``'s memory of ``src``, then ``decode_step`` over ``prompt``
    token by token and ``n_gen`` greedy tokens.  Returns (the logits at
    the prompt's last token, the generated tokens, the decode steps' host
    seconds)."""
    b, s = prompt.shape
    dev = prompt.device
    with torch.no_grad():
        cross = model.build_cross_cache(params, model._encode(params, src))
    cache = dict(model.init_cache(b, s + n_gen, device=dev), cross=cross)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(s):
        logits, cache = model.decode_step(params, cache, {
            "token": prompt[:, i:i + 1], "pos": torch.full((b,), i,
                                                           device=dev)})
    last = logits
    toks = []
    for j in range(n_gen):
        nxt = logits[:, -1].argmax(-1)
        toks.append(nxt)
        logits, cache = model.decode_step(params, cache, {
            "token": nxt[:, None], "pos": torch.full((b,), s + j,
                                                     device=dev)})
    torch.cuda.synchronize()
    return last, torch.stack(toks, 1) if toks else None, \
        time.perf_counter() - t0


def phase_serve_encdec(counted, report):
    """seamless-m4t-large-v2 at full width and depth (24 encoder and 24
    decoder layers, d_model 1024, 16 heads of 64) through the port's
    entry points, as JAX's tests drive it: ``prefill`` of ENCDEC_PREFILL
    tokens over (B, 1024, 1024) seeded stub frames, counted (no kernel
    runs: JAX's encoder-decoder passes no attention impl, so every
    attention takes the plain route); ``build_cross_cache`` from
    ``_encode``'s memory, then ``decode_step`` over a (4, 64) prompt and
    32 greedy tokens (ms a decode step), and decode against prefill in
    float32 compute (the bf16 gap beside it).  The model is freed
    afterwards."""
    from repro_torch.configs import get_config
    from repro_torch.models.api import build_model
    from repro_torch.models.encdec import EncDecModel
    from repro_torch.nn.param import count_params

    tag = "serve-encdec"
    dev = torch.device("cuda")
    cfg = get_config(ENCDEC_ARCH)
    model = build_model(cfg)
    params, init_s = _timed(lambda: model.init(
        torch.Generator(device=dev).manual_seed(0), device=dev))
    n_params = count_params(params)
    enc = cfg.encdec.encoder_seq
    log(f"[{tag}] {cfg.name}: {n_params:,} parameters (float32, drawn on "
        f"the card from seed 0) in {init_s:.3f} s; "
        f"{cfg.encdec.num_encoder_layers} encoder + {cfg.num_layers} "
        f"decoder layers, d_model {cfg.d_model}, {cfg.num_heads} heads of "
        f"{cfg.resolved_head_dim()}, {enc} source frames; compute dtype "
        f"{cfg.dtype}; every attention on the plain route, as in JAX")
    gen = torch.Generator(device=dev).manual_seed(1)
    b, s = ENCDEC_PREFILL
    batch = {"src_embeds": torch.randn(b, enc, cfg.d_model, device=dev,
                                       generator=gen),
             "tokens": torch.randint(0, cfg.vocab_size, (b, s), device=dev,
                                     generator=gen)}
    zero_counts(counted)
    logits, first_s = _timed(lambda: model.prefill(params, batch))
    launches = read_counts(counted)
    if any(launches.values()):
        raise AssertionError(f"[{tag}] the encoder-decoder launched "
                             f"{launches}: JAX runs it on plain code")
    torch.cuda.reset_peak_memory_stats()
    again, steady_s = _timed(lambda: model.prefill(params, batch))
    peak = torch.cuda.max_memory_allocated()
    if logits.shape != (b, 1, cfg.vocab_size) \
            or not torch.isfinite(logits).all() \
            or not torch.equal(again, logits):
        raise AssertionError(f"[{tag}] prefill {(b, s)}: logits "
                             f"{tuple(logits.shape)}, finite "
                             f"{bool(torch.isfinite(logits).all())}, "
                             f"deterministic {torch.equal(again, logits)}")
    log(f"[{tag}] launches in the path: {launches} (no kernel, as in JAX); "
        f"prefill {(b, s)} over ({b}, {enc}, {cfg.d_model}) frames: first "
        f"call {first_s:.4f} s, again {steady_s:.4f} s "
        f"({b * s / steady_s:,.0f} tokens/s), peak memory "
        f"{peak / 1e9:.2f} GB")
    del logits, again
    # decode: a (4, 64) prompt over the prefill's frames, 32 greedy
    pb, ps, n_gen = b, 64, 32
    src = batch["src_embeds"]
    prompt = torch.randint(0, cfg.vocab_size, (pb, ps), device=dev,
                           generator=gen)
    _encdec_decode(model, params, src, prompt[:, :2], 2)      # warm-up
    dec, toks, dec_s = _encdec_decode(model, params, src, prompt, n_gen)
    steps = ps + n_gen
    if not bool(((toks >= 0) & (toks < cfg.vocab_size)).all()):
        raise AssertionError(f"[{tag}] generated tokens out of range")
    pre = model.prefill(params, {"src_embeds": src, "tokens": prompt})
    bf16_diff = float((dec.float() - pre.float()).abs().max())
    bf16_same = int((dec.argmax(-1) == pre.argmax(-1)).sum())
    f32 = EncDecModel(dataclasses.replace(cfg, dtype="float32"))
    diff, gap, held = _decode_gap(
        _encdec_decode(f32, params, src, prompt, 0)[0],
        f32.prefill(params, {"src_embeds": src, "tokens": prompt}),
        f"{tag} decode vs prefill in float32 compute")
    out = dict(params=n_params, init_s=init_s, launches=launches,
               prefill=dict(shape=[b, s], frames=enc, first_s=first_s,
                            steady_s=steady_s, tok_per_s=b * s / steady_s,
                            peak_gb=peak / 1e9),
               decode=dict(batch=pb, prompt=ps, gen=n_gen, wall_s=dec_s,
                           decode_steps=steps,
                           ms_per_decode_step=dec_s / steps * 1e3,
                           max_abs_dlogit_decode_vs_prefill_f32=diff,
                           min_top2_gap=gap, rows_held_to_argmax=held,
                           max_abs_dlogit_decode_vs_prefill_bf16=bf16_diff,
                           argmax_equal_rows_bf16=bf16_same))
    log(f"[{tag}] decode over the cross cache: {steps} steps ({ps} prompt "
        f"+ {n_gen} greedy) in {dec_s:.3f} s, {dec_s / steps * 1e3:.3f} ms "
        f"per step (host clock); decode vs prefill at the prompt's last "
        f"token, float32 compute: max |dlogit| {diff:.4g} (bar {LM_TOL}), "
        f"smallest top-2 gap {gap:.4g}, argmax equal in the {held} of {pb} "
        f"rows whose gap exceeds twice it; bfloat16 compute: max |dlogit| "
        f"{bf16_diff:.4g}, argmax equal in {bf16_same} of {pb} rows")
    report["serve_encdec"] = out
    del params, model, f32, batch, src
    torch.cuda.empty_cache()
    return out


def _train_batch(vocab, b, s, seed):
    """A (B, S) batch of random tokens and labels on the card."""
    r = np.random.default_rng(seed)
    return {k: torch.as_tensor(r.integers(0, vocab, (b, s)),
                               device="cuda") for k in ("tokens", "labels")}


def _profile_train_steps(step_fn, params, opt_state, batch, steps=3):
    """Device busy share and the kernels' device time over ``steps``
    train steps (a torch.profiler window after a warm-up step)."""
    from torch.profiler import ProfilerActivity, profile
    params, opt_state, _, _ = step_fn(params, opt_state, batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            params, opt_state, _, _ = step_fn(params, opt_state, batch)
        torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [(e.key, e.self_device_time_total, e.count)
               for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0]
    busy = sum(k[1] for k in kernels)
    kernels.sort(key=lambda k: -k[1])
    return dict(steps=steps, wall_ms_a_step=wall_us / steps / 1e3,
                device_ms_a_step=busy / steps / 1e3,
                busy_share=busy / wall_us if busy else None,
                kernels_a_step=sum(k[2] for k in kernels) / steps,
                top=[dict(name=k[0][:80], ms_a_step=k[1] / steps / 1e3,
                          calls_a_step=k[2] / steps) for k in kernels[:10]])


def card_vs_cpu_steps(card, cpu, init):
    """Two runs' (losses, first-step gradients, parameters after the
    steps) compared: the largest relative loss gap, the largest leaf
    gradient gap over its norm, and each leaf's change apart over its
    norm on the elements whose changes agree within TRAIN_LR, beside the
    count (and the largest share of a leaf) of the elements apart by
    more: Adam's first steps are about +-lr by the gradient's sign, so a
    near-zero gradient whose sign the summation order flips moves its
    element by a whole step."""
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(card[0], cpu[0]))
    grad_rel = max(float((a - b).norm() / b.norm().clamp_min(1e-30))
                   for a, b in zip(card[1], cpu[1]))
    delta_rel, flipped, share = 0.0, 0, 0.0
    for a, b, p0 in zip(card[2], cpu[2], init):
        da, db = a - p0, b - p0
        flip = (da - db).abs() > TRAIN_LR
        keep = ~flip
        delta_rel = max(delta_rel, float(
            (da - db)[keep].norm() / db[keep].norm().clamp_min(1e-30)))
        flipped += int(flip.sum())
        share = max(share, float(flip.double().mean()))
    return dict(losses_card=card[0], losses_cpu=cpu[0], loss_rel=loss_rel,
                grad_rel=grad_rel, delta_rel=delta_rel, flipped=flipped,
                flipped_share=share)


def phase_train(counted, report):
    """Phase 7: LM training through the port's entry points.  (a)
    ``launch.train.main`` trains repro-100m at full width and depth for
    TRAIN_RUN's steps on ``LMStream`` (finite losses that fall by at
    least TRAIN_MIN_DROP nat; ms a step and tokens/s; peak memory), a
    profiler window over three more steps, then a second run restores the
    step TRAIN_RUN's checkpoint wrote (bit for bit) and trains on.  (b)
    Three train steps of each TRAIN_CARD_CPU family at ``reduced()`` in
    fp32 on the card and on the CPU port from the same parameters and
    batches.  (c) ``attention_impl="kernel"`` under grad raises
    (no backward kernel); under ``no_grad`` the loss runs
    ``flash_attention`` once a layer, counted, within KERNEL_LOSS_TOL of
    the dot route."""
    from repro_torch.checkpoint import load_arrays
    from repro_torch.checkpoint.store import flatten_tree
    from repro_torch.configs import get_config
    from repro_torch.data import LMStream, LMStreamConfig
    from repro_torch.launch import steps as tsteps
    from repro_torch.launch import train
    from repro_torch.models.api import build_model
    from repro_torch.nn.param import tree_leaves, tree_map
    from repro_torch.optim import adamw

    out = {}
    steps, b, s, log_every, every, steps2 = TRAIN_RUN
    ckpt = ROOT / "build" / "train"
    shutil.rmtree(ckpt, ignore_errors=True)
    argv = ["--arch", TRAIN_ARCH, "--batch", str(b), "--seq", str(s),
            "--log-every", str(log_every), "--ckpt-dir", str(ckpt),
            "--ckpt-every", str(every), "--devices", "1",
            "--device", "cuda"]
    torch.cuda.empty_cache()
    live = torch.cuda.memory_allocated()      # earlier phases' tensors
    torch.cuda.reset_peak_memory_stats()
    zero_counts(counted)
    run = train.main(argv + ["--steps", str(steps)])
    launches = read_counts(counted)
    peak = torch.cuda.max_memory_allocated() - live
    losses = run["losses"]
    first, last = losses[min(losses)], losses[max(losses)]
    if not all(np.isfinite(v) for v in losses.values()) \
            or first - last < TRAIN_MIN_DROP:
        raise AssertionError(f"[train] {TRAIN_ARCH}: logged losses "
                             f"{losses} do not fall by {TRAIN_MIN_DROP}")
    if any(launches.values()):
        raise AssertionError(f"[train] the training path launched "
                             f"{launches}: it trains through plain code")
    a = dict(params=run["n_params"], steps=steps, batch=b, seq=s,
             losses=losses, first_step_s=run["first_step_s"],
             ms_a_step=run["step_s"] * 1e3,
             tokens_s=b * s / run["step_s"], ckpt_write_s=run["ckpt_s"],
             wall_s=run["wall_s"], peak_bytes=peak, live_bytes=live,
             launches=launches)
    log(f"[train] {TRAIN_ARCH}: {run['n_params']:,} parameters, {steps} "
        f"steps at ({b}, {s}); loss {first:.4f} -> {last:.4f}; first step "
        f"{run['first_step_s'] * 1e3:.1f} ms; steps 2-{steps} "
        f"{a['ms_a_step']:.3f} ms a step, {a['tokens_s']:.0f} tokens/s; "
        f"checkpoint writes {run['ckpt_s']:.3f} s; peak memory "
        f"{peak / 1e9:.2f} GB above the {live / 1e9:.2f} GB earlier phases "
        f"hold; kernel launches {launches}")
    step_fn = tsteps.make_train_step(run["cfg"],
                                     opt_state_dtype=torch.float32)
    stream = LMStream(LMStreamConfig(vocab_size=run["cfg"].vocab_size))
    toks, labs = stream.sample(b, s, seed=steps + 1)
    batch = {"tokens": torch.as_tensor(toks, device="cuda"),
             "labels": torch.as_tensor(labs, device="cuda")}
    a["profile"] = _profile_train_steps(step_fn, run["params"],
                                        run["opt_state"], batch)
    pr = a["profile"]
    log(f"[train] profile of {pr['steps']} steps: {pr['wall_ms_a_step']:.3f}"
        f" ms a step on the host clock, {pr['device_ms_a_step']:.3f} ms of "
        f"kernels (busy share {pr['busy_share']}), "
        f"{pr['kernels_a_step']:.0f} kernels a step; top: " + "; ".join(
            f"{k['name']} {k['ms_a_step']:.3f} ms x{k['calls_a_step']:.0f}"
            for k in pr["top"][:6]))
    del run, step_fn
    torch.cuda.empty_cache()

    run2 = train.main(argv + ["--steps", str(steps2)])
    _, saved = load_arrays(str(ckpt), every)
    restored = flatten_tree(run2["restored"])
    unequal = [k for k, v in restored.items()
               if not torch.equal(v.cpu(), torch.from_numpy(saved[k]))]
    if run2["start"] != every or unequal \
            or sorted(restored) != sorted(saved) \
            or not all(np.isfinite(v) for v in run2["losses"].values()):
        raise AssertionError(f"[train] restore: start {run2['start']}, "
                             f"leaves unequal {unequal}, losses "
                             f"{run2['losses']}")
    a["restore"] = dict(start=run2["start"], steps=steps2,
                        losses=run2["losses"], leaves=len(restored))
    log(f"[train] restored step {run2['start']}: {len(restored)} leaves bit "
        f"for bit as saved; steps {every + 1}-{steps2} losses "
        f"{run2['losses']}")
    out["full"] = a

    # (c) the kernel route under training, on the restored run's weights
    params = run2["params"]
    cfg = get_config(TRAIN_ARCH)
    kmodel = build_model(dataclasses.replace(cfg, attention_impl="kernel"))
    dmodel = build_model(dataclasses.replace(cfg, attention_impl="dot"))
    kbatch = {"tokens": batch["tokens"], "labels": batch["labels"]}
    try:
        tsteps.value_and_grad(lambda p: kmodel.loss(p, kbatch), params)
    except RuntimeError as e:
        if "flash_attention" not in str(e):
            raise
        refused = str(e).split(";")[0]
    else:
        raise AssertionError("[train] a loss through attention_impl="
                             "'kernel' under grad did not raise")
    with torch.no_grad():
        zero_counts(counted)
        lk, _ = kmodel.loss(params, kbatch)
        torch.cuda.synchronize()
        klaunch = read_counts(counted)
        ld, _ = dmodel.loss(params, kbatch)
    gap = abs(float(lk) - float(ld))
    if klaunch["flash_attention"] != cfg.num_layers or gap > KERNEL_LOSS_TOL:
        raise AssertionError(f"[train] kernel-route loss: launches "
                             f"{klaunch}, |loss - dot's| {gap}")
    out["kernel_route"] = dict(refused=refused, launches=klaunch,
                               loss_kernel=float(lk), loss_dot=float(ld),
                               gap=gap)
    log(f"[train] attention_impl='kernel' under grad raises ({refused}); "
        f"under no_grad at ({b}, {s}) bf16: {klaunch['flash_attention']} "
        f"flash_attention launches, loss {float(lk):.5f} against the dot "
        f"route's {float(ld):.5f} (gap {gap:.3g}, bar {KERNEL_LOSS_TOL})")
    del run2, params, kmodel, dmodel
    torch.cuda.empty_cache()

    # (b) card against CPU, three steps each, reduced, fp32
    out["card_vs_cpu"] = {}
    for arch in TRAIN_CARD_CPU:
        cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
        model = build_model(cfg)
        init = model.init(torch.Generator().manual_seed(0), "cpu")
        step_fn = tsteps.make_train_step(cfg, opt_state_dtype=torch.float32)
        res = {}
        for dev in ("cuda", "cpu"):
            p = tree_map(lambda x: x.to(dev), init)
            st = adamw(TRAIN_LR, weight_decay=0.1).init(p)
            losses = []
            for i in range(3):
                r = np.random.default_rng(100 + i)
                bt = {k: torch.as_tensor(r.integers(0, cfg.vocab_size,
                                                    (2, 128)), device=dev)
                      for k in ("tokens", "labels")}
                if i == 0:
                    _, g = tsteps.value_and_grad(
                        lambda q: model.loss(q, bt), p)
                    grads = [x.double().cpu() for x in tree_leaves(g)]
                p, st, loss, _ = step_fn(p, st, bt)
                losses.append(float(loss))
            res[dev] = (losses, grads, [x.double().cpu()
                                        for x in tree_leaves(p)])
        c = out["card_vs_cpu"][arch] = card_vs_cpu_steps(
            res["cuda"], res["cpu"], [x.double() for x in tree_leaves(init)])
        log(f"[train] {arch} reduced fp32, 3 steps at (2, 128), card vs "
            f"CPU: losses {c['losses_card']} vs {c['losses_cpu']} (largest "
            f"relative gap {c['loss_rel']:.3g}); first-step gradients "
            f"apart by at most {c['grad_rel']:.3g} of a leaf's norm; "
            f"parameter changes by {c['delta_rel']:.3g} (bar "
            f"{TRAIN_DELTA_TOL[arch]}) past {c['flipped']} flipped "
            f"elements (at most {c['flipped_share']:.3g} of a leaf)")
        if c["loss_rel"] > 1e-5 or c["grad_rel"] > TRAIN_GRAD_TOL \
                or c["delta_rel"] > TRAIN_DELTA_TOL[arch] \
                or c["flipped_share"] > TRAIN_FLIP_SHARE:
            raise AssertionError(f"[train] {arch}: card and CPU steps "
                                 f"differ: {c}")
    report["train"] = out
    return out


def phase_lm_clients(ac, counted, report):
    """Phase 7d: ST-LF over LM clients through
    ``repro_torch.stlf_lm_clients.main``, counted: ``alpha_combine``
    once, at S = T = 6 and the clients' P; the kernel against its plain
    version on the run's own transfer inputs, timed beside ``matmul``
    and its bound; at least one target, unit alpha columns there, and
    each target's error falling after the transfer."""
    from repro_torch import stlf_lm_clients as lmc
    from repro_torch.nn.param import flatten_to_vector

    zero_counts(counted)
    t0 = time.perf_counter()
    r = lmc.main(["--device", "cuda"])
    wall = time.perf_counter() - t0
    launches = read_counts(counted)
    psi, alpha = r["psi"], r["alpha"]
    tgt = np.flatnonzero(psi == 1.0)
    if launches["alpha_combine"] != 1 or any(
            v for k, v in launches.items() if k != "alpha_combine"):
        raise AssertionError(f"[stlf-lm] launches {launches}, want one "
                             f"alpha_combine")
    if not len(tgt) or not np.allclose(alpha[:, tgt].sum(0), 1.0,
                                       atol=1e-6) \
            or not all(t["after"] < t["before"]
                       for t in r["targets"].values()):
        raise AssertionError(f"[stlf-lm] psi {psi}, alpha {alpha}, "
                             f"targets {r['targets']}")
    theta = flatten_to_vector(r["stacked"], lead=1).contiguous()
    al = torch.as_tensor(alpha, dtype=torch.float32, device="cuda")
    s_, p_ = theta.shape
    out = ac.alpha_combine(theta, al)
    torch.cuda.synchronize()
    plain = ac.alpha_combine_plain(theta, al)
    err = float((out - plain).abs().max())
    if not torch.allclose(out, plain, rtol=1e-5, atol=1e-5):
        raise AssertionError(f"[stlf-lm] alpha_combine {(s_, s_, p_)}: max "
                             f"abs err {err} beyond 1e-5")
    b_ms, b_by = bound(4 * (s_ * p_ + s_ * s_ + s_ * p_), 2 * s_ * s_ * p_,
                       PEAK_TF32_PER_S)
    row = dict(path="stlf_lm_clients transfer", shape=[s_, s_, p_],
               max_abs_err=err,
               ms=cuda_ms(lambda: ac.alpha_combine(theta, al), 200),
               plain_ms=cuda_ms(lambda: ac.alpha_combine_plain(theta, al),
                                200),
               library_ms=cuda_ms(lambda: torch.matmul(al.T, theta), 200),
               bound_ms=b_ms, bound_by=b_by)
    res = dict(wall_s=wall, walls=r["walls"], launches=launches,
               psi=psi.tolist(), alpha=np.round(alpha, 4).tolist(),
               eps_hat=r["eps_hat"].tolist(), div=r["div"].tolist(),
               targets=r["targets"], kernel=row)
    report["stlf_lm_clients"] = res
    split = ", ".join(f"{k} {v:.3f}" for k, v in r["walls"].items())
    log(f"[stlf-lm] {wall:.3f} s ({split}); "
        f"psi {psi.astype(int).tolist()}; targets " + "; ".join(
            f"{d}: eps {t['before']:.4f} -> {t['after']:.4f} from "
            f"{t['sources']} (same domain {t['same_domain']})"
            for d, t in r["targets"].items())
        + f"; launches {launches}")
    log(f"[stlf-lm] alpha_combine at ({s_}, {s_}, {p_}): max abs err "
        f"{err:.3g}; {row['ms']:.4f} ms, plain {row['plain_ms']:.4f}, matmul "
        f"{row['library_ms']:.4f}, bound {b_ms:.4f} ({b_by})")
    return res


# phase 8, accounting: each kernel op's counted work against the bound
# column of PERF.md §6 (within ACCT_BOUND_TOL), and three steps counted on
# the card and on meta through their bundles.  The steps' FLOPs must be
# equal exactly (the same ops on the same shapes); their bytes within
# ACCT_BYTES_TOL: a count reads each op's operand and result sizes, which
# follow shapes and dtypes, except where a real kernel lays its output out
# otherwise than meta's shape function and a later reshape then copies on
# one side only (the CPU's plain flash version did until its op returned
# it contiguous: a clone of 0.66% of a reduced prefill's bytes; the CPU
# and meta now agree exactly on all three steps)
ACCT_BOUND_TOL = 0.01
ACCT_BYTES_TOL = 1e-2
# (batch, prompt) of the llama3.2-1b prefill on the kernel route; (batch,
# cache slots, the decoded position) of one decode step; (batch, seq) of
# phase 7's repro-100m train step
ACCT_PREFILL = (4, 2048)
ACCT_DECODE = (4, 2048, 64)
ACCT_TRAIN = (8, 512)
# the dry run's architecture, at the 16x16 mesh and on one card, the
# four input shapes
ACCT_DRYRUN_ARCH = LM_ARCH
# decode_32k on 16x16: rank 0's FLOPs x 256 over the one-card step's at
# most this (each rank's own rows and query heads in its attention; the
# k/v projection on every 'model' rank, as JAX's rule replicates the 8 kv
# heads on a model axis of 16: ~1.15)
ACCT_DRYRUN_DECODE_OVER_SHARE = 1.2
DRYRUN_SCRIPT = """
import sys
from repro_torch.launch import dryrun
for meshes in ([], ["--one-card"]):
    dryrun.main(["--arch", sys.argv[1], "--out", sys.argv[2]] + meshes)
"""


def start_dryrun():
    """The short dry run (phase 8c) in a child process on meta tensors,
    started at the beginning of the run so that its host work overlaps
    the card's phases: the partitioned count of ACCT_DRYRUN_ARCH x every
    input shape at 16x16 (rank 0 on a fake process group), then on one
    card."""
    out = ROOT / "build" / "dryrun_smoke"
    shutil.rmtree(out, ignore_errors=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1",
               CUDA_VISIBLE_DEVICES="")
    log_file = open(ROOT / "build" / "dryrun_smoke.log", "w")
    proc = subprocess.Popen(
        [sys.executable, "-c", DRYRUN_SCRIPT, ACCT_DRYRUN_ARCH, str(out)],
        cwd=ROOT, env=env, stdout=log_file, stderr=subprocess.STDOUT)
    atexit.register(lambda: proc.poll() is None and proc.kill())
    return proc, out, log_file


def _host_us(fn, calls=50):
    """Host microseconds a call of ``fn`` (enqueue only: no synchronize
    inside the loop), after a warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / calls * 1e6


def _acct_ops(fa, ss, ac, dg):
    """Each kernel at its PERF.md §6 shape: its public call (the wrapper:
    checks, then the op), the op through the dispatcher alone, the op's
    CUDA implementation called directly (allocation and launch), the raw
    launch (the C entry with its arguments made once and its output and
    scratch allocated once, and held in ``keep`` while the raw launch may
    write them), the table's bound (ms, by), the peak rate of its type,
    the counter it bumps and its kernels a call."""
    from repro_torch.kernels import _build
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(8)
    stream = torch.cuda.current_stream().cuda_stream
    out = []
    # flash_attention (4, 2048, 32/8, 64), causal, bf16
    b, s, h, kv, d = 4, 2048, 32, 8, 64
    q = torch.randn(b, s, h, d, device=dev, generator=gen).bfloat16()
    k = torch.randn(b, s, kv, d, device=dev, generator=gen).bfloat16()
    v = torch.randn(b, s, kv, d, device=dev, generator=gen).bfloat16()
    o = torch.empty_like(q)
    launch = _build.entry("flash_attention", "flash_attention_fwd",
                          fa._SIGNATURE)
    fargs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, h,
             kv, s, s, d, *q.stride()[:3], *k.stride()[:3],
             *v.stride()[:3], *o.stride()[:3], 1, 0, 1.0 / d ** 0.5,
             fa._DTYPES[q.dtype], stream)
    table = bound((2 * q.numel() + k.numel() + v.numel()) * 2,
                  4 * d * live_pairs(s, s, True, None) * b * h,
                  PEAK_BF16_PER_S)
    out.append(dict(
        name="flash_attention", call=lambda: fa.flash_attention(q, k, v),
        op=lambda: torch.ops.repro_torch.flash_attention(q, k, v, True,
                                                          None),
        impl=lambda: fa._flash_launch(q, k, v, True, None),
        raw=lambda: launch(*fargs), table=table, peak=PEAK_BF16_PER_S,
        counter=fa.flash_attention, kernels=1, keep=(o,)))
    # ssm_scan (4, 2048, 32, 64) rwkv, bf16 r/k/v, fp32 log_w, chunk 128
    x = ssm_inputs(4, 2048, 32, 64, "init", torch.bfloat16, gen)
    q2, k2, v2, lw, bonus, s0 = x
    b2, l2, h2, d2 = q2.shape
    y = torch.empty_like(v2)
    sf = torch.empty(b2, h2, d2, d2, device=dev)
    u = bonus.float().contiguous()
    s0f = s0.float().contiguous()
    kernels, floats = ss._plan(b2, l2, h2, d2, d2, 128)
    scratch = torch.empty(floats, device=dev)
    slaunch = _build.entry("ssm_scan", "ssm_scan_fwd", ss._SIGNATURE)
    sargs = (q2.data_ptr(), k2.data_ptr(), v2.data_ptr(), lw.data_ptr(),
             u.data_ptr(), s0f.data_ptr(), y.data_ptr(), sf.data_ptr(),
             scratch.data_ptr(), b2, l2, h2, d2, d2, 128, 1,
             *q2.stride()[:3], *k2.stride()[:3], *v2.stride()[:3],
             *lw.stride()[:3], *y.stride()[:3],
             *(ss._BF16[t.dtype] for t in (q2, k2, v2, lw)), stream)
    table = bound(q2.numel() * (4 * q2.element_size() + 4)
                  + 2 * 4 * b2 * h2 * d2 * d2,
                  ssm_flops(b2, l2, h2, d2, d2, 128, "rwkv"),
                  PEAK_TF32_PER_S)
    out.append(dict(
        name="ssm_scan", call=lambda: ss.gla_chunked(
            q2, k2, v2, lw, chunk=128, variant="rwkv", bonus=bonus,
            initial_state=s0),
        op=lambda: torch.ops.repro_torch.gla_chunked(
            q2, k2, v2, lw, 128, "rwkv", bonus, s0),
        impl=lambda: ss._gla_launch(q2, k2, v2, lw, 128, "rwkv", bonus, s0),
        raw=lambda: slaunch(*sargs), table=table, peak=PEAK_TF32_PER_S,
        counter=ss.gla_chunked, kernels=kernels,
        keep=(y, sf, u, s0f, scratch)))
    # alpha_combine S = T = 256, P = 48,158
    st, p = 256, 48158
    theta = torch.randn(st, p, device=dev, generator=gen)
    alpha = torch.rand(st, st, device=dev, generator=gen)
    alpha /= alpha.sum(0, keepdim=True)
    mixed = theta.new_empty((st, p))
    n_ac, nbytes = ac._plan(st, st)
    ac_scratch = theta.new_empty(nbytes, dtype=torch.uint8)
    aargs = (theta.data_ptr(), alpha.data_ptr(), mixed.data_ptr(), st, st,
             p, ac_scratch.data_ptr(), stream)
    table = bound(4 * (st * p + st * st + st * p), 2 * st * st * p,
                  PEAK_TF32_PER_S)
    out.append(dict(
        name="alpha_combine", call=lambda: ac.alpha_combine(theta, alpha),
        op=lambda: torch.ops.repro_torch.alpha_combine(theta, alpha),
        impl=lambda: ac._combine_launch(theta, alpha),
        raw=lambda: ac._entry()(*aargs), table=table, peak=PEAK_TF32_PER_S,
        counter=ac.alpha_combine, kernels=n_ac, keep=(mixed, ac_scratch)))
    # disagreement_counts N = 256, M = 64,000
    n, m = 256, 64000
    preds = torch.randint(0, 10, (n, m), device=dev, generator=gen,
                          dtype=torch.int32)
    valid = torch.ones(m, device=dev)
    counts = torch.empty(n, n, device=dev)
    bn, cl = dg._plan(n, m, 0)
    dargs = (preds.data_ptr(), valid.data_ptr(), counts.data_ptr(), n, m,
             bn, cl, False, stream)
    table = bound(4 * (n * m + m + n * n), 2 * n * n * m)
    out.append(dict(
        name="disagreement",
        call=lambda: dg.disagreement_counts(preds, valid),
        op=lambda: torch.ops.repro_torch.disagreement(preds, valid, False),
        impl=lambda: dg._disagree_launch(preds, valid, False),
        raw=lambda: dg._entry()(*dargs), table=table, peak=PEAK_FP32_PER_S,
        counter=dg.disagreement_counts, kernels=1, keep=(counts,)))
    return out


def phase_acct_ops(fa, ss, ac, dg, report):
    """8a: one call of each kernel op at its table shape under the step
    counter on the card: the counted FLOPs and bytes give the table's
    bound within ACCT_BOUND_TOL, and the call launched the kernel; then
    the op against its raw C-entry launch, device ms and host µs a call,
    the host µs split into the wrapper's checks, the dispatcher's share
    and the implementation's allocation and launch."""
    from repro_torch.launch.hlo import StepCounter
    rows = {}
    for k in _acct_ops(fa, ss, ac, dg):
        name, counter, n_k, peak = k["name"], k["counter"], k["kernels"], \
            k["peak"]
        t_ms, t_by = k["table"]
        before = counter.launches
        with StepCounter() as c:
            k["call"]()
        torch.cuda.synchronize()
        if counter.launches - before != n_k:
            raise AssertionError(f"[accounting] {name}: the counted call "
                                 f"launched {counter.launches - before} "
                                 f"kernels, not {n_k}")
        a = c.analysis()
        c_ms, c_by = bound(a.hbm_bytes, a.flops, peak)
        if c_by != t_by or abs(c_ms / t_ms - 1) > ACCT_BOUND_TOL:
            raise AssertionError(f"[accounting] {name}: the count's bound "
                                 f"{c_ms:.5f} ms ({c_by}) is not the "
                                 f"table's {t_ms:.5f} ms ({t_by}) within "
                                 f"{ACCT_BOUND_TOL:.0%}")
        err = k["raw"]()
        if err:
            raise AssertionError(f"[accounting] {name}: raw launch error "
                                 f"{err}")
        row = dict(flops=a.flops, bytes=a.hbm_bytes, bound_ms=c_ms,
                   bound_by=c_by, table_bound_ms=t_ms,
                   op_ms=cuda_ms(k["call"], 20), raw_ms=cuda_ms(k["raw"], 20),
                   **{f"{w}_host_us": _host_us(k[w])
                      for w in ("call", "op", "impl", "raw")})
        row["added_host_us"] = row["call_host_us"] - row["raw_host_us"]
        rows[name] = row
        log(f"[accounting] {name}: counted {a.flops:.6g} FLOPs, "
            f"{a.hbm_bytes:.6g} bytes -> bound {c_ms:.4f} ms ({c_by}); "
            f"table {t_ms:.4f} ms; op {row['op_ms']:.4f} ms vs raw launch "
            f"{row['raw_ms']:.4f} ms on the device; host us a call: "
            f"wrapper {row['call_host_us']:.1f}, the op alone "
            f"{row['op_host_us']:.1f}, its CUDA implementation "
            f"{row['impl_host_us']:.1f}, the raw launch "
            f"{row['raw_host_us']:.1f} (the op's path adds "
            f"{row['added_host_us']:.1f} us)")
    report["accounting_ops"] = rows
    return rows


def _count_on(fn, *args):
    from repro_torch.launch.hlo import StepCounter
    with StepCounter() as c:
        out = fn(*args)
    torch.cuda.synchronize()
    return c.analysis(), out


def _acct_step(tag, cfg, shape, bundle, card_args, run, reps, smi,
               counted):
    """Count ``bundle.fn`` on the card (its kernel launches too) and on
    meta, time ``run`` (the same step, no counter) ``reps`` times between
    synchronizes, and put the two side by side with the roofline's terms
    and mfu."""
    from repro_torch.launch import roofline
    from repro_torch.launch.dryrun import resident_bytes
    zero_counts(counted)
    card, _ = _count_on(bundle.fn, *card_args)
    launches = read_counts(counted)
    meta, meta_out = _count_on(bundle.fn, *bundle.abstract_args)
    if card.flops != meta.flops:
        raise AssertionError(f"[accounting] {tag}: {card.flops} FLOPs "
                             f"counted on the card, {meta.flops} on meta")
    gap = abs(card.hbm_bytes - meta.hbm_bytes) / meta.hbm_bytes
    if gap > ACCT_BYTES_TOL:
        raise AssertionError(f"[accounting] {tag}: bytes {card.hbm_bytes} "
                             f"on the card vs {meta.hbm_bytes} on meta "
                             f"({gap:.2e} apart, bar {ACCT_BYTES_TOL})")
    run()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = [_timed(run)[1] for _ in range(reps)]
    sec = float(np.median(times))
    peak_mem = torch.cuda.max_memory_allocated()
    rl = roofline.derive_roofline(
        cfg, shape, chips=1, hlo_flops_per_device=card.flops,
        hlo_bytes_per_device=card.hbm_bytes, collective_bytes_per_device=0.0)
    args_bytes = resident_bytes(bundle, meta_out)["argument_size_in_bytes"]
    row = dict(flops=card.flops, bytes=card.hbm_bytes,
               bytes_meta=meta.hbm_bytes, bytes_gap=gap, s=sec,
               s_all=times, tflops_s=card.flops / sec / 1e12,
               compute_s=rl.compute_s, memory_s=rl.memory_s,
               compute_share=rl.compute_s / sec,
               memory_share=rl.memory_s / sec, bound=rl.dominant,
               model_flops=rl.model_flops,
               mfu=roofline.mfu(cfg, shape, sec, 1),
               max_memory_allocated=peak_mem, dryrun_argument_bytes=args_bytes,
               launches=launches)
    log(f"[accounting] {tag}: {card.flops:.6g} FLOPs counted on the card = "
        f"{meta.flops:.6g} on meta; bytes {card.hbm_bytes:.6g} card vs "
        f"{meta.hbm_bytes:.6g} meta ({gap:.1e} apart); {sec * 1e3:.3f} ms "
        f"a step (median of {reps}), {row['tflops_s']:.2f} TFLOP/s; "
        f"roofline compute {rl.compute_s * 1e3:.3f} ms "
        f"({row['compute_share']:.1%} of the step), memory "
        f"{rl.memory_s * 1e3:.3f} ms ({row['memory_share']:.1%}), bound by "
        f"{rl.dominant}; mfu {row['mfu']:.4f} against 989 TFLOP/s; "
        f"max_memory_allocated {peak_mem / 1e9:.3f} GB vs the dry run's "
        f"1x1 argument bytes {args_bytes / 1e9:.3f} GB; {smi}")
    return row


def phase_accounting(counted, report, smi, dryrun):
    """8b: three steps counted on the card and on meta, timed without the
    counter; 8c: the dry run's records (started at the run's beginning)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape
    from repro_torch.launch import steps as tsteps
    from repro_torch.launch.mesh import abstract_mesh
    from repro_torch.models.api import build_model
    from repro_torch.nn.sharding import RULE_SETS
    from repro_torch.optim import adamw
    dev = torch.device("cuda")
    one = abstract_mesh((1, 1), ("data", "model"))
    rules = RULE_SETS["default"]
    out = {}
    # the llama3.2-1b prefill on the kernel route
    cfg = dataclasses.replace(get_config(LM_ARCH), attention_impl="kernel")
    b, s = ACCT_PREFILL
    shape = InputShape("prefill", s, b, "prefill")
    bundle = tsteps.make_bundle(cfg, shape, one, rules)
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0),
                        device=dev)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (b, s), device=dev,
                                     dtype=torch.int32)}
    out["prefill"] = _acct_step(
        f"{LM_ARCH} prefill {ACCT_PREFILL} (kernel route)", cfg, shape,
        bundle, (params, batch), lambda: bundle.fn(params, batch), 5, smi,
        counted)
    if out["prefill"]["launches"]["flash_attention"] != cfg.num_layers:
        raise AssertionError(f"[accounting] the counted prefill launched "
                             f"{out['prefill']['launches']}")
    # one decode step at batch 4
    b, slots, pos = ACCT_DECODE
    shape = InputShape("decode", slots, b, "decode")
    bundle = tsteps.make_bundle(cfg, shape, one, rules)
    cache = model.init_cache(b, slots, device=dev)
    dbatch = {"token": torch.randint(0, cfg.vocab_size, (b, 1), device=dev,
                                     dtype=torch.int32),
              "pos": torch.full((b,), pos, device=dev, dtype=torch.int32)}
    out["decode"] = _acct_step(
        f"{LM_ARCH} decode step at batch {b} ({slots} cache slots)", cfg,
        shape, bundle, (params, cache, dbatch),
        lambda: bundle.fn(params, cache, dbatch), 20, smi, counted)
    del params, cache
    torch.cuda.empty_cache()
    # phase 7's model: repro-100m, remat off at (8, 512) as launch.train
    # turns it off, fp32 moments as launch.train keeps them
    cfg = dataclasses.replace(get_config(TRAIN_ARCH), remat=False)
    b, s = ACCT_TRAIN
    shape = InputShape("train", s, b, "train")
    bundle = tsteps.make_train_bundle(cfg, shape, one, rules,
                                      opt_state_dtype=torch.float32)
    params = build_model(cfg).init(
        torch.Generator(device=dev).manual_seed(0), device=dev)
    opt_state = adamw(3e-4, weight_decay=0.1,
                      state_dtype=torch.float32).init(params)
    tbatch = {k: torch.randint(0, cfg.vocab_size, (b, s), device=dev,
                               dtype=torch.int32)
              for k in ("tokens", "labels")}
    out["train"] = _acct_step(
        f"{TRAIN_ARCH} train step {ACCT_TRAIN}", cfg, shape, bundle,
        (params, opt_state, tbatch),
        lambda: bundle.fn(params, opt_state, tbatch), 10, smi, counted)
    del params, opt_state
    torch.cuda.empty_cache()
    # 8c. the partitioned dry run on meta, every shape ok (long_500k by
    # the ring cache): rank 0 of 256 with its collectives, and one card
    proc, path, log_file = dryrun
    t_wait = time.perf_counter()
    rc = proc.wait(timeout=600)
    waited = time.perf_counter() - t_wait
    log_file.close()
    recs = {(r["shape"], r["mesh"]): r for r in (
        json.loads(p.read_text()) for p in sorted(path.glob("*.json")))}
    if rc != 0 or len(recs) != 8 \
            or any(r["status"] != "ok" for r in recs.values()):
        raise AssertionError(
            f"[accounting] dry run exit {rc}, records "
            f"{ {k: r['status'] for k, r in recs.items()} }: "
            + (ROOT / "build" / "dryrun_smoke.log").read_text()[-2000:])
    out["dryrun"] = {"waited_s": waited}
    for (shape, mesh), r in sorted(recs.items()):
        if mesh != "16x16":
            continue
        whole = recs[(shape, "1x1")]["hlo_flops_per_device"]
        bad = [what for what, ok in (
            ("per_device is not rank0", r["per_device"] == "rank0"),
            ("no collective bytes", r["collective_bytes_per_device"] > 0),
            ("no collectives", bool(r["collectives"])),
            ("rank 0's FLOPs x 256 under one card's",
             r["hlo_flops_per_device"] * r["chips"] >= whole),
            (f"decode over {ACCT_DRYRUN_DECODE_OVER_SHARE} of an even share",
             shape != "decode_32k" or r["hlo_flops_per_device"] * r["chips"]
             <= ACCT_DRYRUN_DECODE_OVER_SHARE * whole)) if not ok]
        if bad:
            raise AssertionError(f"[accounting] dry run {shape} on {mesh}: "
                                 f"{bad}: {r}")
        out["dryrun"][shape] = dict(
            flops_per_device=r["hlo_flops_per_device"],
            bytes_per_device=r["hlo_bytes_per_device"],
            collective_bytes_per_device=r["collective_bytes_per_device"],
            collectives=r["collectives"], flops_one_card=whole,
            rank0_over_even_share=r["hlo_flops_per_device"] * r["chips"]
            / whole, resident_bytes=r["hbm_resident_bytes"],
            fits=r["fits_hbm"], dominant=r["roofline"]["dominant"],
            count_s=r["count_s"],
            count_s_one_card=recs[(shape, "1x1")]["count_s"])
        log(f"[accounting] dry run {ACCT_DRYRUN_ARCH} {shape} on {mesh}, "
            f"reckoned on meta (not measured): rank 0 of {r['chips']} "
            f"{r['hlo_flops_per_device']:.4g} FLOPs "
            f"({out['dryrun'][shape]['rank0_over_even_share']:.4f} times "
            f"an even share of one card's {whole:.4g}), "
            f"{r['hlo_bytes_per_device']:.4g} bytes, collectives "
            f"{r['collective_bytes_per_device']:.4g} bytes "
            f"{ {k: (c['count'], c['bytes']) for k, c in r['collectives'].items()} }"
            f", resident {r['hbm_resident_bytes'] / 1e9:.3f} GB, dominant "
            f"{r['roofline']['dominant']}; counted in {r['count_s']} s "
            f"(one card {recs[(shape, '1x1')]['count_s']} s)")
    log(f"[accounting] dry run child: waited {waited:.1f} s for it here")
    report["accounting"] = out
    return out


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


def _moved(state, device, dtype):
    """The RoundState's clients and parameters on ``device``, floating
    point in ``dtype``."""
    def mv(t):
        return t.to(device=device, dtype=dtype if t.is_floating_point()
                    else t.dtype)
    c = state.clients
    return (type(c)(**{f.name: mv(getattr(c, f.name))
                       for f in dataclasses.fields(c)}),
            {k: mv(v) for k, v in state.params.items()})


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

    # FADA's gaps on the card against the CPU port, on the same draws:
    # held in float64, reported in float32 (see FADA_KW)
    srcs, tgts = np.flatnonzero(stlf.psi == 0), np.flatnonzero(stlf.psi == 1)
    si, ti = (a.ravel() for a in np.meshgrid(srcs, tgts, indexing="ij"))
    counts = state.clients.counts.cpu().numpy()
    draws = pair_draws(split_seed(3, len(si)), counts[si], counts[ti],
                       steps=FADA_KW["iters"], batch=FADA_KW["batch"])
    on = {(d, dt): _moved(state, d, dt)
          for d in ("cuda", "cpu") for dt in (torch.float32, torch.float64)}
    runs = {}
    for tag, d, dt, kw in (
            ("cuda64", "cuda", torch.float64, FADA_KW),
            ("cpu64", "cpu", torch.float64, FADA_KW),
            ("fault64", "cuda", torch.float64,
             dict(FADA_KW, lr=FADA_KW["lr"] / 2)),
            ("cuda32", "cuda", torch.float32, FADA_KW),
            ("cpu32", "cpu", torch.float32, FADA_KW)):
        c, p = on[d, dt]
        g, w, b = bl._domain_gap(p, c, si, ti, draws=draws, **kw)
        runs[tag] = (g.double().cpu().numpy(), w.double().cpu())
    with torch.no_grad():                       # the sources' own rows
        feats = {}
        for d in ("cuda", "cpu"):
            c, p = on[d, torch.float32]
            rows_of = torch.as_tensor(srcs, device=c.x.device)
            feats[d] = cnn._features_stacked(
                {k: v[rows_of] for k, v in p.items()}, c.x[rows_of]).cpu()
    row = 4.0 / (counts[si] + counts[ti])       # one row of each pair's gap

    def apart(a, ref):
        """(largest gap move in rows of its pair, max |dw| / max |w|)."""
        (g, w), (rg, rw) = runs[a], runs[ref]
        return (float((np.abs(g - rg) / row).max()),
                float((w - rw).abs().max() / rw.abs().max()))

    seen = {"cuda": apart("cuda64", "cpu64"),
            "fault": apart("fault64", "cpu64"),
            "cuda32": apart("cuda32", "cpu32"),
            "cpu32": apart("cpu32", "cpu64")}
    feat_rel = float((feats["cuda"] - feats["cpu"]).abs().max()
                     / feats["cpu"].abs().max())
    for dev, what in (("cuda", "GPU vs CPU in float64"),
                      ("fault", "planted fault (lr / 2) on the GPU vs CPU "
                                "in float64")):
        log(f"[baselines] FADA {what}, {len(si)} pairs on the same draws: "
            f"gaps {seen[dev][0]:.4g} rows apart at most (bar "
            f"{FADA_GAP_ROWS} rows), w {seen[dev][1]:.3g} of max |w| (bar "
            f"{FADA_W_TOL})")
    log(f"[baselines] FADA in float32 (not held: the SGD amplifies "
        f"rounding): GPU vs CPU gaps {seen['cuda32'][0]:.4g} rows, w "
        f"{seen['cuda32'][1]:.3g}; the CPU's own float32 vs its float64 "
        f"gaps {seen['cpu32'][0]:.4g} rows, w {seen['cpu32'][1]:.3g}")
    log(f"[baselines] FADA float32 features GPU vs CPU: {feat_rel:.3g} of "
        f"the largest entry (bar {FADA_FEAT_TOL}); float32 gaps "
        f"{np.round(runs['cuda32'][0], 4).tolist()}")
    if not (np.isfinite(runs["cuda64"][0]).all()
            and np.isfinite(runs["cuda32"][0]).all()
            and seen["cuda"][0] <= FADA_GAP_ROWS
            and seen["cuda"][1] <= FADA_W_TOL):
        raise AssertionError("FADA: the card's discriminators differ from "
                             "the CPU port's")
    if not feat_rel <= FADA_FEAT_TOL:
        raise AssertionError("FADA: the card's float32 features differ "
                             "from the CPU port's")
    if not (seen["fault"][0] > FADA_GAP_ROWS
            and seen["fault"][1] > FADA_W_TOL):
        raise AssertionError("FADA: the bars do not see a planted fault")
    report["baselines"] = dict(
        wall_s=wall, fada_s=fada_s, launches=launches,
        methods={k: dict(target_acc=r.target_acc, energy=r.energy,
                         transmissions=r.transmissions,
                         psi=r.psi.tolist()) for k, r in res.items()},
        fada_gpu_vs_cpu_f64=dict(gap_rows=seen["cuda"][0],
                                 w_rel=seen["cuda"][1]),
        fada_gpu_vs_cpu_f32=dict(gap_rows=seen["cuda32"][0],
                                 w_rel=seen["cuda32"][1],
                                 features_rel=feat_rel),
        fada_cpu_f32_vs_f64=dict(gap_rows=seen["cpu32"][0],
                                 w_rel=seen["cpu32"][1]),
        fada_fault_lr_half=dict(gap_rows=seen["fault"][0],
                                w_rel=seen["fault"][1]))


def _wall_line(r):
    """A row's phase walls from the trace fields (async: the gossip
    exchange is the transfer phase)."""
    return (f"wall {r['wall_time_s']:.3f} s (train {r['train_wall_s']:.3f}, "
            f"divergence {r['div_wall_s']:.3f}, solve "
            f"{r['solver_wall_s']:.3f}, transfer {r['transfer_wall_s']:.4f},"
            f" eval {r['eval_wall_s']:.4f}, checkpoint "
            f"{r['ckpt_wall_s']:.4f})")


def _check_rows(tag, rows, rounds):
    from repro_torch.sim.metrics import RoundRecord
    fields = [f.name for f in dataclasses.fields(RoundRecord)]
    if not (len(rows) == rounds
            and [r["round"] for r in rows] == list(range(rounds))
            and all(list(r) == fields for r in rows)
            and all(r["n_sources"] + r["n_targets"] == r["n_active"]
                    and np.isfinite(r["energy"])
                    and r["resolved"] == (r["resolve_reason"] is not None)
                    for r in rows)
            and rows[0]["resolve_reason"] == "cold"
            and all(r["train_wall_s"] > 0 for r in rows)):
        raise AssertionError(f"sim {tag}: rows malformed")


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
    from repro_torch.sim.metrics import read_jsonl

    out_dir = ROOT / "build" / "sim"
    out, engines = {}, {}
    for scenario, n, rounds, cut in runs:
        tag = f"{scenario}-n{n}-r{rounds}"
        log_path, trace_path = out_dir / f"{tag}.jsonl", \
            out_dir / f"{tag}.trace.jsonl"
        zero_counts(counted)
        t0 = time.perf_counter()
        eng, _ = sim_run.simulate([
            "--scenario", scenario, "--devices", str(n), "--rounds",
            str(rounds), "--out", str(log_path), "--trace-out",
            str(trace_path), "--quiet", "--device", dev]
            + (CUT_ARGS if cut else []))
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
        _check_rows(tag, rows, rounds)
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


def phase_sim_async(counted, report, dev="cuda", runs=SIM_ASYNC_RUNS):
    """The async-gossip executor through the CLI's run with ``--trace``,
    counted: no kernel of the port is on this path (training and
    Algorithm 1 are stacked PyTorch ops, the gossip exchange indexed row
    writes), so every count must stay 0.  Prints each tick's trained
    devices, gossip pairs, re-solve reason, dirty backlog and phase
    walls; the drift run must drift, re-measure and hold its budget
    (n_active pairs a tick).  Then a cost model fitted from the first
    run's own trace, and the autotuner's choice under it."""
    from repro_torch.sim import run as sim_run
    from repro_torch.sim.metrics import read_jsonl
    from repro_torch.sim.trace.model import CostModel, read_trace
    from repro_torch.sim.trace.replay import predict_run
    from repro_torch.sim.trace.tune import (PATIENCE_MAX, PATIENCE_MIN,
                                            autotune, min_budget)

    out_dir = ROOT / "build" / "sim"
    out, traces = {}, {}
    for scenario, engine, n, ticks in runs:
        tag = f"{scenario}-n{n}-r{ticks}"
        log_path, trace_path = out_dir / f"{tag}.jsonl", \
            out_dir / f"{tag}.trace.jsonl"
        zero_counts(counted)
        t0 = time.perf_counter()
        eng, _ = sim_run.simulate([
            "--scenario", scenario, "--engine", engine, "--devices", str(n),
            "--rounds", str(ticks), "--out", str(log_path), "--trace-out",
            str(trace_path), "--quiet", "--device", dev, *CUT_ARGS])
        wall = time.perf_counter() - t0
        launches = read_counts(counted)
        rows = read_jsonl(str(log_path))
        events = read_trace(str(trace_path))
        traces[tag] = (eng.cfg, events, rows)
        for r in rows:
            log(f"[sim-async] {tag} tick {r['round']}: trained "
                f"{r['n_trained']} {r['trained']}, gossip "
                f"{len(r['gossip'])} {r['gossip']}, exchanges "
                f"{r['transmissions']}, resolve {r['resolve_reason']} "
                f"({r['solver_iters']} outer, age {r['solve_age']}), "
                f"dirty {r['n_dirty_pairs']}, re-estimated "
                f"{r['n_reestimated']}, drifted {r['n_drifted']}, "
                f"staleness {r['mean_staleness']:.2f}; {_wall_line(r)}; "
                f"targets {r['n_targets']}, tgt_acc "
                f"{r['mean_target_acc']:.4f}")
        solves = [e for e in events if e["phase"] == "solve"]
        steps = sum(e["inner_steps"] for e in solves)
        solve_s = sum(e["seconds"] for e in solves)
        lanes = sorted({e.get("lanes") for e in events
                        if e["phase"] == "train"} - {None})
        log(f"[sim-async] {tag}: {wall:.3f} s in main; {len(solves)} "
            f"re-solves ({[r['resolve_reason'] for r in rows if r['resolved']]}"
            f"), {steps} inner steps in {solve_s:.3f} s: "
            f"{solve_s / max(steps, 1) * 1e3:.3f} ms per solver step; "
            f"compact train widths {lanes}; launches {launches}")
        _check_rows(tag, rows, ticks)
        if any(launches.values()):
            raise AssertionError(f"sim {tag}: a kernel ran on the async "
                                 f"path: {launches}")
        if not (any(r["gossip"] for r in rows)
                and any(0 < r["n_trained"] < r["n_active"] for r in rows)):
            raise AssertionError(f"sim {tag}: no gossip or no subset "
                                 f"training")
        if scenario.startswith("feature-drift") and not (
                any(r["n_drifted"] for r in rows)
                and any(r["n_reestimated"] for r in rows)
                and all(r["n_reestimated"] <= r["n_active"]
                        for r in rows)):
            raise AssertionError(f"sim {tag}: drift not re-measured "
                                 f"within the budget")
        out[tag] = dict(
            wall_s=wall, launches=launches, resolves=len(solves),
            reasons=[r["resolve_reason"] for r in rows],
            inner_steps=steps, solve_s=solve_s,
            ms_per_solver_step=solve_s / max(steps, 1) * 1e3,
            n_trained=[r["n_trained"] for r in rows],
            gossip=[len(r["gossip"]) for r in rows],
            exchanges=[r["transmissions"] for r in rows],
            n_dirty_pairs=[r["n_dirty_pairs"] for r in rows],
            n_reestimated=[r["n_reestimated"] for r in rows],
            phases={k: [r[k] for r in rows] for k in (
                "wall_time_s", "train_wall_s", "div_wall_s",
                "solver_wall_s", "transfer_wall_s", "eval_wall_s")})

    # a cost model from the card's own async trace, and its tuning
    tag = next(iter(traces))
    cfg, events, rows = traces[tag]
    model = CostModel.fit(events)
    for phase, spec in sorted(model.phases.items()):
        log(f"[sim-async] cost model ({tag}) {phase}: "
            + ", ".join(f"{f} {c:.6g}" for f, c in zip(spec["features"],
                                                          spec["coef"]))
            + f"; first_extra {spec['first_extra']:.4g} s, "
            f"{spec['n_events']} events, mean |err| "
            f"{spec['mean_abs_err_s']:.4g} s")
    pred = predict_run(cfg, model)["total_s"]
    measured = sum(r["wall_time_s"] for r in rows)
    tuned = autotune(cfg, model)
    log(f"[sim-async] replay of {tag} under its own model: {pred:.3f} s "
        f"predicted, {measured:.3f} s measured; autotune: knobs "
        f"{tuned['knobs']}, {tuned['predicted_s']:.3f} s predicted vs "
        f"{tuned['baseline_s']:.3f} s ({tuned['n_candidates']} "
        f"candidates)")
    if not (np.isfinite(pred) and pred > 0):
        raise AssertionError("sim cost model: no usable prediction")
    # the tuner's claim, re-derived: its knobs applied give its predicted
    # seconds, its baseline is the run's own prediction, and the
    # guardrails hold (mesh untouched, the budget covers the expected
    # drift rate, patience within its bounds)
    knobs = tuned["knobs"]
    tuned_cfg = dataclasses.replace(cfg, **knobs)
    budget = {-1: cfg.devices, 0: cfg.devices * (cfg.devices - 1) // 2}\
        .get(tuned_cfg.div_budget, tuned_cfg.div_budget)
    bad = [why for why, ok in (
        ("baseline", tuned["baseline_s"] == pred),
        ("predicted", predict_run(tuned_cfg, model)["total_s"]
         == tuned["predicted_s"]),
        ("mesh", "mesh" not in knobs),
        ("budget", budget >= min_budget(cfg)),
        ("patience", "resolve_patience" not in knobs
         or PATIENCE_MIN <= knobs["resolve_patience"] <= PATIENCE_MAX))
        if not ok]
    if bad:
        raise AssertionError(f"sim autotune: {bad} ({tuned})")
    report["sim_async"] = out
    report["sim_cost_model"] = dict(
        model=model.to_dict(), replay_s=pred, measured_s=measured,
        autotune=tuned)
    return out


def _archives_equal(a_dir, b_dir, step):
    """Every member of two checkpoints' archives, bit for bit."""
    from repro_torch.checkpoint import load_arrays
    _, a = load_arrays(str(a_dir), step)
    _, b = load_arrays(str(b_dir), step)
    bad = sorted(k for k in set(a) | set(b)
                 if k not in a or k not in b or a[k].dtype != b[k].dtype
                 or not np.array_equal(a[k], b[k]))
    return len(a), bad


def _decisions_differ(a, b):
    return [(ra["round"], k) for ra, rb in zip(a, b)
            for k in SIM_DECISIONS if ra[k] != rb[k]]


def _floats_apart(a, b):
    """The largest |difference| of each float field of two runs' rows
    (NaN against NaN counts 0)."""
    return {k: max((abs(ra[k] - rb[k]) if np.isfinite(rb[k])
                    or np.isfinite(ra[k]) else 0.0)
                   for ra, rb in zip(a, b))
            for k in ("drift", "mean_target_acc", "mean_source_acc",
                      "energy", "energy_cum", "link_churn")}


def phase_sim_faulty(ac, counted, report, dev="cuda"):
    """The 'faulty' scenario (sync) through the CLI: an uninterrupted
    run, counted (``alpha_combine`` as ``alpha_combine_plan`` gives it
    each round); then the same run with ``--checkpoint-every 1
    --kill-after k`` in a child process that SIGKILLs itself, and
    ``--resume`` to the end in this one, counted (the resumed rounds'
    kernels).  Holds: the kill (exit by SIGKILL, k + 1 rows logged), the
    stitched log (every round once, ``resume_count`` 1 after k), and
    ``restore_run`` putting back exactly the arrays ``save_run`` wrote
    (a fresh engine restored from the last checkpoint, saved again: the
    same archive bit for bit).  Prints whether the killed run's rounds
    agree with the uninterrupted run's (two uninterrupted card runs of
    one config) and whether the resumed rounds do, on the decision
    fields.  The kernel against its plain version on the last round's
    transfer inputs."""
    import os
    import signal
    from repro_torch.nn.param import flatten_to_vector
    from repro_torch.sim import SimulationEngine
    from repro_torch.sim import run as sim_run
    from repro_torch.sim.metrics import read_jsonl
    from repro_torch.sim.snapshot import save_run

    n, rounds, kill = SIM_FAULTY
    out_dir = ROOT / "build" / "sim"
    tag = f"faulty-n{n}-r{rounds}"
    base = ["--scenario", "faulty", "--devices", str(n), "--rounds",
            str(rounds), "--trace", "--quiet", "--device", dev,
            *CUT_ARGS]
    straight_log, log_path = out_dir / f"{tag}.jsonl", \
        out_dir / f"{tag}-resumed.jsonl"
    ckpt, again = Path(f"{log_path}.ckpt"), out_dir / f"{tag}.again"
    log_path.unlink(missing_ok=True)          # a fresh run, not a resume
    for d in (ckpt, again):
        shutil.rmtree(d, ignore_errors=True)

    zero_counts(counted)
    t0 = time.perf_counter()
    eng, straight = sim_run.simulate(base + ["--out", str(straight_log)])
    wall = time.perf_counter() - t0
    launches = read_counts(counted)
    pool = len(eng.state.alpha)
    per_call = ac._plan(pool, pool)[0]
    for r in straight:
        log(f"[sim-faulty] {tag} round {r['round']}: events {r['events']}"
            f"; faults {r['n_faults']}, recovered {r['n_recovered']}, "
            f"active {r['n_active']}, resolve {r['resolve_reason']} "
            f"({r['solver_iters']} outer); {_wall_line(r)}")
    _check_rows(tag, straight, rounds)
    if launches["alpha_combine"] != rounds * per_call or any(
            v for k, v in launches.items() if k != "alpha_combine"):
        raise AssertionError(f"sim {tag}: launches {launches}, "
                             f"alpha_combine should be "
                             f"{rounds * per_call}")
    if not sum(r["n_faults"] for r in straight):
        raise AssertionError(f"sim {tag}: no fault was injected")

    t0 = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    killed = subprocess.run(
        [sys.executable, "-m", "repro_torch.sim.run"] + base + [
            "--out", str(log_path), "--checkpoint-every", "1",
            "--kill-after", str(kill)], env=env, cwd=str(ROOT),
        capture_output=True, text=True, timeout=900)
    killed_s = time.perf_counter() - t0
    prefix = read_jsonl(str(log_path))
    if killed.returncode != -signal.SIGKILL or len(prefix) != kill + 1:
        raise AssertionError(
            f"sim {tag}: the --kill-after run exited {killed.returncode} "
            f"with {len(prefix)} rows: {killed.stderr[-2000:]}")
    zero_counts(counted)
    t0 = time.perf_counter()
    eng2, rows = sim_run.simulate(base + [
        "--out", str(log_path), "--checkpoint-every", "1", "--resume"])
    resumed_s = time.perf_counter() - t0
    resumed_launches = read_counts(counted)
    want = (rounds - kill - 1) * per_call
    if resumed_launches["alpha_combine"] != want:
        raise AssertionError(f"sim {tag} resumed: launches "
                             f"{resumed_launches}, alpha_combine should be "
                             f"{want}")
    logged = read_jsonl(str(log_path))
    _check_rows(f"{tag} resumed", logged, rounds)
    if [r["resume_count"] for r in logged] != \
            [0] * (kill + 1) + [1] * (rounds - kill - 1):
        raise AssertionError(f"sim {tag}: resume counts "
                             f"{[r['resume_count'] for r in logged]}")
    # restore_run puts back exactly what save_run wrote
    cfg = dataclasses.replace(eng2.cfg, log_path=None, resume=True,
                              checkpoint_every=None)
    eng3 = SimulationEngine(cfg, device=dev)
    eng3.cfg = dataclasses.replace(cfg, resume=False, ckpt_dir=str(again))
    save_run(eng3, rounds)
    n_arrays, bad = _archives_equal(ckpt, again, rounds)
    log(f"[sim-faulty] {tag}: restore_run then save_run of step {rounds}: "
        f"{n_arrays} arrays, {len(bad)} differ {bad[:5]}")
    if bad or eng3.state.round != rounds:
        raise AssertionError(f"sim {tag}: restore_run does not put back "
                             f"the saved arrays: {bad[:10]}")
    repeat = _decisions_differ(prefix, straight[:kill + 1])
    after = _decisions_differ(logged[kill + 1:], straight[kill + 1:])
    repeat_f = _floats_apart(prefix, straight[:kill + 1])
    after_f = _floats_apart(logged[kill + 1:], straight[kill + 1:])
    log(f"[sim-faulty] {tag}: two uninterrupted card runs (rounds 0-{kill}"
        f" of the killed run and of the straight one) "
        f"{'agree' if not repeat else 'differ at ' + str(repeat)} on the "
        f"decisions, floats apart by {repeat_f}; resumed rounds "
        f"{kill + 1}-{rounds - 1} "
        f"{'agree' if not after else 'differ at ' + str(after)} with the "
        f"straight run's, floats apart by {after_f}; straight {wall:.3f} s, "
        f"killed child "
        f"{killed_s:.3f} s, resumed {resumed_s:.3f} s; launches "
        f"{launches} straight, {resumed_launches} resumed")
    # the kernel against its plain version on the last round's transfer
    flat = flatten_to_vector(eng.state.params, lead=1).contiguous()
    a = torch.as_tensor(eng.state.alpha, dtype=torch.float32,
                        device=flat.device)
    kern, plain = ac.alpha_combine(flat, a), ac.alpha_combine_plain(flat, a)
    err = float((kern - plain).abs().max())
    log(f"[sim-faulty] {tag}: alpha_combine on the last round's transfer "
        f"({pool} x {pool}) vs plain: max abs err {err:.3g}")
    if not torch.allclose(kern, plain, rtol=1e-5, atol=1e-5):
        raise AssertionError(f"sim {tag}: alpha_combine differs from its "
                             f"plain version by {err}")
    report["sim_faulty"] = dict(
        wall_s=wall, killed_child_s=killed_s, resumed_s=resumed_s,
        launches=launches, resumed_launches=resumed_launches,
        kernels_per_round=per_call, archive_arrays=n_arrays,
        repeat_differs=repeat, resumed_differs=after,
        repeat_floats=repeat_f, resumed_floats=after_f, max_abs_err=err,
        faults=[r["n_faults"] for r in straight],
        reasons=[r["resolve_reason"] for r in straight],
        phases={k: [r[k] for r in straight] for k in (
            "wall_time_s", "train_wall_s", "div_wall_s", "solver_wall_s",
            "transfer_wall_s", "eval_wall_s")})
    return report["sim_faulty"]


def _transfers_apart(pools, params, alpha, psi):
    """Each pool's transfer of the same inputs against the first's:
    {name: max abs difference}, and whether every leaf is within
    rtol/atol 1e-5."""
    outs = {name: pool.transfer(params, alpha, psi)
            for name, pool in pools.items()}
    first = next(iter(outs.values()))
    gaps, ok = {}, True
    for name, out in outs.items():
        gaps[name] = max(float((out[k] - first[k]).abs().max())
                         for k in first)
        ok = ok and all(torch.allclose(out[k], first[k], rtol=1e-5,
                                       atol=1e-5) for k in first)
    return gaps, ok


def _sharded_launches(ac, pool_size, mesh):
    """alpha_combine kernels one transfer launches: one slab a shard,
    each as ``alpha_combine_plan`` gives it (the single-device pool: one
    call at (N, N))."""
    if mesh == 0:
        return ac._plan(pool_size, pool_size)[0]
    s = pool_size + (-pool_size % mesh)
    return mesh * ac._plan(s, s // mesh)[0]


def phase_sim_shard(ac, counted, report, dev="cuda"):
    """The sharded device pool (``SimConfig.mesh``), counted.  (1) The
    CLI's default run cut to 2 rounds through ``--mesh 1``, then the same
    config through the Python API at an emulated mesh of 4 (every shard
    on this card) and on the single-device pool: the decisions equal,
    ``alpha_combine`` launched one slab a shard a round (as
    ``alpha_combine_plan`` gives it), and the three pools' transfers of
    the local run's final state within 1e-5.  (2) 'faulty' with shard
    losses at an emulated mesh of 2: devices recovered; SIGKILLed after a
    round in a child and resumed, agreeing with the uninterrupted run on
    every decision."""
    import os
    import signal
    from repro_torch.sim import SimulationEngine
    from repro_torch.sim import run as sim_run
    from repro_torch.sim.metrics import read_jsonl
    from repro_torch.sim.shard import LocalPool

    out_dir = ROOT / "build" / "sim"
    scenario, n, rounds = SHARD_RUN
    tag = f"{scenario}-n{n}-r{rounds}"
    runs = {}
    zero_counts(counted)
    t0 = time.perf_counter()
    eng, rows = sim_run.simulate([
        "--scenario", scenario, "--devices", str(n), "--rounds",
        str(rounds), "--mesh", "1", "--out",
        str(out_dir / f"{tag}-mesh1.jsonl"), "--trace", "--quiet",
        *CUT_ARGS, "--device", dev])
    runs["mesh 1 (CLI)"] = (1, eng, rows, time.perf_counter() - t0,
                            read_counts(counted))
    for name, mesh in ((f"mesh {SHARD_MESH} (emulated)", SHARD_MESH),
                       ("local", 0)):
        cfg = dataclasses.replace(
            eng.cfg, mesh=mesh,
            log_path=str(out_dir / f"{tag}-mesh{mesh}.jsonl"))
        zero_counts(counted)
        t0 = time.perf_counter()
        e = SimulationEngine(cfg, device=dev, emulate=mesh > 1)
        r = e.run()
        runs[name] = (mesh, e, r, time.perf_counter() - t0,
                      read_counts(counted))
    local = runs["local"][2]
    out = {"runs": {}}
    for name, (mesh, e, r, wall, launches) in runs.items():
        _check_rows(f"{tag} {name}", r, rounds)
        want = rounds * _sharded_launches(ac, n, mesh)
        differ = _decisions_differ(r, local)
        floats = _floats_apart(r, local)
        for row in r:
            log(f"[sim-shard] {tag} {name} ({e.pool.name}) round "
                f"{row['round']}: sources {row['n_sources']}, targets "
                f"{row['n_targets']}, resolve {row['resolve_reason']}; "
                f"{_wall_line(row)}")
        log(f"[sim-shard] {tag} {name}: {wall:.3f} s; launches {launches}"
            f" (alpha_combine: {want} wanted); decisions "
            f"{'equal to' if not differ else 'differ from'} the local "
            f"run's {differ or ''}; floats apart by {floats}")
        if launches["alpha_combine"] != want or any(
                v for k, v in launches.items() if k != "alpha_combine"):
            raise AssertionError(f"sim-shard {tag} {name}: launches "
                                 f"{launches}, alpha_combine should be "
                                 f"{want}")
        if differ:
            raise AssertionError(f"sim-shard {tag} {name}: decisions "
                                 f"differ from the local run at {differ}")
        out["runs"][name] = dict(
            pool=e.pool.name, wall_s=wall, launches=launches,
            floats_apart=floats, phases={k: [x[k] for x in r] for k in (
                "wall_time_s", "train_wall_s", "div_wall_s",
                "solver_wall_s", "transfer_wall_s", "eval_wall_s")})
    # the three pools' transfers of the local run's final state
    le = runs["local"][1]
    gaps, ok = _transfers_apart(
        {"local": LocalPool(le), "mesh 1": runs["mesh 1 (CLI)"][1].pool,
         f"mesh {SHARD_MESH}": runs[f"mesh {SHARD_MESH} (emulated)"][1].pool},
        le.state.params, le.state.alpha, le.state.psi)
    log(f"[sim-shard] {tag}: transfers of the local run's final state, "
        f"max abs difference from the local pool's: {gaps}")
    if not ok:
        raise AssertionError(f"sim-shard {tag}: the sharded transfers "
                             f"differ from the local one by {gaps}")
    out["transfer_gaps"] = gaps

    # (2) shard losses, recovery, kill and resume at an emulated mesh 2
    n_f, rounds_f, kill = SHARD_FAULTY
    tag_f = f"faulty-n{n_f}-r{rounds_f}-mesh{SHARD_FAULTY_CFG['mesh']}"
    straight_log, log_path = out_dir / f"{tag_f}.jsonl", \
        out_dir / f"{tag_f}-resumed.jsonl"
    ckpt = Path(f"{log_path}.ckpt")
    log_path.unlink(missing_ok=True)
    shutil.rmtree(ckpt, ignore_errors=True)
    from repro_torch.sim import SimConfig
    cfg = SimConfig(devices=n_f, rounds=rounds_f, trace=True,
                    log_path=str(straight_log), **SHARD_FAULTY_CFG)
    zero_counts(counted)
    t0 = time.perf_counter()
    straight = SimulationEngine(cfg, device=dev, emulate=True).run()
    wall = time.perf_counter() - t0
    launches = read_counts(counted)
    per_round = _sharded_launches(ac, n_f, cfg.mesh)
    for r in straight:
        log(f"[sim-shard] {tag_f} round {r['round']}: events "
            f"{r['events']}; recovered {r['n_recovered']}, resolve "
            f"{r['resolve_reason']}; {_wall_line(r)}")
    _check_rows(tag_f, straight, rounds_f)
    recovered = sum(r["n_recovered"] for r in straight)
    if not recovered:
        raise AssertionError(f"sim-shard {tag_f}: no device recovered")
    if launches["alpha_combine"] != rounds_f * per_round:
        raise AssertionError(f"sim-shard {tag_f}: launches {launches}, "
                             f"alpha_combine should be "
                             f"{rounds_f * per_round}")
    child_cfg = dict(dataclasses.asdict(cfg), log_path=str(log_path),
                     checkpoint_every=1, ckpt_dir=str(ckpt),
                     kill_after=kill)
    code = ("import json, sys; sys.path.insert(0, 'src'); "
            "from repro_torch.sim import SimConfig, SimulationEngine; "
            "c = json.loads(sys.argv[1]); "
            "c['tick_periods'] = tuple(c['tick_periods']); "
            "SimulationEngine(SimConfig(**c), device=sys.argv[2], "
            "emulate=True).run()")
    t0 = time.perf_counter()
    killed = subprocess.run(
        [sys.executable, "-c", code, json.dumps(child_cfg), dev],
        cwd=str(ROOT), env=dict(os.environ), capture_output=True,
        text=True, timeout=900)
    killed_s = time.perf_counter() - t0
    prefix = read_jsonl(str(log_path))
    if killed.returncode != -signal.SIGKILL or len(prefix) != kill + 1:
        raise AssertionError(
            f"sim-shard {tag_f}: the kill_after run exited "
            f"{killed.returncode} with {len(prefix)} rows: "
            f"{killed.stderr[-2000:]}")
    zero_counts(counted)
    t0 = time.perf_counter()
    SimulationEngine(dataclasses.replace(
        cfg, log_path=str(log_path), checkpoint_every=1,
        ckpt_dir=str(ckpt), resume=True), device=dev, emulate=True).run()
    resumed_s = time.perf_counter() - t0
    resumed_launches = read_counts(counted)
    logged = read_jsonl(str(log_path))
    _check_rows(f"{tag_f} resumed", logged, rounds_f)
    after = _decisions_differ(logged, straight)
    log(f"[sim-shard] {tag_f}: {recovered} devices recovered; straight "
        f"{wall:.3f} s, killed child {killed_s:.3f} s, resumed "
        f"{resumed_s:.3f} s; the stitched log "
        f"{'agrees' if not after else 'differs at ' + str(after)} with "
        f"the straight run on the decisions, floats apart by "
        f"{_floats_apart(logged, straight)}; launches {launches} "
        f"straight, {resumed_launches} resumed")
    if after:
        raise AssertionError(f"sim-shard {tag_f}: the resumed run differs "
                             f"from the straight one at {after}")
    want = (rounds_f - kill - 1) * per_round
    if resumed_launches["alpha_combine"] != want:
        raise AssertionError(f"sim-shard {tag_f} resumed: launches "
                             f"{resumed_launches}, alpha_combine should be "
                             f"{want}")
    out["faulty"] = dict(wall_s=wall, killed_child_s=killed_s,
                         resumed_s=resumed_s, recovered=recovered,
                         launches=launches,
                         resumed_launches=resumed_launches,
                         events=[r["events"] for r in straight],
                         reasons=[r["resolve_reason"] for r in straight])
    report["sim_shard"] = out
    return out


def phase_pool_scale(ac, counted, report, dev="cuda"):
    """The pool's phases at simulator scale, as benchmarks/sim_scale.py's
    dry rows take them (no bootstrap, no solve): the sim's default
    100 samples and 30 SGD steps at N devices, through the sharded pool
    at mesh 1 and at an emulated mesh of k, each phase timed twice on
    the host clock up to a synchronize (the first call carries cuDNN's
    algorithm choice), counted: training, a 64-pair Algorithm-1 batch,
    the transfer (one ``alpha_combine_slab`` of (N, N / k) a shard) and
    the accuracy sweep.  Each shard's slab against the plain version
    (rtol/atol 1e-5), and the sharded transfer against the single-device
    pool's."""
    from repro_torch.fl.client import sample_train_indices
    from repro_torch.nn.param import flatten_to_vector
    from repro_torch.rng import generator
    from repro_torch.sim import SimConfig, SimulationEngine
    from repro_torch.sim.shard import LocalPool, ShardedPool

    n, k, npairs = POOL_SCALE
    t0 = time.perf_counter()
    eng = SimulationEngine(SimConfig(scenario="static", devices=n,
                                     rounds=1, mesh=1), device=dev)
    build_s = time.perf_counter() - t0
    st, cfg = eng.state, eng.cfg
    pools = {"mesh 1": eng.pool,
             f"mesh {k} (emulated)": ShardedPool(eng, k, emulate=True)}
    gen = torch.Generator(device=dev).manual_seed(7)
    params = {name: v + 0.01 * torch.randn(v.shape, device=dev,
                                           generator=gen)
              for name, v in st.params.items()}       # distinct devices
    # every other device a target, so every shard owns targets; every
    # column a distinct random mixture of the sources, so every shard's
    # slab has distinct non-zero columns
    psi = np.zeros(n)
    psi[1::2] = 1.0
    alpha = np.zeros((n, n))
    alpha[psi == 0] = np.random.default_rng(11).random((n - n // 2, n))
    alpha /= alpha.sum(0, keepdims=True)
    pairs = np.stack([np.arange(npairs), np.arange(npairs) + n // 2], 1)
    draws = sample_train_indices(st.clients, generator(1),
                                 iters=cfg.train_iters, batch=cfg.batch)
    phases = {
        "train": lambda pool: pool.train(params, st.clients, None,
                                         st.active, draws=draws),
        f"divergence_{npairs}pairs": lambda pool: pool.update_divergences(
            st.div_hat, st.clients, 1, pairs),
        "transfer": lambda pool: pool.transfer(params, alpha, psi),
        "accuracies": lambda pool: pool.accuracies(params, st.clients)}
    rows = {}
    for pname, pool in pools.items():
        for phase, fn in phases.items():
            times = []
            zero_counts(counted)
            for _ in range(2):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn(pool)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
            launches = read_counts(counted)
            want = 2 * _sharded_launches(ac, n, pool.n_shards) \
                if phase == "transfer" else 0
            rows[f"{pname} {phase}"] = dict(first_s=times[0],
                                            steady_s=times[1],
                                            launches=launches)
            log(f"[pool-scale] n={n} {pname} {phase}: first "
                f"{times[0]:.4f} s, steady {times[1]:.4f} s; launches "
                f"{launches} (alpha_combine: {want} wanted)")
            if launches["alpha_combine"] != want or any(
                    v for kn, v in launches.items() if kn != "alpha_combine"):
                raise AssertionError(f"pool-scale {pname} {phase}: "
                                     f"launches {launches}")
    # each shard's slab against the plain version, and the sharded
    # transfer against the single-device pool's
    flat = flatten_to_vector(params, lead=1).contiguous()
    a = torch.as_tensor(alpha, dtype=torch.float32, device=dev)
    blk = n // k
    slab_err = 0.0
    for s in range(k):
        cols = a[:, s * blk:(s + 1) * blk]
        kern = ac.alpha_combine_slab(flat, cols)
        plain = ac.alpha_combine_plain(flat, cols.contiguous())
        slab_err = max(slab_err, float((kern - plain).abs().max()))
        if not torch.allclose(kern, plain, rtol=1e-5, atol=1e-5):
            raise AssertionError(f"pool-scale: shard {s}'s slab ({n}, "
                                 f"{blk}) differs from the plain version")
    gaps, ok = _transfers_apart(dict(local=LocalPool(eng), **pools),
                                params, alpha, psi)
    log(f"[pool-scale] n={n}: build {build_s:.1f} s; {k} slabs ({n}, "
        f"{blk}, {flat.shape[1]}) vs plain: max abs err {slab_err:.3g}; "
        f"transfers vs the local pool's: {gaps}")
    if not ok:
        raise AssertionError(f"pool-scale: the sharded transfers differ "
                             f"from the local one by {gaps}")
    report["pool_scale"] = dict(n=n, mesh=k, build_s=build_s, phases=rows,
                                slab_max_abs_err=slab_err,
                                transfer_gaps=gaps)
    del eng, pools, params, flat
    torch.cuda.empty_cache()
    return report["pool_scale"]


def phase_packed_solver(state, report, dev="cuda"):
    """``solve_stlf(inner_impl="packed")`` (the gather / scatter-add
    evaluator) against the structured default on the main path's
    problem, capped: equal psi, alpha within 1e-3; ms per Adam step of
    each on the host clock."""
    from repro_torch.core.problem import STLFProblem
    from repro_torch.core.solver import solve_stlf

    prob = STLFProblem(state.bounds, state.energy)
    max_outer, steps = PACKED_SOLVE
    res = {impl: solve_stlf(prob, max_outer=max_outer, inner_steps=steps,
                            inner_impl=impl, device=dev)
           for impl in ("structured", "packed")}
    a, b = res["structured"], res["packed"]
    ms = {impl: r.solve_time_s / max(r.inner_steps, 1) * 1e3
          for impl, r in res.items()}
    gap = float(np.abs(a.alpha - b.alpha).max())
    log(f"[solver] packed vs structured at N={prob.n} ({max_outer} x "
        f"{steps}): psi {'equal' if np.array_equal(a.psi, b.psi) else 'differ'}"
        f", alpha max abs gap {gap:.3g}; ms per Adam step: structured "
        f"{ms['structured']:.3f} ({a.inner_steps} steps, pack "
        f"{a.pack_time_s * 1e3:.2f} ms), packed {ms['packed']:.3f} "
        f"({b.inner_steps} steps, pack {b.pack_time_s * 1e3:.2f} ms)")
    if not (np.array_equal(a.psi, b.psi) and gap <= 1e-3):
        raise AssertionError("solve_stlf: the packed path decides "
                             "otherwise than the structured one")
    report["packed_solver"] = dict(ms_per_step=ms, alpha_gap=gap,
                                   steps={i: r.inner_steps
                                          for i, r in res.items()})
    return report["packed_solver"]


def phase_small_sim(report, devs=("cuda", "cpu")):
    """Small runs (sync and async) on the GPU against the port on the CPU
    (which the CPU tests hold against the JAX package), on the port's own
    seeds:
    the decisions equal, the floats within the bars below."""
    from repro_torch.sim import SimConfig, SimulationEngine
    out = {}
    for scenario, engine, seed in SMALL_SIM:
        a, b = (SimulationEngine(
            SimConfig(scenario=scenario, engine=engine, seed=seed,
                      **SMALL_SIM_CFG), device=dev).run() for dev in devs)
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
        log(f"[small] sim {scenario} ({engine}, seed {seed}, {len(a)} "
            f"rounds): "
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


# ---------------------------------------------------------------- 9. mesh
def _on_mesh(make, cfg, shape, dm, rules=None):
    """(bundle on the ``DeviceMesh`` ``dm`` under ``rules`` (default: the
    default rules), its step on the mesh)."""
    from repro_torch.launch import steps
    from repro_torch.nn import sharding as shd
    bundle = make(cfg, shape, dm, rules or shd.DEFAULT_RULES)
    return bundle, steps.on_mesh(bundle, dm)


def _mesh_lm(arch, over, model_axis, prefill, decode_steps, routes,
             baseline=False, seed=0):
    """An LM's steps on the ('data', 'model') mesh of the world this
    process is a rank of (``model_axis`` wide): parameters drawn shard
    by shard on the mesh (``LMBase.init(mesh=...)`` from ``seed``); a
    prefill of ``prefill`` (B, S) seeded tokens through each attention
    route of ``routes`` via the prefill bundle on the mesh
    (``steps.on_mesh``, a first call apart, the flash launches counted);
    ``decode_steps`` decode steps at batch B through the decode bundle
    (the prompt's first tokens fed in turn, the sharded cache updated in
    place).  With ``baseline`` (a world of one) the same calls run
    without a mesh on the gathered parameters.  Returns, on rank 0, the
    gathered logits (CPU), the times, the launches and every card's peak
    memory; None on the other ranks."""
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import steps
    from repro_torch.models.api import build_model
    from repro_torch.nn import sharding as shd

    dev = torch.device("cuda", torch.cuda.current_device())
    dm = mesh_lib.make_device_mesh(model_axis, device_type="cuda")
    cfg = dataclasses.replace(get_config(arch), **over)
    model = build_model(cfg)
    torch.cuda.empty_cache()
    live = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    params, init_s = _timed(lambda: model.init(
        torch.Generator(device=dev).manual_seed(seed), dev, mesh=dm,
        rules=shd.DEFAULT_RULES))
    b, s = prefill
    toks = torch.randint(0, cfg.vocab_size, (b, s), device=dev,
                         generator=torch.Generator(device=dev)
                         .manual_seed(seed + 1))
    plain = shd.full(params) if baseline else None
    out = dict(mesh=dict(zip(dm.mesh_dim_names, dm.shape)), init_s=init_s,
               prefill={}, plain_prefill={})
    for route in routes:
        rcfg = dataclasses.replace(cfg, attention_impl=route)
        _, run = _on_mesh(steps.make_prefill_bundle, rcfg,
                          InputShape("mesh", s, b, "prefill"), dm)
        run(params, {"tokens": toks})
        before = fa.flash_attention.launches
        logits, sec = _timed(lambda: run(params, {"tokens": toks}))
        out["prefill"][route] = dict(
            logits=shd.full(logits).float().cpu(), s=sec,
            tok_per_s=b * s / sec,
            launches=fa.flash_attention.launches - before)
        del logits
        if baseline:
            ref = build_model(rcfg)
            ref.prefill(plain, {"tokens": toks})
            logits, sec = _timed(lambda: ref.prefill(plain, {"tokens": toks}))
            out["plain_prefill"][route] = dict(logits=logits.float().cpu(),
                                               s=sec, tok_per_s=b * s / sec)
            del logits
        torch.cuda.empty_cache()

    def decode(step, cache):
        logits, secs = [], []
        for i in range(decode_steps):
            lg, sec = _timed(lambda: step(cache, {
                "token": toks[:, i:i + 1],
                "pos": torch.full((b,), i, device=dev)}))
            logits.append(shd.full(lg).float().cpu())
            secs.append(sec)
        return dict(logits=torch.stack(logits), s=secs,
                    ms_per_step=sum(secs[1:]) / (len(secs) - 1) * 1e3,
                    tok_per_s=b * (len(secs) - 1) / sum(secs[1:]))

    # the cache as long as the prompt and the steps, its first slots fed
    bundle, run = _on_mesh(steps.make_decode_bundle, cfg, InputShape(
        "mesh", s + decode_steps, b, "decode"), dm)
    cache = shd.distribute(model.init_cache(b, s + decode_steps,
                                            device=dev),
                           bundle.in_shardings[1], dm)
    out["decode"] = decode(lambda c, bt: run(params, c, bt)[0], cache)
    first = cache["k"].to_local()[:, :, 0]
    if not bool(first.abs().sum() > 0):
        raise AssertionError("the decode steps left the sharded cache "
                             "empty: it was not updated in place")
    del cache, first
    if baseline:
        cache = model.init_cache(b, s + decode_steps, device=dev)
        out["plain_decode"] = decode(
            lambda c, bt: model.decode_step(plain, c, bt)[0], cache)
        del cache
    out["peak_gb"] = (torch.cuda.max_memory_allocated(dev) - live) / 1e9
    peaks = [None] * dist.get_world_size()
    dist.all_gather_object(peaks, out["peak_gb"])
    out["peak_gb_by_card"] = peaks
    del params, plain
    torch.cuda.empty_cache()
    return out if dist.get_rank() == 0 else None


def _mesh_train(arch, model_axis, shape, n_steps, baseline=False, seed=0,
                reduced=False):
    """``n_steps`` fp32-compute train steps of ``arch`` (``reduced``: its
    reduced() config) at ``shape`` (B, S) through the train bundle on
    the mesh of this world (parameters drawn on the mesh from ``seed``,
    fp32 moments), on the batches ``_train_batch`` seeds 100, 101, ...
    (and seeded frames for the encoder-decoder); with ``baseline`` (a
    world of one) the same steps through ``make_train_step`` without a
    mesh on the gathered parameters.  Rank 0 returns the losses, the
    first batch's gradients, the ms a step (the first apart), the peak
    memory and the gathered parameters before and after (CPU)."""
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import steps
    from repro_torch.models.api import build_model
    from repro_torch.nn import sharding as shd
    from repro_torch.nn.layers import ShardCtx
    from repro_torch.nn.param import tree_leaves
    from repro_torch.optim import adamw

    dev = torch.device("cuda", torch.cuda.current_device())
    dm = mesh_lib.make_device_mesh(model_axis, device_type="cuda")
    cfg = get_config(arch)
    cfg = dataclasses.replace(cfg.reduced() if reduced else cfg,
                              dtype="float32", remat=False)
    model = build_model(cfg)
    torch.cuda.empty_cache()
    live = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    params = model.init(torch.Generator(device=dev).manual_seed(seed), dev,
                        mesh=dm, rules=shd.DEFAULT_RULES)
    b, s = shape
    batches = [_train_batch(cfg.vocab_size, b, s, 100 + i)
               for i in range(n_steps)]
    if cfg.encdec is not None:
        gen = torch.Generator(device=dev).manual_seed(seed + 100)
        for bt in batches:
            bt["src_embeds"] = torch.randn(b, cfg.encdec.encoder_seq,
                                           cfg.d_model, device=dev,
                                           generator=gen)
    opt = adamw(TRAIN_LR, weight_decay=0.1, state_dtype=torch.float32)
    init = [t.cpu() for t in tree_leaves(shd.full(params))]

    def run(step, p, loss_fn):
        _, grads = steps.value_and_grad(loss_fn, p)
        grads = [t.double().cpu() for t in tree_leaves(shd.full(grads))]
        st, losses, secs = opt.init(p), [], []
        for bt in batches:
            (p, st, loss, _), sec = _timed(lambda: step(p, st, bt))
            losses.append(float(shd.full(loss)))
            secs.append(sec)
        return dict(losses=losses, grads=grads,
                    ms_per_step=sum(secs[1:]) / (len(secs) - 1) * 1e3,
                    params=[t.cpu() for t in tree_leaves(shd.full(p))])

    bundle, step = _on_mesh(lambda *a: steps.make_train_bundle(
        *a, lr=TRAIN_LR, opt_state_dtype=torch.float32), cfg,
        InputShape("mesh", s, b, "train"), dm)
    first = shd.distribute(batches[0], bundle.in_shardings[2], dm)
    ctx = ShardCtx(dm, shd.DEFAULT_RULES)
    out = dict(mesh=dict(zip(dm.mesh_dim_names, dm.shape)), init=init,
               mesh_run=run(step, params,
                            lambda q: model.loss(q, first, ctx)))
    if baseline:
        plain = _whole(params)
        out["plain_run"] = run(steps.make_train_step(
            cfg, lr=TRAIN_LR, opt_state_dtype=torch.float32), plain,
            lambda q: model.loss(q, batches[0]))
    out["peak_gb"] = (torch.cuda.max_memory_allocated(dev) - live) / 1e9
    del params
    torch.cuda.empty_cache()
    return out if dist.get_rank() == 0 else None


def _whole(tree):
    """The DTensors of a parameter tree (nested dicts) of a world of one
    rank as plain tensors: each rank's local tensor is then the whole
    leaf (a view, no copy)."""
    from repro_torch.nn.param import tree_map
    from torch.distributed.tensor import DTensor
    return tree_map(lambda t: t.to_local() if isinstance(t, DTensor) else t,
                    tree)


def _comm_bytes(counter):
    """The bytes each collective moved on this rank while ``counter`` (a
    ``launch.hlo.StepCounter``) was active, by its rule: a collective's
    result bytes, twice that for an all-reduce."""
    return {k: b for k, (_, b) in counter.analysis().per_collective.items()}


def _gla_calls(ss, calls):
    """Note the local (B, L, H, Dk) of q at each launch of the ssm_scan
    kernels (on a mesh, this rank's shard) in ``calls``; returns the
    function that stops it."""
    launch = ss._gla_launch

    def noted(q, *args):
        calls.append(tuple(q.shape))
        return launch(q, *args)

    ss._gla_launch = noted
    return lambda: setattr(ss, "_gla_launch", launch)


def _family_calls(cfg, model, params, ctx, prefill, decode_steps, plain,
                  pins, seed):
    """One family's calls on the mesh of ``ctx`` in ``cfg``'s compute
    dtype: the prefill of ``prefill`` (B, S) seeded tokens (and frames)
    through the prefill bundle (a first call apart; the flash and
    ssm_scan launches and rank 0's local q shapes at the scan counted);
    for MoE, given ``pins`` or ``plain``, the mesh's routing against
    ``pins`` (or the plain routing) and a prefill with that routing
    pinned; ``decode_steps`` decode steps
    at batch B through the decode bundle (seamless's cross cache built on
    the mesh).  With ``plain`` (a world of one: the whole parameters) the
    same calls without a mesh.  Logits gathered to the CPU."""
    from repro_torch.configs.base import InputShape
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.ssm_scan import ops as ss
    from repro_torch.launch import steps
    from repro_torch.launch.hlo import StepCounter
    from repro_torch.models.common import take_layer
    from repro_torch.nn import sharding as shd
    from repro_torch.nn.layers import NO_SHARD, embed

    dm = ctx.mesh
    dev = torch.device("cuda", torch.cuda.current_device())
    b, s = prefill
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (b, s), device=dev,
                                     generator=gen)}
    if cfg.encdec is not None:
        batch["src_embeds"] = torch.randn(
            b, cfg.encdec.encoder_seq, cfg.d_model, device=dev,
            generator=gen)
    bundle, run = _on_mesh(steps.make_prefill_bundle, cfg, InputShape(
        "mesh", s, b, "prefill"), dm, ctx.rules)
    run(params, batch)
    calls = []
    stop = _gla_calls(ss, calls)
    f0, s0 = fa.flash_attention.launches, ss.gla_chunked.launches
    try:
        logits, sec = _timed(lambda: run(params, batch))
    finally:
        stop()
    out = dict(prefill=dict(
        logits=shd.full(logits).float().cpu(), s=sec, tok_per_s=b * s / sec,
        flash=fa.flash_attention.launches - f0,
        ssm_kernels=ss.gla_chunked.launches - s0, gla_calls=len(calls),
        gla_local=sorted(set(calls))))
    del logits
    db = shd.distribute(batch, bundle.in_shardings[1], dm)
    if dm.size() > 1:
        # what the prefill's redistributions move on this rank (an extra
        # call, untimed); zamba2's first mamba layer alone
        with StepCounter() as comm:
            run(params, batch)
        out["prefill"]["comm_bytes"] = _comm_bytes(comm)
        out["prefill"]["comm_largest"] = comm.largest()
        if cfg.hybrid is not None:
            x = ctx.constrain(embed(db["tokens"], params["embedding"],
                                    getattr(torch, cfg.dtype)),
                              "batch", None, "embed_act")
            lp = take_layer(params["layers"], 0)
            with StepCounter() as comm:
                model._mamba_layer(lp, x, "kernel", ctx)
            out["mamba_layer_comm_bytes"] = _comm_bytes(comm)
            del x
    if plain is not None:
        model.prefill(plain, batch)
        logits, sec = _timed(lambda: model.prefill(plain, batch))
        out["plain_prefill"] = dict(logits=logits.float().cpu(), s=sec,
                                    tok_per_s=b * s / sec)
        del logits
    if cfg.moe is not None and (plain is not None or pins is not None):
        ids = shd.full(model.routing(params, db, ctx)).cpu()
        ref = model.routing(plain, batch).cpu() if plain is not None \
            else pins
        flips, total, drop = moe_routing_stats(cfg.moe, ids, ref)
        out.update(routing=ref, flips=flips, choices=total, dropped=drop)
        pin = ref.to(dev)
        out["pinned"] = shd.full(model.prefill(
            params, dict(db, expert_ids=pin), ctx)).float().cpu()
        if plain is not None:
            out["plain_pinned"] = model.prefill(
                plain, dict(batch, expert_ids=pin)).float().cpu()
    torch.cuda.empty_cache()

    bundle, run = _on_mesh(steps.make_decode_bundle, cfg, InputShape(
        "mesh", s + decode_steps, b, "decode"), dm, ctx.rules)

    def cache_for(p, c):
        cache = model.init_cache(b, s + decode_steps, device=dev)
        if cfg.encdec is not None:
            src = (db if c is not NO_SHARD else batch)["src_embeds"]
            cache["cross"] = model.build_cross_cache(
                p, model._encode(p, src, c), c)
        return cache

    def decode(step, cache):
        logits, secs = [], []
        for i in range(decode_steps):
            lg, sec = _timed(lambda: step(cache, {
                "token": batch["tokens"][:, i:i + 1],
                "pos": torch.full((b,), i, device=dev)}))
            logits.append(shd.full(lg).float().cpu())
            secs.append(sec)
        return dict(logits=torch.stack(logits), s=secs,
                    ms_per_step=sum(secs[1:]) / (len(secs) - 1) * 1e3)

    cache = shd.distribute(cache_for(params, ctx), bundle.in_shardings[1],
                           dm)
    out["decode"] = decode(lambda c, bt: run(params, c, bt)[0], cache)
    del cache
    if plain is not None:
        out["plain_decode"] = decode(
            lambda c, bt: model.decode_step(plain, c, bt)[0],
            cache_for(plain, NO_SHARD))
    torch.cuda.empty_cache()
    return out


def _mesh_families(model_axis, specs, prefill, decode_steps, f32_prefill,
                   trains, baseline=False, pins=None, seed=0):
    """Phase 9's other families on the ('data', 'model') mesh of the
    world this process is a rank of (``model_axis`` wide).  ``specs``:
    (arch, config overrides, rule set); each family's parameters drawn
    shard by shard on the mesh from ``seed`` under its rules, then its
    calls (``_family_calls``) in bf16 at ``prefill`` and in fp32 compute
    at ``f32_prefill`` (None: bf16 alone), then freed.  ``trains``:
    (arch, (steps, B, S)) of fp32 train steps at reduced()
    (``_mesh_train``).  With ``baseline`` (a world of one) each call and
    train step also without a mesh; ``pins`` ({(arch, dtype): expert
    ids}) gives a MoE family the routing to pin and to count flips
    against.  Returns, on rank 0, {spec: results} with every card's
    peak memory over the calls (the parameters included, their draw's
    own peak not), and {("train", arch): results}."""
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models.api import build_model
    from repro_torch.nn import sharding as shd
    from repro_torch.nn.layers import ShardCtx

    dev = torch.device("cuda", torch.cuda.current_device())
    dm = mesh_lib.make_device_mesh(model_axis, device_type="cuda")
    out = {}
    for arch, over, rules in specs:
        ctx = ShardCtx(dm, shd.RULE_SETS[rules])
        cfg = dataclasses.replace(get_config(arch), attention_impl="kernel",
                                  **over)
        torch.cuda.empty_cache()
        live = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        params, init_s = _timed(lambda: build_model(cfg).init(
            torch.Generator(device=dev).manual_seed(seed), dev, mesh=dm,
            rules=ctx.rules))
        torch.cuda.reset_peak_memory_stats(dev)
        plain = _whole(params) if baseline else None
        r = dict(mesh=dict(zip(dm.mesh_dim_names, dm.shape)), rules=rules,
                 init_s=init_s,
                 params_gb=(torch.cuda.memory_allocated(dev) - live) / 1e9)
        runs = [("bf16", cfg, prefill, decode_steps)]
        if f32_prefill is not None:
            runs.append(("f32", dataclasses.replace(cfg, dtype="float32"),
                         f32_prefill, 2))
        for tag, c, shape, n in runs:
            r[tag] = _family_calls(
                c, build_model(c), params, ctx, shape, n, plain,
                None if pins is None else pins.get((arch, tag)), seed)
        r["peak_gb"] = (torch.cuda.max_memory_allocated(dev) - live) / 1e9
        peaks = [None] * dist.get_world_size()
        dist.all_gather_object(peaks, r["peak_gb"])
        r["peak_gb_by_card"] = peaks
        out[(arch, rules)] = r
        del params, plain
    for arch, (n_steps, b, s) in trains:
        out[("train", arch)] = _mesh_train(arch, model_axis, (b, s),
                                           n_steps, baseline=baseline,
                                           reduced=True)
    torch.cuda.empty_cache()
    return out if dist.get_rank() == 0 else None


def _steps_apart(a, b, init):
    """Two train runs compared: the largest relative loss gap, and each
    leaf's change apart over its change's norm (the largest leaf)."""
    loss_rel = max(abs(x - y) / abs(y) for x, y in zip(a["losses"],
                                                      b["losses"]))
    delta_rel = max(float(((x - p0) - (y - p0)).norm()
                          / (y - p0).norm().clamp_min(1e-30))
                    for x, y, p0 in zip(a["params"], b["params"], init))
    return loss_rel, delta_rel


def _hold(a, b, what, argmax_share=1.0, **tol):
    """Raise unless two logit tensors agree within ``tol`` with equal
    argmax in every row (in ``argmax_share`` of the rows at least);
    returns the max abs difference."""
    diff = float((a - b).abs().max())
    share = float((a.argmax(-1) == b.argmax(-1)).float().mean())
    if not (torch.isfinite(a).all() and torch.allclose(a, b, **tol)
            and share >= argmax_share):
        raise AssertionError(f"{what}: max |dlogit| {diff:.4g} beyond "
                             f"{tol} or the argmax equal in {share:.4g} "
                             f"of the rows (bar {argmax_share})")
    return diff


def _gloo_one_card(world):
    """A rank of ``world`` gloo ranks that all use cuda:0: one DTensor
    all-gather of a (1, world)-sharded tensor on the card."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Shard, distribute_tensor
    dm = init_device_mesh("cuda", (1, world),
                          mesh_dim_names=("data", "model"))
    x = distribute_tensor(torch.arange(8.0, device="cuda")[None]
                          .expand(4, 8).contiguous(), dm,
                          [Shard(0), Shard(1)], src_data_rank=None)
    return float(x.full_tensor().sum()) if dist.get_rank() == 0 else None


def _family_specs(expert_parallel=True):
    """(arch, overrides, rule set) of each MESH_FAMILIES run; the
    expert_parallel runs only where ``expert_parallel`` (9b's (k, 1):
    on 9a's (1, 1) every placement is Replicate under either rule set,
    so 9a runs the default rules alone, and 9b holds its expert_parallel
    runs against them)."""
    return [(a, o, r) for a, o, rs in MESH_FAMILIES for r in rs
            if r == "default" or expert_parallel]


def _family_trains():
    return [(a, MESH_FAMILY_TRAIN) for a, _, _ in MESH_FAMILIES]


def _family_launches(out, r, mesh):
    """Rank 0's flash and ssm_scan launches of each family's bf16 prefill
    on ``mesh``, into phase 9's counts by path."""
    for (arch, rules), fr in r.items():
        if arch == "train":
            continue
        pre = fr["bf16"]["prefill"]
        where = f"{arch} prefill {MESH_PREFILL} on {mesh} {rules}, rank 0"
        if pre["flash"]:
            out["launches"][where] = pre["flash"]
        if pre["ssm_kernels"]:
            out["ssm_launches"][where] = pre["ssm_kernels"]


def _check_families(tag, r, ref, mesh):
    """Phase 9's other families on ``mesh`` held against the same calls
    without a mesh (9a: ``ref`` None, each result carries its plain
    calls) or against 9a's mesh results ``ref``: bf16 within LM_TOL with
    equal argmax, fp32 compute within MESH_F32_TOL (9a) or
    MESH_F32_TOL_FAMILIES; MoE prefills with the routing pinned (the
    unpinned flips counted) and its decode held in fp32 compute (a bf16
    near tie may flip under another summation order: its gap is
    reported); the kernel launches a prefill on rank 0 (rwkv6 one
    ssm_scan call a layer, three kernels each; zamba2-7b one a mamba
    layer and one flash launch a shared-attention group; the MoE decoder
    one flash launch a layer; the encoder-decoder none) and rank 0's
    local q shape at the scan (batch over 'data', heads over 'model');
    the reduced() train steps (losses, first-step gradients, the
    parameters' changes).  On a sharded mesh zamba2-7b's bf16 calls are
    held at MESH_BF16_TOL_DEEP with the argmax equal in
    MESH_BF16_ARGMAX_DEEP of the rows: each rank rounds its partial
    bf16 products before they are summed, which its 95 blocks grow past
    LM_TOL.  An expert_parallel run is held against 9a's default run
    (the same placements on (1, 1)).  Returns the numbers."""
    from repro_torch.configs import get_config
    from repro_torch.nn.mamba import dims
    d, m = mesh
    f32_tol = MESH_F32_TOL if ref is None else MESH_F32_TOL_FAMILIES
    summary = {}
    for key, fr in r.items():
        arch, rules = key
        if arch == "train":
            continue
        deep = ref is not None and arch in MESH_BF16_TOL_DEEP

        def held(a, b, what, call, **tol):
            if deep and tol == LM_TOL:
                return _hold(a, b, what, MESH_BF16_ARGMAX_DEEP[call],
                             **MESH_BF16_TOL_DEEP[arch])
            return _hold(a, b, what, **tol)

        over = next(o for a, o, _ in MESH_FAMILIES if a == arch)
        cfg = dataclasses.replace(get_config(arch), **over)
        row = dict(init_s=fr["init_s"], peak_gb_by_card=fr["peak_gb_by_card"])
        for dt in ("bf16", "f32"):
            x = fr[dt]
            tol = LM_TOL if dt == "bf16" else f32_tol
            base = None if ref is None else ref[
                key if key in ref else (arch, "default")][dt]
            want_pre = x["plain_prefill"]["logits"] if base is None \
                else base["prefill"]["logits"]
            want_dec = x["plain_decode"]["logits"] if base is None \
                else base["decode"]["logits"]
            what = f"{tag} {arch} ({rules}) {dt}"
            if cfg.moe is not None:
                want_pin = x["plain_pinned"] if base is None \
                    else base["pinned"]
                row[f"{dt}_pinned_prefill_dlogit"] = held(
                    x["pinned"], want_pin, f"{what} pinned prefill",
                    "prefill", **tol)
                row[f"{dt}_flips"] = (x["flips"], x["choices"])
                row[f"{dt}_unpinned_prefill_dlogit"] = float(
                    (x["prefill"]["logits"] - want_pre).abs().max())
                if dt == "bf16":
                    row["bf16_decode_dlogit"] = float(
                        (x["decode"]["logits"] - want_dec).abs().max())
                else:
                    row["f32_decode_dlogit"] = _hold(
                        x["decode"]["logits"], want_dec,
                        f"{what} decode", **tol)
            else:
                row[f"{dt}_prefill_dlogit"] = held(
                    x["prefill"]["logits"], want_pre, f"{what} prefill",
                    "prefill", **tol)
                row[f"{dt}_decode_dlogit"] = held(
                    x["decode"]["logits"], want_dec, f"{what} decode",
                    "decode", **tol)
            row[f"{dt}_prefill_s"] = x["prefill"]["s"]
            row[f"{dt}_decode_ms"] = x["decode"]["ms_per_step"]
            if base is None:
                row[f"{dt}_plain_prefill_s"] = x["plain_prefill"]["s"]
                row[f"{dt}_plain_decode_ms"] = \
                    x["plain_decode"]["ms_per_step"]
        pre = fr["bf16"]["prefill"]
        if cfg.arch_type == "ssm":
            want = dict(gla=cfg.num_layers, flash=0)
            heads = cfg.num_heads
        elif cfg.hybrid is not None:
            k = cfg.hybrid.attn_every
            want = dict(gla=cfg.num_layers, flash=-(-cfg.num_layers // k))
            heads = dims(cfg)[1]
        else:
            want = dict(gla=0, flash=0 if cfg.encdec is not None
                        else cfg.num_layers)
            heads = None
        got = dict(gla=pre["gla_calls"], flash=pre["flash"])
        if got != want or pre["ssm_kernels"] != 3 * want["gla"]:
            raise AssertionError(f"{tag} {arch}: rank 0's prefill launched "
                                 f"{got} (ssm_scan kernels "
                                 f"{pre['ssm_kernels']}), not {want}")
        if heads is not None:
            local = [(MESH_PREFILL[0] // d, MESH_PREFILL[1], heads // m)]
            if [q[:3] for q in pre["gla_local"]] != local:
                raise AssertionError(f"{tag} {arch}: rank 0's scans saw q "
                                     f"{pre['gla_local']}, not {local}")
        row.update(launches_rank0=got, ssm_kernels_rank0=pre["ssm_kernels"],
                   gla_local_q=pre["gla_local"],
                   prefill_tok_per_s=pre["tok_per_s"],
                   prefill_comm_bytes_rank0=pre.get("comm_bytes"),
                   prefill_comm_largest_rank0=pre.get("comm_largest"),
                   params_gb=fr["params_gb"],
                   mamba_layer_comm_bytes_rank0=fr["bf16"].get(
                       "mamba_layer_comm_bytes"))
        summary[f"{arch} {rules}"] = row
        flips = f"; routing flips bf16 {row['bf16_flips']}, fp32 " \
            f"{row['f32_flips']}" if cfg.moe is not None else ""
        vs = "without a mesh" if ref is None else "9a"
        log(f"[mesh] {tag} {arch} ({rules}) on {fr['mesh']}: prefill "
            f"{MESH_PREFILL} {row['bf16_prefill_s'] * 1e3:.1f} ms "
            + (f"(without a mesh {row['bf16_plain_prefill_s'] * 1e3:.1f} "
               f"ms) " if ref is None else "")
            + f"{pre['tok_per_s']:,.0f} tokens/s; decode "
            f"{row['bf16_decode_ms']:.2f} ms a step"
            + (f" (without {row['bf16_plain_decode_ms']:.2f})"
               if ref is None else "")
            + f"; rank 0 launches {got}, scan q {pre['gla_local']}; vs {vs} "
            f"{ {k: v for k, v in row.items() if 'dlogit' in k} }"
            f"{flips}; peak GB by card "
            f"{[round(p, 2) for p in fr['peak_gb_by_card']]}"
            + ("" if ref is None else
               f"; collective bytes on rank 0: a prefill "
               f"{row['prefill_comm_bytes_rank0']} (the largest buffers "
               f"{row['prefill_comm_largest_rank0']}), a mamba layer "
               f"{row['mamba_layer_comm_bytes_rank0']}"))
    for key, tr in r.items():
        if key[0] != "train":
            continue
        arch = key[1]
        base = tr["plain_run"] if ref is None else ref[key]["mesh_run"]
        init = [t.double() for t in tr["init"]]
        c = card_vs_cpu_steps(
            *((x["losses"], x["grads"], [t.double() for t in x["params"]])
              for x in (tr["mesh_run"], base)), init)
        grad_tol = TRAIN_GRAD_TOL if ref is None else MESH_GRAD_TOL_SHARDED
        bad = c["loss_rel"] > 1e-5 or c["grad_rel"] > grad_tol
        if ref is None:
            bad = bad or c["delta_rel"] > TRAIN_DELTA_TOL[arch] \
                or c["flipped_share"] > TRAIN_FLIP_SHARE
        c.update(ms_per_step=tr["mesh_run"]["ms_per_step"],
                 ref_ms_per_step=base["ms_per_step"])
        summary[f"{arch} train"] = c
        log(f"[mesh] {tag} {arch} reduced fp32 train {MESH_FAMILY_TRAIN}: "
            f"{c['ms_per_step']:.1f} ms a step vs {c['ref_ms_per_step']:.1f} "
            f"({'without a mesh' if ref is None else '9a'}); losses "
            f"{c['loss_rel']:.3g} apart, first-step gradients "
            f"{c['grad_rel']:.3g} of a leaf's norm, changes "
            f"{c['delta_rel']:.3g} past {c['flipped']} flipped elements "
            f"(at most {c['flipped_share']:.3g} of a leaf)")
        if bad:
            raise AssertionError(f"{tag} {arch} train steps: {c}")
    return summary


def phase_mesh(counted, report):
    """9a on every host: a world of one rank under ``nccl`` in this
    process; llama3.2-1b at full width, its (4, 2048) prefill on the
    kernel route (and on dot in fp32 compute) and 8 decode steps at batch
    4 through the bundles on the (1, 1) mesh, against the same calls
    without a mesh (bf16: LM_TOL and equal argmax; fp32 compute within
    MESH_F32_TOL), ``flash_attention`` once a layer a prefill through the
    op's sharding rule; repro-100m's 3 fp32 train steps at (8, 512) on
    the mesh against ``make_train_step``; the time of each beside its time
    without a mesh.  Then MESH_FAMILIES (rwkv6-1.6b, zamba2-7b and
    seamless-m4t at full width and depth, grok-1 at full width on 2 of 64
    layers under the default rules) the same way, their prefills counted
    through the ssm_scan and flash rules on rank 0, and their reduced()
    train steps (``_mesh_families``, ``_check_families``).  Then two
    gloo ranks on the one card.  9b, on 2 or more cards: llama3.2-1b on
    (1, k), (k, 1) and (2, 2) against 9a (LM_TOL in bf16,
    MESH_F32_TOL_SHARDED in fp32) and repro-100m's steps on (1, k) and
    ``launch.train --devices k --model-axis m``; the other families on
    (1, k) and (k, 1) against 9a (grok-1 also under expert_parallel on
    (k, 1), against 9a's default run), rank 0's scans on H/k heads on
    (1, k).  9c, on 4 or more
    cards: granite-34b at full width and depth on (1, 4); grok-1 at full
    width on MESH_GROK_LAYERS of 64 layers on (1, 4) under the default
    rules and on (4, 1) under expert_parallel, each card's peak memory
    under 80 GB."""
    import tempfile
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import train

    fa = counted["flash_attention"]
    cards = torch.cuda.device_count()
    out = {"cards": cards}
    b, s = MESH_PREFILL
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/rdzv",
                                world_size=1, rank=0,
                                device_id=torch.device("cuda", 0))
        try:
            zero_counts(counted)
            bf16 = _mesh_lm(LM_ARCH, {}, 1, MESH_PREFILL, MESH_DECODE,
                            ("kernel",), baseline=True)
            launches = read_counts(counted)
            f32 = _mesh_lm(LM_ARCH, {"dtype": "float32"}, 1, MESH_PREFILL,
                           MESH_DECODE, ("kernel", "dot"), baseline=True)
            tr = _mesh_train(TRAIN_ARCH, 1, MESH_TRAIN[1:], MESH_TRAIN[0],
                             baseline=True)
            t_fam = time.perf_counter()
            fam = _mesh_families(1, _family_specs(False), MESH_PREFILL,
                                 MESH_FAMILY_DECODE, MESH_FAMILY_F32,
                                 _family_trains(), baseline=True)
            fam_s = time.perf_counter() - t_fam
        finally:
            dist.destroy_process_group()
    k = bf16["prefill"]["kernel"]
    if k["launches"] != get_config(LM_ARCH).num_layers:
        raise AssertionError(f"the mesh prefill launched flash_attention "
                             f"{k['launches']} times, not once a layer")
    a9 = dict(mesh=bf16["mesh"], launches_bf16_runs=launches,
              flash_launches_a_prefill=k["launches"])
    a9["bf16_prefill_dlogit"] = _hold(
        k["logits"], bf16["plain_prefill"]["kernel"]["logits"],
        "9a bf16 prefill, mesh vs none", **LM_TOL)
    a9["bf16_decode_dlogit"] = _hold(
        bf16["decode"]["logits"], bf16["plain_decode"]["logits"],
        "9a bf16 decode, mesh vs none", **LM_TOL)
    for route in ("kernel", "dot"):
        a9[f"f32_prefill_{route}_dlogit"] = _hold(
            f32["prefill"][route]["logits"],
            f32["plain_prefill"][route]["logits"],
            f"9a fp32 prefill ({route}), mesh vs none", **MESH_F32_TOL)
    a9["f32_decode_dlogit"] = _hold(
        f32["decode"]["logits"], f32["plain_decode"]["logits"],
        "9a fp32 decode, mesh vs none", **MESH_F32_TOL)
    loss_rel, delta_rel = _steps_apart(tr["mesh_run"], tr["plain_run"],
                                       tr["init"])
    if loss_rel > MESH_F32_TOL["rtol"] or delta_rel > 1e-3:
        raise AssertionError(f"9a train steps, mesh vs none: losses "
                             f"{loss_rel:.3g} apart, changes {delta_rel:.3g}")
    a9.update(
        prefill_s=k["s"], plain_prefill_s=bf16["plain_prefill"]["kernel"]["s"],
        prefill_tok_per_s=k["tok_per_s"],
        decode_ms=bf16["decode"]["ms_per_step"],
        plain_decode_ms=bf16["plain_decode"]["ms_per_step"],
        f32_prefill_s={r: (f32["prefill"][r]["s"],
                           f32["plain_prefill"][r]["s"])
                       for r in ("kernel", "dot")},
        train_ms=tr["mesh_run"]["ms_per_step"],
        plain_train_ms=tr["plain_run"]["ms_per_step"],
        train_loss_rel=loss_rel, train_delta_rel=delta_rel,
        train_losses=tr["mesh_run"]["losses"], peak_gb=bf16["peak_gb"])
    log(f"[mesh] 9a {LM_ARCH} on {bf16['mesh']} (nccl, one rank): prefill "
        f"{MESH_PREFILL} kernel route {k['s'] * 1e3:.1f} ms on the mesh vs "
        f"{a9['plain_prefill_s'] * 1e3:.1f} ms without ({k['launches']} "
        f"flash launches through the sharding rule); decode "
        f"{a9['decode_ms']:.2f} vs {a9['plain_decode_ms']:.2f} ms a step; "
        f"max |dlogit| bf16 {a9['bf16_prefill_dlogit']:.3g} / "
        f"{a9['bf16_decode_dlogit']:.3g}, fp32 kernel "
        f"{a9['f32_prefill_kernel_dlogit']:.3g}, dot "
        f"{a9['f32_prefill_dot_dlogit']:.3g}, decode "
        f"{a9['f32_decode_dlogit']:.3g}")
    log(f"[mesh] 9a {TRAIN_ARCH} fp32 train {MESH_TRAIN[1:]}: "
        f"{a9['train_ms']:.1f} ms a step on the mesh vs "
        f"{a9['plain_train_ms']:.1f} without; losses {loss_rel:.3g} apart, "
        f"changes {delta_rel:.3g}")
    # two gloo ranks on the one card
    try:
        got = mesh_lib.launch(_gloo_one_card, 2, device_type="cuda",
                              args=(2,), backend="gloo",
                              timeout=MESH_GLOO_S)[0]
        a9["gloo_two_ranks_one_card"] = f"ran: sum {got}"
    except RuntimeError as e:
        lines = [ln for ln in str(e).splitlines() if ln.strip()]
        a9["gloo_two_ranks_one_card"] = (lines[0] + " ... "
                                         + lines[-1])[:400]
    log(f"[mesh] 9a two gloo ranks on one card: "
        f"{a9['gloo_two_ranks_one_card']}")
    a9["s"] = time.perf_counter() - t0
    out["9a"] = a9
    out["launches"] = {f"{LM_ARCH} prefill {MESH_PREFILL} on (1, 1)":
                       k["launches"]}
    out["ssm_launches"] = {}
    out["9a_families"] = _check_families("9a", fam, None, (1, 1))
    out["9a_families"]["s"] = fam_s
    _family_launches(out, fam, (1, 1))
    pins = {(a, tag): fam[(a, "default")][tag]["routing"]
            for a, _, _ in MESH_FAMILIES for tag in ("bf16", "f32")
            if "routing" in fam[(a, "default")][tag]}
    log(f"[mesh] 9a the other families: {fam_s:.1f} s")

    # 9b: two or more cards
    if cards < 2:
        log(f"[mesh] 9b needs 2 or more cards; this host has {cards}")
    else:
        kk = min(cards, 4)
        b9 = {}
        for d, m in [(1, kk), (kk, 1)] + ([(2, 2)] if cards >= 4 else []):
            for tag, over, ref, tol in (
                    ("bf16", {}, bf16, LM_TOL),
                    ("f32", {"dtype": "float32"}, f32,
                     MESH_F32_TOL_SHARDED)):
                r = mesh_lib.launch(
                    _mesh_lm, d * m, device_type="cuda", timeout=900,
                    args=(LM_ARCH, over, m, MESH_PREFILL, MESH_DECODE,
                          ("kernel",)))[0]
                rk = r["prefill"]["kernel"]
                row = dict(
                    prefill_dlogit=_hold(rk["logits"],
                                         ref["prefill"]["kernel"]["logits"],
                                         f"9b {tag} prefill on {(d, m)}",
                                         **tol),
                    decode_dlogit=_hold(r["decode"]["logits"],
                                        ref["decode"]["logits"],
                                        f"9b {tag} decode on {(d, m)}",
                                        **tol),
                    prefill_s=rk["s"], prefill_tok_per_s=rk["tok_per_s"],
                    launches_rank0=rk["launches"],
                    decode_ms=r["decode"]["ms_per_step"],
                    decode_tok_per_s=r["decode"]["tok_per_s"],
                    peak_gb_by_card=r["peak_gb_by_card"])
                b9[f"{LM_ARCH} {tag} {(d, m)}"] = row
                out["launches"][f"{LM_ARCH} prefill {MESH_PREFILL} on "
                                f"{(d, m)}, rank 0"] = rk["launches"]
                log(f"[mesh] 9b {LM_ARCH} {tag} on {(d, m)}: prefill "
                    f"{rk['s'] * 1e3:.1f} ms ({rk['tok_per_s']:,.0f} "
                    f"tokens/s, {rk['launches']} launches on rank 0), decode "
                    f"{row['decode_ms']:.2f} ms a step; vs 9a max |dlogit| "
                    f"{row['prefill_dlogit']:.3g} / {row['decode_dlogit']:.3g};"
                    f" peak GB by card {[round(p, 2) for p in r['peak_gb_by_card']]}")
        for d, m in [(1, kk), (kk, 1)]:
            r = mesh_lib.launch(_mesh_train, d * m, device_type="cuda",
                                timeout=900,
                                args=(TRAIN_ARCH, m, MESH_TRAIN[1:],
                                      MESH_TRAIN[0]))[0]
            if not all(torch.equal(x, y) for x, y in zip(r["init"],
                                                         tr["init"])):
                raise AssertionError(f"9b: the parameters drawn on {(d, m)} "
                                     f"differ from those drawn on (1, 1)")
            loss_rel, delta_rel = _steps_apart(r["mesh_run"], tr["mesh_run"],
                                               tr["init"])
            if loss_rel > MESH_F32_TOL_SHARDED["rtol"] or delta_rel > 1e-3:
                raise AssertionError(f"9b train on {(d, m)}: losses "
                                     f"{loss_rel:.3g} apart, changes "
                                     f"{delta_rel:.3g}")
            run = train.main(["--arch", TRAIN_ARCH, "--devices", str(d * m),
                              "--model-axis", str(m), "--steps",
                              str(MESH_TRAIN[0] + 2), "--batch",
                              str(MESH_TRAIN[1]), "--seq", str(MESH_TRAIN[2]),
                              "--log-every", "1", "--device", "cuda"])
            b9[f"{TRAIN_ARCH} train {(d, m)}"] = dict(
                loss_rel=loss_rel, delta_rel=delta_rel,
                ms_per_step=r["mesh_run"]["ms_per_step"],
                peak_gb=r["peak_gb"], cli_losses=run["losses"],
                cli_ms_per_step=run["step_s"] * 1e3,
                cli_tok_per_s=MESH_TRAIN[1] * MESH_TRAIN[2] / run["step_s"])
            log(f"[mesh] 9b {TRAIN_ARCH} fp32 train on {(d, m)}: "
                f"{r['mesh_run']['ms_per_step']:.1f} ms a step, vs 9a losses "
                f"{loss_rel:.3g} apart, changes {delta_rel:.3g}; launch.train "
                f"--devices {d * m} --model-axis {m}: "
                f"{run['step_s'] * 1e3:.1f} ms a step (bf16), losses "
                f"{run['losses']}")
        for d, m in [(1, kk), (kk, 1)]:
            specs = _family_specs(expert_parallel=(m == 1))
            r = mesh_lib.launch(
                _mesh_families, d * m, device_type="cuda", timeout=1200,
                args=(m, specs, MESH_PREFILL, MESH_FAMILY_DECODE,
                      MESH_FAMILY_F32, _family_trains(), False, pins))[0]
            b9[f"families {(d, m)}"] = _check_families(
                f"9b {(d, m)}", r, fam, (d, m))
            _family_launches(out, r, (d, m))
        out["9b"] = b9

    # 9c: four or more cards
    if cards < 4:
        log(f"[mesh] 9c needs 4 or more cards; this host has {cards}")
    else:
        r = mesh_lib.launch(_mesh_lm, 4, device_type="cuda", timeout=1500,
                            args=(GRANITE_ARCH, {}, 4, MESH_PREFILL,
                                  MESH_DECODE, ("kernel", "dot")))[0]
        rk, rd = r["prefill"]["kernel"], r["prefill"]["dot"]
        c9 = dict(mesh=r["mesh"], init_s=r["init_s"],
                  kernel_vs_dot=_hold(rk["logits"], rd["logits"],
                                      "9c granite prefill kernel vs dot",
                                      **LM_TOL),
                  prefill_s=rk["s"], prefill_tok_per_s=rk["tok_per_s"],
                  dot_s=rd["s"], launches_rank0=rk["launches"],
                  decode_ms=r["decode"]["ms_per_step"],
                  decode_tok_per_s=r["decode"]["tok_per_s"],
                  peak_gb_by_card=r["peak_gb_by_card"])
        if max(r["peak_gb_by_card"]) >= 80:
            raise AssertionError(f"9c: peak memory by card "
                                 f"{r['peak_gb_by_card']} GB")
        out["launches"][f"{GRANITE_ARCH} prefill {MESH_PREFILL} on (1, 4), "
                        f"rank 0"] = rk["launches"]
        log(f"[mesh] 9c {GRANITE_ARCH} on (1, 4): init {r['init_s']:.1f} s; "
            f"prefill {MESH_PREFILL} kernel {rk['s']:.3f} s "
            f"({rk['tok_per_s']:,.0f} tokens/s, {rk['launches']} launches "
            f"on rank 0) vs dot {rd['s']:.3f} s, max |dlogit| "
            f"{c9['kernel_vs_dot']:.3g}; decode {c9['decode_ms']:.1f} ms a "
            f"step ({c9['decode_tok_per_s']:.1f} tokens/s); peak GB by card "
            f"{[round(p, 2) for p in r['peak_gb_by_card']]}")
        out["9c"] = c9
        arch = MESH_FAMILIES[2][0]
        over = {"num_layers": MESH_GROK_LAYERS}
        for (d, m), rules in (((1, 4), "default"),
                              ((4, 1), "expert_parallel")):
            r = mesh_lib.launch(
                _mesh_families, 4, device_type="cuda", timeout=1500,
                args=(m, [(arch, over, rules)], MESH_PREFILL,
                      MESH_FAMILY_DECODE, None, []))[0][(arch, rules)]
            rb = r["bf16"]
            row = dict(mesh=r["mesh"], rules=rules, init_s=r["init_s"],
                       params_gb=r["params_gb"],
                       comm_bytes_rank0=rb["prefill"]["comm_bytes"],
                       comm_largest_rank0=rb["prefill"]["comm_largest"],
                       prefill_s=rb["prefill"]["s"],
                       prefill_tok_per_s=rb["prefill"]["tok_per_s"],
                       flash_launches_rank0=rb["prefill"]["flash"],
                       decode_ms=rb["decode"]["ms_per_step"],
                       peak_gb_by_card=r["peak_gb_by_card"])
            finite = all(bool(torch.isfinite(x).all()) for x in (
                rb["prefill"]["logits"], rb["decode"]["logits"]))
            if not finite or max(r["peak_gb_by_card"]) >= 80 \
                    or rb["prefill"]["flash"] != MESH_GROK_LAYERS:
                raise AssertionError(f"9c {arch} on {(d, m)} ({rules}): "
                                     f"finite {finite}, {row}")
            c9[f"{arch} {MESH_GROK_LAYERS} layers {(d, m)} {rules}"] = row
            out["launches"][f"{arch} ({MESH_GROK_LAYERS} layers) prefill "
                            f"{MESH_PREFILL} on {(d, m)} {rules}, rank 0"] \
                = rb["prefill"]["flash"]
            log(f"[mesh] 9c {arch} at {MESH_GROK_LAYERS} of 64 layers on "
                f"{(d, m)} ({rules}): init {r['init_s']:.1f} s; prefill "
                f"{MESH_PREFILL} {rb['prefill']['s']:.3f} s "
                f"({rb['prefill']['tok_per_s']:,.0f} tokens/s, "
                f"{rb['prefill']['flash']} flash launches on rank 0); decode "
                f"{rb['decode']['ms_per_step']:.1f} ms a step; parameters "
                f"{r['params_gb']:.2f} GB a card, peak GB by card over the "
                f"calls {[round(x, 2) for x in r['peak_gb_by_card']]}; "
                f"collective bytes on rank 0 a prefill {row['comm_bytes_rank0']}, "
                f"the largest buffers {row['comm_largest_rank0']}")
    report["mesh"] = out
    return out


def main() -> int:
    t_start = time.perf_counter()
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
    hgmma = check_flash_sass(_build, fa.HEAD_DIMS)
    report["flash_hgmma"] = hgmma
    log(f"[build] flash_attention bf16 kernel SASS: HGMMA instructions "
        f"{hgmma}")
    tf32 = check_alpha_sass(_build)
    report["alpha_combine_tf32_mma"] = tf32
    log(f"[build] alpha_combine kernel SASS: TF32 MMA instructions {tf32}")
    tf32 = check_ssm_sass(_build)
    report["ssm_scan_tf32_mma"] = tf32
    log(f"[build] ssm_scan kernel SASS: TF32 MMA instructions {tf32}")

    if "--only-mesh" in sys.argv[1:]:
        # phase 9 alone (a development run on a host with several cards)
        phase_mesh(counted, report)
        log("[report] " + json.dumps(report))
        log(smi)
        log(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    # 8c's dry run on meta, in a child process beside the card's phases
    dryrun = start_dryrun()

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
    # 4d. its async, drift and fault/resume paths, counted
    t0 = time.perf_counter()
    sim_async = phase_sim_async(counted, report)
    faulty = phase_sim_faulty(ac, counted, report)
    report["sim_4d_s"] = time.perf_counter() - t0
    log(f"[sim] phase 4d: {report['sim_4d_s']:.1f} s")
    # 4e. the sharded pool: runs, shard loss and resume, the pool's
    # phases at simulator scale, counted; the packed solver
    t0 = time.perf_counter()
    shard = phase_sim_shard(ac, counted, report)
    scale = phase_pool_scale(ac, counted, report)
    phase_packed_solver(state, report)
    report["sim_4e_s"] = time.perf_counter() - t0
    log(f"[sim] phase 4e: {report['sim_4e_s']:.1f} s")

    # 5. the serve path at full width, counted
    serve_launches, model, params = phase_serve(counted, report)
    # 5b. the rwkv serve path at full width and depth, counted
    rwkv_launches, rwkv_model, rwkv_params = phase_serve_rwkv(counted,
                                                              report)
    # their weights go before the big models load (--profile draws them
    # again from the same seed)
    del params, rwkv_params
    torch.cuda.empty_cache()
    # 5c, 5d. zamba2-7b and gemma-7b at full width and depth, counted,
    # each freed before the next loads
    t0 = time.perf_counter()
    zamba = phase_serve_zamba(counted, report)
    gemma = phase_serve_gemma(counted, report)
    report["serve_5c_5d_s"] = time.perf_counter() - t0
    log(f"[serve] phases 5c and 5d: {report['serve_5c_5d_s']:.1f} s")
    # 5e-5g. the MoE decoders (depth cut), the stub-frontend decoder and
    # the encoder-decoder at full width, counted, each freed
    t0 = time.perf_counter()
    moe = phase_serve_moe(counted, report)
    vlm = phase_serve_vlm(counted, report)
    phase_serve_encdec(counted, report)
    report["serve_5e_5g_s"] = time.perf_counter() - t0
    log(f"[serve] phases 5e-5g: {report['serve_5e_5g_s']:.1f} s")
    rows["ssm_scan"] += zamba["ssm_rows"]
    # 7. training at full width (launch.train, a restore), card against
    # CPU, the kernel route under training; ST-LF over LM clients, counted
    t0 = time.perf_counter()
    train_out = phase_train(counted, report)
    lm_clients = phase_lm_clients(ac, counted, report)
    report["train_7_s"] = time.perf_counter() - t0
    log(f"[train] phase 7: {report['train_7_s']:.1f} s")
    # 8. accounting: the kernel ops' counted work against their bounds,
    # three steps counted on the card and on meta, the dry run's records
    t0 = time.perf_counter()
    acct_ops = phase_acct_ops(fa, ss, ac, dg, report)
    phase_accounting(counted, report, smi, dryrun)
    report["accounting_8_s"] = time.perf_counter() - t0
    log(f"[accounting] phase 8: {report['accounting_8_s']:.1f} s")
    # 9. the mesh: every family's steps on DTensor (9a on one card, 9b
    # and 9c where the host has more)
    t0 = time.perf_counter()
    mesh = phase_mesh(counted, report)
    report["mesh_9_s"] = time.perf_counter() - t0
    log(f"[mesh] phase 9: {report['mesh_9_s']:.1f} s")
    # each kernel's count from the path that runs it
    launches = dict(launches,
                    flash_attention=serve_launches["flash_attention"],
                    ssm_scan=rwkv_launches["ssm_scan"])
    by_path = {
        "flash_attention": {
            f"{LM_ARCH} prefills {PREFILLS}":
                serve_launches["flash_attention"],
            f"{ZAMBA_ARCH} prefills {PREFILLS}":
                zamba["launches"]["flash_attention"],
            f"{GEMMA_ARCH} prefills {PREFILLS}":
                gemma["launches"]["flash_attention"],
            **{f"{arch} ({layers} layers) prefills {PREFILLS}":
               moe[arch]["launches"]["flash_attention"]
               for arch, layers in MOE_PATHS},
            f"{VLM_ARCH} prefills {PREFILLS} (256 frontend rows + text)":
                vlm["launches"]["flash_attention"],
            f"{TRAIN_ARCH} loss under no_grad {TRAIN_RUN[1:3]} (a check)":
                train_out["kernel_route"]["launches"]["flash_attention"],
            **{f"mesh: {path}": n for path, n in mesh["launches"].items()}},
        "ssm_scan": {
            f"{RWKV_ARCH} prefills {RWKV_PREFILLS}": rwkv_launches["ssm_scan"],
            f"{ZAMBA_ARCH} prefills {PREFILLS}":
                zamba["launches"]["ssm_scan"],
            **{f"mesh: {path}": n
               for path, n in mesh["ssm_launches"].items()}}}

    # 6. GPU against the CPU port on small inputs
    phase_small_reference()
    phase_small_sim(report)
    phase_small_lm()
    phase_small_rwkv()
    if "--profile" in sys.argv[1:]:
        dev = torch.device("cuda")
        phase_profile(state, stlf, (model, model.init(
            torch.Generator(device=dev).manual_seed(0), device=dev)),
            (rwkv_model, rwkv_model.init(
                torch.Generator(device=dev).manual_seed(0), device=dev)),
            sim_engines, report)

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
        kernels[-1]["accounting"] = acct_ops[name]   # 8a: counted work
        if name in by_path:         # every path and timed shape
            kernels[-1]["launches_by_path"] = by_path[name]
            kernels[-1]["shapes"] = [
                {k: r.get(k) for k in ("path", "shape", "dtype", "window",
                                       "variant", "ms", "plain_ms",
                                       "bound_ms", "bound_by", "library_ms",
                                       "max_abs_err",
                                       "unit_rms_max_abs_err", "device_us",
                                       "device_records")
                 if k in r} for r in rs if "ms" in r]
    # alpha_combine's other paths: the comparison matrix and the sim runs
    ac_row = next(k for k in kernels if k["name"] == "alpha_combine")
    ac_row["launches_by_path"] = dict(
        {"ST-LF round": launches["alpha_combine"],
         "run_all_baselines": report["baselines"]["launches"][
             "alpha_combine"]},
        **{f"sim {tag}": r["launches"]["alpha_combine"]
           for tag, r in sim.items()},
        **{f"sim {tag}": r["launches"]["alpha_combine"]
           for tag, r in sim_async.items()},
        **{f"sim faulty-n{SIM_FAULTY[0]}-r{SIM_FAULTY[1]}":
           faulty["launches"]["alpha_combine"],
           f"sim faulty-n{SIM_FAULTY[0]}-r{SIM_FAULTY[1]} resumed":
           faulty["resumed_launches"]["alpha_combine"]},
        **{f"sim-shard {SHARD_RUN[0]}-n{SHARD_RUN[1]}-r{SHARD_RUN[2]} "
           f"{name}": r["launches"]["alpha_combine"]
           for name, r in shard["runs"].items()},
        **{f"sim-shard faulty-n{SHARD_FAULTY[0]}-r{SHARD_FAULTY[1]}-mesh"
           f"{SHARD_FAULTY_CFG['mesh']}": shard["faulty"]["launches"][
               "alpha_combine"],
           f"sim-shard faulty-n{SHARD_FAULTY[0]}-r{SHARD_FAULTY[1]}-mesh"
           f"{SHARD_FAULTY_CFG['mesh']} resumed": shard["faulty"][
               "resumed_launches"]["alpha_combine"]},
        **{f"pool-scale n={POOL_SCALE[0]} {name} (2 calls)":
           r["launches"]["alpha_combine"]
           for name, r in scale["phases"].items()
           if name.endswith("transfer")},
        **{"stlf_lm_clients transfer":
           lm_clients["launches"]["alpha_combine"]})
    # the LM clients' transfer: S = T = 6 at their ~0.59 M parameters
    ac_row["lm_clients_transfer"] = lm_clients["kernel"]
    report["script_s"] = time.perf_counter() - t_start
    log(f"[done] {report['script_s']:.1f} s from start to the report")
    log("[report] " + json.dumps(report))
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
