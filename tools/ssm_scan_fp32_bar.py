#!/usr/bin/env python3
"""Where the fp32 ``ssm_scan`` bar is tight: the kernels and the plain
version, each against sums closer to exact, on one NVIDIA GPU.

    python3 tools/ssm_scan_fp32_bar.py [--seeds 8]

The card test ``test_ssm_scan_kernel_on_card`` holds the kernels'
fp32 y to the plain version within atol 1e-5 / rtol 1e-4 at (1, 4096)
x 32 heads of 64, rwkv, chunk 128, decays -|N(0, 1)|.  For each seed
this draws such a case as that test does (normal q, k, v, bonus and
initial state) and prints, for the kernels and for the plain version
with its products summed in fp32 (``nn.linear_attn._sum64`` swapped for
an fp32 einsum: the plain version before it summed in float64), the
largest error against (a) the plain version, whose products are summed
in float64 from the same fp32 factors, and (b) the token-by-token
recurrence in float64 from the same fp32 inputs, each also as a share of
the bar (|err| / (atol + rtol |ref|); the test fails above 1).  The last
line is one JSON object with every number.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

B, L, H, D, CHUNK, VARIANT = 1, 4096, 32, 64, 128, "rwkv"
ATOL, RTOL = 1e-5, 1e-4


def _case(seed, dev):
    rng = np.random.default_rng(seed)

    def t(size, f=lambda x: x):
        return torch.as_tensor(f(rng.normal(size=size)),
                               dtype=torch.float32, device=dev)
    q, k, v = (t((B, L, H, D)) for _ in range(3))
    lw = t((B, L, H, D), lambda x: -np.abs(x))
    return q, k, v, lw, t((H, D)), t((B, H, D, D))


def _recurrence_f64(q, k, v, lw, bonus, s0):
    """rwkv's y_t = q_t (S_{t-1} + diag(u k_t) v_t), S_t = diag(w_t)
    S_{t-1} + k_t v_t^T, token by token in float64."""
    q, k, v, w = (x.double() for x in (q, k, v, lw.exp()))
    u, s = bonus.double(), s0.double()
    ys = []
    for t in range(q.shape[1]):
        qt, kt, vt = q[:, t], k[:, t], v[:, t]
        ys.append(torch.einsum("bhd,bhdv->bhv", qt, s)
                  + (qt * u * kt).sum(-1, keepdim=True) * vt)
        s = s * w[:, t, :, :, None] + kt[..., None] * vt[:, :, None]
    return torch.stack(ys, 1)


def _gap(y, ref):
    d = (y.double() - ref.double()).abs()
    share = d / (ATOL + RTOL * ref.double().abs())
    return dict(max_abs=float(d.max()), bar_share=float(share.max()),
                over_bar=int((share > 1).sum()))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, default=8)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("ssm_scan_fp32_bar: needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
    from repro_torch.device import resolve_device
    from repro_torch.kernels.ssm_scan import ops as ss
    from repro_torch.nn import linear_attn
    dev = resolve_device("cuda")
    rows = []
    for seed in range(args.seeds):
        q, k, v, lw, bonus, s0 = _case(seed, dev)
        kw = dict(chunk=CHUNK, variant=VARIANT, bonus=bonus,
                  initial_state=s0)
        yk, _ = ss.gla_chunked(q, k, v, lw, **kw)
        yp, _ = ss.gla_chunked_plain(q, k, v, lw, **kw)
        sum64 = linear_attn._sum64
        linear_attn._sum64 = torch.einsum            # fp32 sums
        try:
            y32, _ = ss.gla_chunked_plain(q, k, v, lw, **kw)
        finally:
            linear_attn._sum64 = sum64
        y64 = _recurrence_f64(q, k, v, lw, bonus, s0)
        row = dict(seed=seed,
                   kernel_vs_plain=_gap(yk, yp),
                   fp32_sums_vs_plain=_gap(y32, yp),
                   kernel_vs_fp32_sums=_gap(yk, y32),
                   kernel_vs_f64=_gap(yk, y64),
                   fp32_sums_vs_f64=_gap(y32, y64))
        rows.append(row)
        print(f"[ssm-bar] seed {seed}: " + "; ".join(
            f"{name} {g['max_abs']:.3g} ({g['bar_share']:.3f} of the bar, "
            f"{g['over_bar']} over)" for name, g in row.items()
            if name != "seed"), flush=True)
        del q, k, v, lw, yk, yp, y32, y64
        torch.cuda.empty_cache()
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "shape": [B, L, H, D, CHUNK, VARIANT],
                      "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
