"""The numerics the ``ssm_scan`` kernels' design rests on, on the CPU.

The kernels (``kernels/ssm_scan/csrc/ssm_scan.cu``) split a chunked-GLA
call into a state pass (each chunk's state contribution, then a scan of
the chunks' starting states) and an output pass, and run the products on
the tensor cores in TF32.  ``emulate`` repeats that arithmetic in torch:
TF32 rounding on the fp32 bits (round to nearest, ties away, as
``test_torch_combine_numerics.tf32``), the 3xTF32 split (x = hi + lo) and
the exact three-part split (x = x1 + x2 + x3), each k-step's products in
a fresh accumulator whose adds round toward zero (as the H100's tensor
cores do) added in fp32, the factored diagonal block with its arguments'
rounding folded back in, and the per-pair branch past its decay span.

It is held to the bars ``chip_smoke.py`` holds the kernels to, against
the plain version and against the plain version with its sums in
float64 (``ops.gla_chunked_float64_sums``): y and the state within
1e-5 / 1e-4.  One TF32 product does not hold them; the
guard takes the per-pair branch at log_w = -8; the state pass's starting
states follow the plain version's own chunk-by-chunk update.
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch.kernels.ssm_scan import ops as ss
from repro_torch.nn.linear_attn import gla_chunked as plain

plain64 = ss.gla_chunked_float64_sums

torch.set_num_threads(2)          # six test workers share the box

RNG = np.random.default_rng(0)
BAR = dict(atol=1e-5, rtol=1e-4)  # y (fp32) and the state: chip_smoke.py
SPAN_MAX = 60.0                   # the factored diagonal's largest span
SUB = 16


def tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 -> the nearest TF32 value (10 mantissa bits), ties away from
    zero, as an fp32 tensor."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def rz(x64: torch.Tensor) -> torch.Tensor:
    """float64 -> float32 rounded toward zero."""
    f = x64.float()
    over = f.double().abs() > x64.abs()
    return torch.where(over, torch.nextafter(f, torch.zeros_like(f)), f)


def split2(x):
    hi = tf32(x)
    return hi, tf32(x - hi)


def split3(x):
    x1 = tf32(x)
    r = x - x1
    x2 = tf32(r)
    return x1, x2, r - x2


def products(a, b, mode, b_exact):
    """The (A, B) part pairs one k-step multiplies, in the kernels'
    order: "3x" (3xTF32), "exact" (three parts), "tf32" (one product)."""
    b_exact = b_exact and mode != "tf32"
    if mode == "tf32":
        return [(tf32(a), tf32(b))]
    if mode == "3x":
        ah, al = split2(a)
        if b_exact:
            return [(al, b), (ah, b)]
        bh, bl = split2(b)
        return [(al, bh), (ah, bl), (ah, bh)]
    a1, a2, a3 = split3(a)
    if b_exact:
        return [(a3, b), (a2, b), (a1, b)]
    b1, b2, b3 = split3(b)
    return [(a3, b1), (a1, b3), (a2, b2), (a2, b1), (a1, b2), (a1, b1)]


def mm(a, b, mode, b_exact=False, acc=None):
    """acc + a @ b as the kernels take it: per k-step of 8, the products
    chained into a fresh accumulator (each MMA's sum exact, rounded toward
    zero), then added to acc in fp32."""
    out = torch.zeros(a.shape[:-1] + b.shape[-1:]) if acc is None else acc
    for k0 in range(0, a.shape[-1], 8):
        t = torch.zeros_like(out)
        for x, y in products(a[..., k0:k0 + 8], b[..., k0:k0 + 8, :], mode,
                             b_exact):
            t = rz(t.double() + x.double() @ y.double())
        out = out + t
    return out


def exp_diff(x, y):
    """exp(x - y) with the subtraction's rounding error folded back in."""
    s = x - y
    bb = s - x
    err = (x - (s - bb)) + (-y - bb)
    e = torch.exp(s)
    return e + e * err


def _chunk(x, n, c):
    part = x[:, n * c:(n + 1) * c].float().transpose(1, 2)
    return F.pad(part, (0, 0, 0, c - part.shape[2]))


def emulate(q, k, v, lw, *, chunk, variant, bonus, s0, mode=None):
    """y (B, L, H, Dv) in v's dtype, the final state, the chunks' starting
    states and, per chunk and sub-chunk, whether the diagonal block took
    the per-pair branch.  ``mode`` takes every product as one TF32
    product ("tf32") or in 3xTF32 ("3x") instead of the kernels' mix."""
    b, l, h, dk = q.shape
    dv = v.shape[-1]
    rwkv = variant == "rwkv"
    vx = v.dtype == torch.bfloat16                    # v exact in TF32
    m3, mx = mode or "3x", mode or "exact"
    ns = chunk // SUB
    ti = torch.arange(SUB)
    live = (ti[:, None] > ti[None, :]) if rwkv \
        else (ti[:, None] >= ti[None, :])
    chunks, ds, dec = [], [], []
    for n in range(-(-l // chunk)):            # the state pass, part 1
        qc, kc, vc, wc = (_chunk(x, n, chunk) for x in (q, k, v, lw))
        lc = torch.cumsum(wc, dim=2)
        lt = lc[:, :, -1:]
        ds.append(mm((kc * torch.exp(lt - lc)).transpose(2, 3), vc, m3, vx))
        dec.append(torch.exp(lt).transpose(2, 3))
        chunks.append((qc, kc, vc, lc))
    s, starts = s0.float(), []
    for d_, e_ in zip(ds, dec):                # part 2, the scan
        starts.append(s)
        s = s * e_ + d_
    ys, pairs_taken = [], []
    for (qc, kc, vc, lc), sn in zip(chunks, starts):   # the output pass
        qlc = F.pad(lc, (0, 0, 1, 0))[:, :, :-1] if rwkv else lc
        y = mm(qc * torch.exp(qlc), sn, m3)
        r = qlc[:, :, ::SUB]
        e = lc[:, :, SUB - 1::SUB]
        qhat = qc * torch.exp(qlc - r.repeat_interleave(SUB, 2))
        khat = kc * torch.exp(e.repeat_interleave(SUB, 2) - lc)
        for i in range(ns):
            si = slice(i * SUB, (i + 1) * SUB)
            ri = r[:, :, i:i + 1]
            pairs = ~((r[:, :, i] - e[:, :, i]).amax(-1) < SPAN_MAX)
            pairs_taken.append(pairs)
            fact = mm(qc[:, :, si] * exp_diff(qlc[:, :, si], ri),
                      (kc[:, :, si] * exp_diff(ri, lc[:, :, si]))
                      .transpose(2, 3), mx)
            w = torch.exp(qlc[:, :, si, None] - lc[:, :, None, si])
            pp = ((qc[:, :, si, None].double() * kc[:, :, None, si].double())
                  * w.double()).sum(-1).float()
            att = torch.where(pairs[..., None, None], pp, fact)
            att = att.masked_fill(~live, 0.0)
            if rwkv:
                att = att + torch.diag_embed(
                    (qc[:, :, si].double() * bonus[None, :, None].double()
                     * kc[:, :, si].double()).sum(-1).float())
            yi = mm(att, vc[:, :, si], mx, vx, acc=y[:, :, si])
            for j in range(i):
                sj = slice(j * SUB, (j + 1) * SUB)
                g = torch.exp(r[:, :, i] - e[:, :, j])[:, :, None]
                att = mm(qhat[:, :, si] * g, khat[:, :, sj].transpose(2, 3),
                         mx)
                yi = mm(att, vc[:, :, sj], mx, vx, acc=yi)
            y[:, :, si] = yi
        ys.append(y)
    y = torch.cat(ys, 2)[:, :, :l].transpose(1, 2).to(v.dtype)
    return y, s, starts, torch.stack(pairs_taken)


def _inputs(regime, dtype=torch.float32, shape=(1, 256, 2, 64)):
    b, l, h, d = shape
    t = lambda *s: torch.as_tensor(RNG.normal(size=s),  # noqa: E731
                                   dtype=torch.float32)
    q, k, v = (t(b, l, h, d).to(dtype) for _ in range(3))
    z = t(b, l, h, d)
    lw = {"init": lambda: -F.softplus(z * 4e-4),   # rwkv6 at init: ~ln 2
          "abs": lambda: -z.abs(),
          "strong": lambda: -8.0 + 0.5 * z}[regime]()
    return q, k, v, lw, t(h, d), t(b, h, d, d)


def _beyond(a, ref, tol):
    d = (a.float() - ref.float()).abs()
    return int((d > tol["atol"] + tol["rtol"] * ref.float().abs()).sum())


def test_split3_is_exact_in_tf32():
    x = torch.as_tensor(RNG.normal(size=4096) * 10.0 ** RNG.integers(
        -20, 20, 4096), dtype=torch.float32)
    x1, x2, x3 = split3(x)
    for part in (x1, x2, x3):
        assert torch.equal(tf32(part), part)
    assert torch.equal((x1.double() + x2.double()) + x3.double(),
                       x.double())


@pytest.mark.parametrize("regime", ["init", "abs", "strong"])
@pytest.mark.parametrize("variant", ["rwkv", "mamba"])
def test_kernel_arithmetic_meets_the_chip_bars(variant, regime):
    q, k, v, lw, bonus, s0 = _inputs(regime)
    y, s, _, pairs = emulate(q, k, v, lw, chunk=128, variant=variant,
                             bonus=bonus, s0=s0)
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(s).all())
    for ref in (plain, plain64):
        py, ps = ref(q, k, v, lw, chunk=128, variant=variant, bonus=bonus,
                     initial_state=s0)
        torch.testing.assert_close(y, py, **BAR)
        torch.testing.assert_close(s, ps, **BAR)
    # the guard: rwkv6's init spans ~11 and -|N(0,1)| ~13-25 a block, both
    # factored; -8 a step spans ~128, every block pair by pair
    assert bool(pairs.all()) if regime == "strong" \
        else not bool(pairs.any())


@pytest.mark.parametrize("variant", ["rwkv", "mamba"])
def test_bf16_inputs_meet_the_one_ulp_bar(variant):
    # v exact in TF32: att . v takes three products, the state update two
    q, k, v, lw, bonus, s0 = _inputs("init", torch.bfloat16)
    y, _, _, _ = emulate(q, k, v, lw, chunk=128, variant=variant,
                         bonus=bonus, s0=s0)
    assert y.dtype == torch.bfloat16
    for ref in (plain, plain64):
        py, _ = ref(q, k, v, lw, chunk=128, variant=variant, bonus=bonus,
                    initial_state=s0)
        torch.testing.assert_close(y.float(), py.float(), atol=1e-5,
                                   rtol=2.0 ** -7)


@pytest.mark.parametrize("variant", ["rwkv", "mamba"])
def test_one_tf32_product_misses_the_bar(variant):
    q, k, v, lw, bonus, s0 = _inputs("init")
    y, _, _, _ = emulate(q, k, v, lw, chunk=128, variant=variant,
                         bonus=bonus, s0=s0, mode="tf32")
    for ref in (plain, plain64):
        py, _ = ref(q, k, v, lw, chunk=128, variant=variant, bonus=bonus,
                    initial_state=s0)
        assert _beyond(y, py, BAR) > 0, "one TF32 product would hold the bar"


@pytest.mark.parametrize("regime", ["init", "strong"])
@pytest.mark.parametrize("variant", ["rwkv", "mamba"])
def test_state_pass_follows_the_chunk_recurrence(variant, regime):
    # S_n, the state each chunk starts from, against the plain version's
    # own update applied chunk by chunk in fp32
    q, k, v, lw, bonus, s0 = _inputs(regime)
    _, s, starts, _ = emulate(q, k, v, lw, chunk=128, variant=variant,
                              bonus=bonus, s0=s0)
    ref = s0
    for n, sn in enumerate(starts):
        torch.testing.assert_close(sn, ref, **BAR)
        kc, vc, wc = (_chunk(x, n, 128) for x in (k, v, lw))
        lc = torch.cumsum(wc, dim=2)
        lt = lc[:, :, -1:]
        ref = ref * torch.exp(lt).transpose(2, 3) \
            + (kc * torch.exp(lt - lc)).transpose(2, 3) @ vc
    torch.testing.assert_close(s, ref, **BAR)


def test_plain_float64_sums_only_move_the_sums():
    # the reference the kernels are held to: the same fp32 factors, its
    # products summed in float64; the fp32 plain version is within the
    # bar of it at this size
    q, k, v, lw, bonus, s0 = _inputs("abs")
    for variant in ("rwkv", "mamba"):
        a = plain(q, k, v, lw, chunk=128, variant=variant, bonus=bonus,
                  initial_state=s0)
        b = plain64(q, k, v, lw, chunk=128, variant=variant, bonus=bonus,
                    initial_state=s0)
        for x, y in zip(a, b):
            assert x.dtype == y.dtype
            torch.testing.assert_close(x, y, **BAR)


def test_check_staging_refuses_misaligned_rows():
    t = torch.zeros(1, 64, 2, 64, dtype=torch.bfloat16)
    ss.check_staging("q", t)                     # contiguous: aligned
    wide = torch.zeros(1, 64, 2, 68, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="multiples of 8"):
        ss.check_staging("q", wide[..., :64])    # rows of 136 bytes
    f32 = torch.zeros(1, 64, 2, 66)
    with pytest.raises(ValueError, match="multiples of 4"):
        ss.check_staging("log_w", f32[..., :64])


if __name__ == "__main__":
    # python tests/test_torch_ssm_numerics.py B L H: the kernels' arithmetic
    # and 3xTF32 everywhere against the plain version with float64 sums,
    # at a size of one's choice (the chip bars' worst element and the
    # count beyond), fp32 inputs, both variants, rwkv6's init decay
    import sys
    b, l, h = map(int, sys.argv[1:4])
    torch.set_num_threads(8)
    for variant in ("rwkv", "mamba"):
        q, k, v, lw, bonus, s0 = _inputs("init", shape=(b, l, h, 64))
        ref, _ = plain64(q, k, v, lw, chunk=128, variant=variant,
                         bonus=bonus, initial_state=s0)
        for mode in (None, "3x"):
            y, _, _, _ = emulate(q, k, v, lw, chunk=128, variant=variant,
                                 bonus=bonus, s0=s0, mode=mode)
            d = (y - ref).abs() / (BAR["atol"] + BAR["rtol"] * ref.abs())
            print(f"{(b, l, h, 64)} {variant} init fp32, "
                  f"{mode or 'the kernels mix of splits'}: worst element "
                  f"{float(d.max()):.3f} of the bar, {int((d > 1).sum())} "
                  f"beyond", flush=True)
