"""The port's flash-attention wrapper on the CPU (its plain version)
against the JAX package's Pallas kernel, run in interpret mode as
``tests/test_kernels.py`` runs it, over that file's shape grid and both
dtypes, at its tolerances.  The CUDA kernel itself is held against the
plain version on the card (``test_torch_kernels_cuda.py`` and
``chip_smoke.py``)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import ops as jfa
from repro.kernels.flash_attention.kernel import flash_attention_bhsd
from repro.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.flash_attention import ops as fa

torch.set_num_threads(2)          # six test workers share the box

RNG = np.random.default_rng(0)

# tests/test_kernels.py's grid: (b, sq, sk, h, d, causal, window)
GRID = [
    (2, 64, 64, 2, 32, True, None),
    (1, 100, 100, 3, 64, True, None),       # padding path
    (2, 64, 64, 2, 32, True, 24),           # sliding window
    (1, 32, 160, 2, 16, True, None),        # history offset (sk > sq)
    (1, 96, 96, 1, 128, False, None),       # bidirectional
]
TOL = {"float32": dict(atol=3e-5, rtol=1e-4), "bfloat16": dict(atol=4e-2)}


def _qkv(b, sq, sk, h, d, kv=None):
    kv = h if kv is None else kv
    return (RNG.normal(size=(b, sq, h, d)).astype(np.float32),
            RNG.normal(size=(b, sk, kv, d)).astype(np.float32),
            RNG.normal(size=(b, sk, kv, d)).astype(np.float32))


def _both(q, k, v, dtype, **kw):
    """(port, JAX) outputs as float32 numpy; JAX gets K/V repeated to
    q's heads, as ``repro.nn.attention.attend`` passes them."""
    rep = q.shape[2] // k.shape[2]
    t = [torch.as_tensor(a).to(getattr(torch, dtype)) for a in (q, k, v)]
    out = fa.flash_attention(*t, **kw)
    assert out.dtype == t[0].dtype and out.shape == t[0].shape
    j = [jnp.asarray(a, dtype) for a in (q, np.repeat(k, rep, axis=2),
                                         np.repeat(v, rep, axis=2))]
    ref = jfa.flash_attention(*j, **kw)
    return out.float().numpy(), np.asarray(ref, np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,sq,sk,h,d,causal,window", GRID)
def test_flash_plain_matches_pallas(b, sq, sk, h, d, causal, window, dtype):
    out, ref = _both(*_qkv(b, sq, sk, h, d), dtype, causal=causal,
                     window=window)
    np.testing.assert_allclose(out, ref, **TOL[dtype])


@pytest.mark.parametrize("window", [None, 24])
@pytest.mark.parametrize("sq,sk", [(64, 64), (5, 77)])
def test_flash_gqa_takes_unrepeated_kv(sq, sk, window):
    """The port's kernel reads KV head h // (H / KV); JAX repeats first.
    (5, 77): fewer queries than one tile, behind a longer history."""
    out, ref = _both(*_qkv(1, sq, sk, 4, 32, kv=2), "float32",
                     window=window)
    np.testing.assert_allclose(out, ref, **TOL["float32"])


# the head dims of zamba2-7b's shared attention (112) and gemma-7b (256):
# causal, windowed, a history offset and bidirectional, GQA, ragged S
HEAD_DIM_GRID = [
    (1, 80, 80, 4, 2, 112, True, None),
    (2, 70, 70, 2, 2, 112, True, 24),
    (1, 40, 96, 2, 1, 256, True, None),
    (1, 64, 64, 2, 2, 256, False, None),
    (1, 90, 90, 4, 4, 256, True, 33),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,sq,sk,h,kv,d,causal,window", HEAD_DIM_GRID)
def test_flash_plain_head_dims_match_pallas_and_ref(b, sq, sk, h, kv, d,
                                                    causal, window, dtype):
    """The Pallas kernel takes any D (its BlockSpecs take it from the
    input); the port's wrapper takes D = 112 and 256 too.  Its plain
    version against the Pallas kernel in interpret mode and against the
    jnp oracle ``attention_ref``, at test_kernels.py's tolerances."""
    q, k, v = _qkv(b, sq, sk, h, d, kv=kv)
    out, ref = _both(q, k, v, dtype, causal=causal, window=window)
    np.testing.assert_allclose(out, ref, **TOL[dtype])
    rep = h // kv
    oracle = attention_ref(*[jnp.asarray(a, dtype) for a in (
        q, np.repeat(k, rep, axis=2), np.repeat(v, rep, axis=2))],
        causal=causal, window=window)
    np.testing.assert_allclose(out, np.asarray(oracle, np.float32),
                               **TOL[dtype])


def test_flash_fully_masked_rows_stay_finite():
    """Sq > Sk, causal: the first Sq - Sk queries sit before every key.
    Both kernels give 0 there (p zeroed, l floored at 1e-20)."""
    out, ref = _both(*_qkv(1, 48, 32, 2, 16), "float32")
    assert np.isfinite(out).all()
    np.testing.assert_array_equal(out[:, :16], 0.0)
    np.testing.assert_allclose(out, ref, **TOL["float32"])


@pytest.mark.parametrize("sq,sk,causal,window", [(32, 64, True, None),
                                                  (32, 64, True, 24),
                                                  (48, 32, False, 40)])
def test_flash_offset_matches_pallas_kernel(sq, sk, causal, window):
    """The port fixes the Pallas kernel's arguments to what its wrapper
    passes without padding: offset Sk - Sq and valid_k Sk, also for a
    window and for more queries than keys."""
    q, k, v = _qkv(2, sq, sk, 1, 16)
    ref = flash_attention_bhsd(
        *[jnp.asarray(a[:, :, 0]) for a in (q, k, v)], causal=causal,
        window=window, offset=sk - sq, valid_k=sk, block_q=16, block_k=16,
        interpret=True)
    out = fa.flash_attention(*[torch.as_tensor(a) for a in (q, k, v)],
                             causal=causal, window=window)
    np.testing.assert_allclose(out[:, :, 0].numpy(), np.asarray(ref),
                               **TOL["float32"])


def test_flash_wrapper_rejects_bad_inputs():
    q, k, v = (torch.as_tensor(a) for a in _qkv(1, 8, 8, 3, 16, kv=2))
    with pytest.raises(ValueError, match="KV"):
        fa.flash_attention(q, k, v)
    q, k, v = (torch.as_tensor(a) for a in _qkv(1, 8, 8, 2, 16))
    with pytest.raises(ValueError, match="window"):
        fa.flash_attention(q, k, v, window=0)
    with pytest.raises(ValueError, match="shape|must be"):
        fa.flash_attention(q, k[:, :, :, :8], v)


# The bf16 kernel's arithmetic (csrc/flash_attention.cu): fp32 scores
# from bf16 q and k (exact products), the scale on the fp32 score, p in
# fp32, l summed from the unrounded p, and PV on the tensor cores with p
# in bf16: split into hi = bf16(p) and lo = bf16(p - hi), two products
# against the same bf16 v, one rounding of the output to bf16.
FLASH_BF16_TOL = dict(atol=1e-5, rtol=2.0 ** -7)      # one bf16 ulp
NUMERICS_GRID = [(256, 2, 1, 16, None), (256, 2, 1, 64, None),
                 (256, 2, 1, 128, None), (384, 4, 2, 64, 100),
                 (256, 2, 1, 112, None), (256, 2, 1, 256, 100)]


def _kernel_emulation(q, k, v, window, split):
    """(B, Sq, H, D) bf16 out of bf16 q and GQA k, v, as the tensor-core
    kernel computes it (``split``) or with one bf16 rounding of p."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    rep = h // k.shape[2]
    kf = k.float().repeat_interleave(rep, dim=2)
    vf = v.float().repeat_interleave(rep, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf) * (1.0 / d ** 0.5)
    qi = torch.arange(sq)[:, None] + (sk - sq)
    kj = torch.arange(sk)[None, :]
    live = kj <= qi
    if window is not None:
        live &= kj > qi - window
    s = s.masked_fill(~live, float("-inf"))
    p = torch.exp(s - s.amax(-1, keepdim=True))
    l = p.sum(-1, keepdim=True)
    hi = p.bfloat16().float()
    if split:
        lo = (p - hi).bfloat16().float()
        acc = (torch.einsum("bhqk,bkhd->bhqd", hi, vf)
               + torch.einsum("bhqk,bkhd->bhqd", lo, vf))
    else:
        acc = torch.einsum("bhqk,bkhd->bhqd", hi, vf)
    return (acc / l).transpose(1, 2).bfloat16()


def _beyond(out, ref, tol):
    ref = ref.float()
    return int(((out.float() - ref).abs()
                > tol["atol"] + tol["rtol"] * ref.abs()).sum())


def _bf16_qkv(sq, h, kv, d):
    q, k, v = _qkv(1, sq, sq, h, d, kv=kv)
    return [torch.as_tensor(a).bfloat16() for a in (q, k, v)]


@pytest.mark.parametrize("sq,h,kv,d,window", NUMERICS_GRID)
def test_flash_split_p_meets_the_bf16_bar(sq, h, kv, d, window):
    """P split into bf16 hi and lo keeps the kernel within one bf16 ulp
    of the plain version everywhere: the bar the card tests hold it to."""
    q, k, v = _bf16_qkv(sq, h, kv, d)
    plain = fa.flash_attention_plain(q, k, v, window=window)
    out = _kernel_emulation(q, k, v, window, split=True)
    assert _beyond(out, plain, FLASH_BF16_TOL) == 0
    torch.testing.assert_close(out.float(), plain.float(), **FLASH_BF16_TOL)


@pytest.mark.parametrize("sq,h,kv,d,window", NUMERICS_GRID)
def test_flash_single_bf16_p_breaks_the_bf16_bar(sq, h, kv, d, window):
    """One bf16 rounding of P (what a plain bf16 PV product does) moves
    elements beyond the same bar: the bar sees P's rounding, so the
    split is what keeps the kernel inside it."""
    q, k, v = _bf16_qkv(sq, h, kv, d)
    plain = fa.flash_attention_plain(q, k, v, window=window)
    out = _kernel_emulation(q, k, v, window, split=False)
    assert _beyond(out, plain, FLASH_BF16_TOL) > 0


def test_flash_staging_check():
    """The bf16 kernel's TMA staging needs 16-byte aligned pointers and
    B, S, H strides that are multiples of 8 elements; anything else
    raises (the wrapper calls this for every bf16 CUDA input)."""
    t = torch.zeros(2, 16, 4, 32, dtype=torch.bfloat16)
    fa.check_staging("q", t)
    fa.check_staging("q", t[:, 3:, 1:3])               # aligned view
    with pytest.raises(ValueError, match="multiples of 8"):
        fa.check_staging("k", torch.zeros(2, 16, 4, 36,
                                          dtype=torch.bfloat16)[..., :32])
    with pytest.raises(ValueError, match="aligned"):
        fa.check_staging("v", torch.zeros(2 * 16 * 4 * 32 + 1,
                                          dtype=torch.bfloat16)[1:]
                         .view(2, 16, 4, 32))
