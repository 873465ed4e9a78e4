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
