"""The port's ``ssm_scan`` wrapper on the CPU (its plain version,
``repro_torch.nn.linear_attn.gla_chunked``) against the JAX package: its
Pallas kernel in interpret mode, as ``tests/test_kernels.py`` runs it,
and the jnp ``nn.linear_attn.gla_chunked`` / ``gla_decode``, on the same
numpy-seeded inputs.  Also the case JAX's chunked form overflows
(rwkv6-1.6b's chunk of 128 at its init decay), held against JAX's
token-by-token recurrence.  The CUDA kernel itself is held against the
plain version on the card (``test_torch_kernels_cuda.py`` and
``chip_smoke.py``)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssm_scan import ops as jops
from repro.nn import linear_attn as jla
from repro_torch.kernels.ssm_scan import ops as ss
from repro_torch.nn import linear_attn as tla

torch.set_num_threads(2)          # six test workers share the box

RNG = np.random.default_rng(0)
# tests/test_kernels.py's bar between JAX's kernel and its oracle: the
# same function in fp32, summed in another order
F32 = dict(atol=1e-4, rtol=0)
# JAX's fp32 recurrence against the chunked form at chunk 128: the decays
# are rounded differently (exp of a cumsum against a product of exps);
# measured up to 1.1e-4 at output RMS ~12
RECUR = dict(atol=1e-3, rtol=1e-4)

# tests/test_kernels.py:82's grid, plus a chunk the kernel's sub-chunks
# split (64) and one they do not (8)
GRID = [
    (2, 64, 2, 16, 16, 16, "mamba"),
    (1, 96, 3, 32, 32, 32, "rwkv"),
    (2, 50, 2, 16, 24, 16, "mamba"),        # ragged tail
    (1, 128, 1, 64, 64, 32, "rwkv"),
    (1, 150, 2, 32, 16, 64, "rwkv"),        # ragged, 4 sub-chunks
    (2, 20, 1, 8, 8, 8, "mamba"),
]


def _inputs(b, l, h, dk, dv, variant, scale=0.3):
    q, k = (RNG.normal(size=(b, l, h, dk)).astype(np.float32)
            for _ in range(2))
    v = RNG.normal(size=(b, l, h, dv)).astype(np.float32)
    lw = (-np.abs(RNG.normal(size=(b, l, h, dk)) * scale)).astype(np.float32)
    bonus = (RNG.normal(size=(h, dk)).astype(np.float32)
             if variant == "rwkv" else None)
    s0 = RNG.normal(size=(b, h, dk, dv)).astype(np.float32)
    return q, k, v, lw, bonus, s0


def _port(q, k, v, lw, bonus, s0, **kw):
    t = lambda a: None if a is None else torch.as_tensor(a)  # noqa: E731
    y, s = ss.gla_chunked(t(q), t(k), t(v), t(lw), bonus=t(bonus),
                          initial_state=t(s0), **kw)
    return y.float().numpy(), s.numpy()


def _jax(fn, q, k, v, lw, bonus, s0, **kw):
    j = lambda a: None if a is None else jnp.asarray(a)  # noqa: E731
    y, s = fn(j(q), j(k), j(v), j(lw), bonus=j(bonus), initial_state=j(s0),
              **kw)
    return np.asarray(y, np.float32), np.asarray(s)


@pytest.mark.parametrize("b,l,h,dk,dv,chunk,variant", GRID)
def test_gla_plain_matches_jax_kernel_and_oracle(b, l, h, dk, dv, chunk,
                                                 variant):
    x = _inputs(b, l, h, dk, dv, variant)
    y, s = _port(*x, chunk=chunk, variant=variant)
    assert y.shape == (b, l, h, dv) and s.shape == (b, h, dk, dv)
    for fn in (jops.gla_chunked, jla.gla_chunked):
        ry, rs = _jax(fn, *x, chunk=chunk, variant=variant)
        np.testing.assert_allclose(y, ry, **F32)
        np.testing.assert_allclose(s, rs, **F32)


@pytest.mark.parametrize("variant", ["mamba", "rwkv"])
def test_gla_decode_matches_jax(variant):
    b, h, dk, dv = 2, 3, 16, 24
    bonus = RNG.normal(size=(h, dk)).astype(np.float32)
    js = jnp.zeros((b, h, dk, dv), jnp.float32)
    ts = torch.zeros(b, h, dk, dv)
    for _ in range(6):
        q, k, lw = (RNG.normal(size=(b, h, dk)).astype(np.float32)
                    for _ in range(3))
        v = RNG.normal(size=(b, h, dv)).astype(np.float32)
        lw = -np.abs(lw)
        ty, ts = tla.gla_decode(*(torch.as_tensor(a) for a in (q, k, v, lw)),
                                ts, variant=variant,
                                bonus=torch.as_tensor(bonus))
        jy, js = jla.gla_decode(*(jnp.asarray(a) for a in (q, k, v, lw)),
                                js, variant=variant, bonus=jnp.asarray(bonus))
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-5,
                                   rtol=1e-5)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("variant", ["mamba", "rwkv"])
def test_gla_bf16_inputs_fp32_decay(variant):
    """The model's dtypes: r/k/v in bfloat16, log_w in float32.  y comes
    back in bfloat16; both packages compute in fp32 from the same bf16
    values and round once, so they differ by at most one bf16 ulp (or
    the fp32 bar near 0)."""
    q, k, v, lw, bonus, s0 = _inputs(2, 80, 2, 32, 32, variant)
    tb = [torch.as_tensor(a).to(torch.bfloat16) for a in (q, k, v)]
    y, s = ss.gla_chunked(*tb, torch.as_tensor(lw), chunk=32,
                          variant=variant, bonus=None if bonus is None
                          else torch.as_tensor(bonus),
                          initial_state=torch.as_tensor(s0))
    assert y.dtype == torch.bfloat16 and s.dtype == torch.float32
    jb = [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)]
    ry, rs = jla.gla_chunked(*jb, jnp.asarray(lw), chunk=32, variant=variant,
                             bonus=None if bonus is None
                             else jnp.asarray(bonus),
                             initial_state=jnp.asarray(s0))
    assert ry.dtype == jnp.bfloat16
    np.testing.assert_allclose(y.float().numpy(), np.asarray(ry, np.float32),
                               atol=1e-4, rtol=2.0 ** -7)
    np.testing.assert_allclose(s.numpy(), np.asarray(rs), **F32)


@pytest.mark.parametrize("variant", ["rwkv", "mamba"])
def test_gla_chunk128_at_rwkv6_init_decay_matches_recurrence(variant):
    """rwkv6-1.6b's chunk of 128 with its init decay, log_w =
    -softplus(N(0, 4e-4)) ~ -ln 2 a step: a chunk decays by ~2^-128, past
    float32's range, so JAX's factoring q*exp(lc) . k*exp(-lc) gives
    non-finite outputs.  The port's must be finite and equal JAX's
    token-by-token recurrence."""
    b, l, h, d = 1, 256, 4, 64
    q, k, v = (RNG.normal(size=(b, l, h, d)).astype(np.float32)
               for _ in range(3))
    lw = (-np.logaddexp(0.0, RNG.normal(size=(b, l, h, d)) * 4e-4)) \
        .astype(np.float32)
    # some columns of a chunk decay past 1 / float32's largest value, so
    # exp(-lc) overflows there
    assert float((-lw[:, :128].sum(1)).max()) > \
        np.log(np.finfo(np.float32).max)
    bonus = RNG.normal(size=(h, d)).astype(np.float32)
    y, s = _port(q, k, v, lw, bonus, None, chunk=128, variant=variant)
    assert np.isfinite(y).all() and np.isfinite(s).all()
    js = jnp.zeros((b, h, d, d), jnp.float32)
    ys = []
    for t in range(l):
        yt, js = jla.gla_decode(*(jnp.asarray(a[:, t]) for a in (q, k, v, lw)),
                                js, variant=variant, bonus=jnp.asarray(bonus))
        ys.append(np.asarray(yt))
    np.testing.assert_allclose(y, np.stack(ys, 1), **RECUR)
    np.testing.assert_allclose(s, np.asarray(js), **RECUR)


def test_gla_wrapper_validates():
    q = torch.zeros(1, 8, 2, 4)
    with pytest.raises(ValueError, match="variant"):
        ss.gla_chunked(q, q, q, q, chunk=4, variant="gru")
    with pytest.raises(ValueError, match="must be"):
        ss.gla_chunked(q, q[:, :4], q, q, chunk=4)
    with pytest.raises(ValueError, match="bonus"):
        ss.gla_chunked(q, q, q, q, chunk=4, variant="rwkv",
                       bonus=torch.zeros(3, 4))
    with pytest.raises(ValueError, match="initial_state"):
        ss.gla_chunked(q, q, q, q, chunk=4, initial_state=torch.zeros(2))
    y, s = ss.gla_chunked(q[:, :0], q[:, :0], q[:, :0], q[:, :0], chunk=4)
    assert y.shape == (1, 0, 2, 4) and torch.equal(s, torch.zeros(1, 2, 4, 4))
