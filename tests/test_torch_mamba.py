"""The port's Mamba2 block (``repro_torch.nn.mamba``) against the JAX
package's ``repro.nn.mamba`` on ``zamba2-7b`` ``reduced()`` widths
(d_model 128: 8 heads of 32, state 32, chunk 32), with JAX's weights
carried across by ``convert.lm_params_from_jax`` and numpy-seeded
inputs: the causal conv, the gated norm, the SSD inputs, the full block
(through the ``ssm_scan`` wrapper, whose plain version CPU tensors take,
and through ``impl="plain"``), the decode step, and the block carried on
by decode steps.  Also the case JAX's chunked form overflows: the block
at zamba2-7b's own chunk of 128 with JAX's init decay, held against
JAX's token-by-token decode.  The CUDA kernels are held against the
plain version on the card (``test_torch_kernels_cuda.py`` and
``chip_smoke.py``)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.nn import mamba as jmamba
from repro.nn import param as jparam
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.nn import mamba as tmamba
from repro_torch.nn import param as tparam

torch.set_num_threads(2)          # six test workers share the box

RNG = np.random.default_rng(0)
ARCH = "zamba2-7b"
F32 = dict(atol=1e-4, rtol=1e-4)          # same algorithm, other sum order
BF16 = dict(atol=0.15, rtol=0.05)         # test_decode_parity.py's bar
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _cfgs(**ssm):
    """(JAX config, port config) at d_model 128, the SSM fields given
    replacing ``reduced()``'s (state 32, head 32, chunk 32)."""
    return tuple(dataclasses.replace(
        c, ssm=dataclasses.replace(c.ssm, **ssm))
        for c in (get(ARCH).reduced(num_layers=2, d_model=128)
                  for get in (jget_config, tconfigs.get_config)))


def _to_port(tree):
    return convert.lm_params_from_jax(
        jax.tree_util.tree_map(np.asarray, tree), "cpu")


def _layer_params(jcfg, seed=0, drawn=True):
    """One mamba layer's parameters from JAX's init; with ``drawn`` the
    zero- and one-initialised leaves are drawn too, so that they are
    exercised (a_log and dt_bias within a range where the decay stays
    finite in JAX's chunked form at chunk <= 64)."""
    jp = jparam.materialize(jmamba.mamba_specs(jcfg),
                            jax.random.PRNGKey(seed))
    if drawn:
        for name, lo, hi in (("a_log", -1.0, 0.5), ("dt_bias", -2.0, 0.0),
                             ("conv_b", -0.5, 0.5), ("d_skip", 0.5, 1.5),
                             ("norm_scale", 0.5, 1.5)):
            jp[name] = jnp.asarray(RNG.uniform(lo, hi, jp[name].shape),
                                   jnp.float32)
    return jp, _to_port(jp)


def _x(shape, scale=1.0):
    return (RNG.normal(size=shape) * scale).astype(np.float32)


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


def test_mamba_specs_and_dims_match_jax():
    for jcfg, tcfg in (_cfgs(), (jget_config(ARCH),
                                 tconfigs.get_config(ARCH))):
        assert tmamba.dims(tcfg) == jmamba.dims(jcfg)
        t, j = tmamba.mamba_specs(tcfg), jmamba.mamba_specs(jcfg)
        assert sorted(t) == sorted(j)
        assert all(dataclasses.astuple(t[k]) == dataclasses.astuple(j[k])
                   for k in t)
        for ts, js in zip(tmamba.mamba_state_specs(3, tcfg),
                          jmamba.mamba_state_specs(3, jcfg)):
            assert dataclasses.astuple(ts) == dataclasses.astuple(js)
    # zamba2-7b: d_inner 7168 in 112 heads of 64, state 64
    assert tmamba.dims(tconfigs.get_config(ARCH)) == (7168, 112, 7296)
    assert tparam.count_params(tmamba.mamba_specs(
        tconfigs.get_config(ARCH))) == jparam.count_params(
        jmamba.mamba_specs(jget_config(ARCH)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("carried", [False, True])
def test_causal_conv_matches_jax(carried, dtype):
    jd, td = DTYPES[dtype]
    x, w, b = _x((2, 7, 20)), _x((4, 20), 0.5), _x((20,), 0.3)
    st = _x((2, 3, 20)) if carried else None
    out, ns = tmamba._causal_conv(
        torch.as_tensor(x).to(td), torch.as_tensor(w), torch.as_tensor(b),
        None if st is None else torch.as_tensor(st).to(td))
    ref, rns = jmamba._causal_conv(
        jnp.asarray(x, jd), jnp.asarray(w), jnp.asarray(b),
        None if st is None else jnp.asarray(st, jd))
    assert out.dtype == td and ns.shape == (2, 3, 20)
    tol = F32 if dtype == "float32" else dict(atol=2e-2, rtol=2e-2)
    np.testing.assert_allclose(_np(out), _np(ref), **tol)
    np.testing.assert_array_equal(_np(ns), _np(rns))   # inputs, exactly


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gated_norm_matches_jax(dtype):
    jd, td = DTYPES[dtype]
    y, z, scale = _x((2, 5, 64), 2.0), _x((2, 5, 64)), _x((64,))
    out = tmamba._gated_norm(torch.as_tensor(y).to(td),
                             torch.as_tensor(z).to(td),
                             torch.as_tensor(scale))
    ref = jmamba._gated_norm(jnp.asarray(y, jd), jnp.asarray(z, jd),
                             jnp.asarray(scale))
    assert out.dtype == td
    tol = F32 if dtype == "float32" else dict(atol=1e-2, rtol=2.0 ** -7)
    np.testing.assert_allclose(_np(out), _np(ref), **tol)


def test_ssd_inputs_match_jax():
    jcfg, tcfg = _cfgs()
    d_inner, nh, _ = tmamba.dims(tcfg)
    n = tcfg.ssm.state_dim
    xin, bm, cm = _x((2, 9, d_inner)), _x((2, 9, n)), _x((2, 9, n))
    dt, a_log, dt_bias = _x((2, 9, nh)), _x((nh,), 0.5), _x((nh,), 0.5)
    out = tmamba._ssd_inputs(tcfg, *(torch.as_tensor(a) for a in (
        xin, bm, cm, dt, a_log, dt_bias)))
    ref = jmamba._ssd_inputs(jcfg, *(jnp.asarray(a) for a in (
        xin, bm, cm, dt, a_log, dt_bias)))
    for o, r in zip(out, ref):
        assert tuple(o.shape) == r.shape
        np.testing.assert_allclose(_np(o), _np(r), **F32)
    q, k, _, log_w, _ = out
    # JAX's broadcasts stay views: C and B shared across heads, the decay
    # across the state dimension
    assert q.stride(2) == 0 and k.stride(2) == 0 and log_w.stride(3) == 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("chunk,length", [(32, 64), (64, 150)])
def test_mamba_block_matches_jax(chunk, length, dtype):
    """(32, 64): reduced()'s chunk; (64, 150): a ragged last chunk."""
    jcfg, tcfg = _cfgs(chunk=chunk)
    jp, tp = _layer_params(jcfg)
    jd, td = DTYPES[dtype]
    x = _x((2, length, 128))
    out, (conv, ssm) = tmamba.mamba_block(tp, torch.as_tensor(x).to(td),
                                          tcfg)
    ref, (rconv, rssm) = jmamba.mamba_block(jp, jnp.asarray(x, jd), jcfg)
    assert out.dtype == DTYPES[dtype][1] and ssm.dtype == torch.float32
    tol = F32 if dtype == "float32" else BF16
    np.testing.assert_allclose(_np(out), _np(ref), **tol)
    np.testing.assert_allclose(_np(conv), _np(rconv), **tol)
    np.testing.assert_allclose(_np(ssm), _np(rssm),
                               **(F32 if dtype == "float32"
                                  else dict(atol=2e-2, rtol=2e-2)))


def test_mamba_block_carries_jax_state():
    """A block started from JAX's state after an earlier segment."""
    jcfg, tcfg = _cfgs()
    jp, tp = _layer_params(jcfg, seed=1)
    _, state = jmamba.mamba_block(jp, jnp.asarray(_x((2, 40, 128))), jcfg,
                                  dtype=jnp.float32)
    x = _x((2, 50, 128))
    out, (conv, ssm) = tmamba.mamba_block(
        tp, torch.as_tensor(x), tcfg, state=_to_port(state),
        dtype=torch.float32)
    ref, (rconv, rssm) = jmamba.mamba_block(jp, jnp.asarray(x), jcfg,
                                            state=state, dtype=jnp.float32)
    for o, r in ((out, ref), (conv, rconv), (ssm, rssm)):
        np.testing.assert_allclose(_np(o), _np(r), **F32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_decode_matches_jax(dtype):
    """Ten decode steps from a nonzero state, each against JAX's."""
    jd, td = DTYPES[dtype]
    jcfg, tcfg = _cfgs()
    jp, tp = _layer_params(jcfg, seed=2)
    _, jstate = jmamba.mamba_block(jp, jnp.asarray(_x((2, 24, 128)), jd),
                                   jcfg)
    tstate = _to_port(jstate)
    tol = F32 if dtype == "float32" else BF16
    for _ in range(10):
        x = _x((2, 1, 128))
        out, tstate = tmamba.mamba_decode(tp, torch.as_tensor(x).to(td),
                                          tcfg, state=tstate)
        ref, jstate = jmamba.mamba_decode(jp, jnp.asarray(x, jd), jcfg,
                                          state=jstate)
        np.testing.assert_allclose(_np(out), _np(ref), **tol)
    for o, r in zip(tstate, jstate):
        np.testing.assert_allclose(_np(o), _np(r),
                                   **(F32 if dtype == "float32"
                                      else dict(atol=3e-2, rtol=3e-2)))


def test_block_then_decode_equals_one_long_block():
    """The serving invariant inside one layer: a block over the first 40
    tokens, then 8 decode steps from its state, equals one block over
    all 48 (fp32)."""
    _, tcfg = _cfgs()
    jcfg, _ = _cfgs()
    _, tp = _layer_params(jcfg, seed=3)
    x = torch.as_tensor(_x((2, 48, 128)))
    full, (fconv, fssm) = tmamba.mamba_block(tp, x, tcfg,
                                             dtype=torch.float32)
    zero = tmamba.init_mamba_state(2, tcfg, torch.float32)   # = None
    torch.testing.assert_close(tmamba.mamba_block(
        tp, x, tcfg, state=zero, dtype=torch.float32)[0], full,
        atol=0, rtol=0)
    part, state = tmamba.mamba_block(tp, x[:, :40], tcfg,
                                     dtype=torch.float32)
    steps = []
    for t in range(40, 48):
        y, state = tmamba.mamba_decode(tp, x[:, t:t + 1], tcfg, state=state,
                                       dtype=torch.float32)
        steps.append(y)
    torch.testing.assert_close(torch.cat([part] + steps, 1), full, **F32)
    torch.testing.assert_close(state[0], fconv, **F32)
    torch.testing.assert_close(state[1], fssm, **F32)


def test_mamba_block_plain_impl_is_differentiable():
    """``impl="plain"`` computes the same block as the kernel route's
    plain version and carries gradients to the parameters."""
    jcfg, tcfg = _cfgs()
    _, tp = _layer_params(jcfg, seed=4)
    x = torch.as_tensor(_x((2, 40, 128)))
    ref, _ = tmamba.mamba_block(tp, x, tcfg, dtype=torch.float32)
    tp = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    out, _ = tmamba.mamba_block(tp, x, tcfg, dtype=torch.float32,
                                impl="plain")
    torch.testing.assert_close(out.detach(), ref, atol=0, rtol=0)
    out.square().sum().backward()
    assert all(v.grad is not None and bool(torch.isfinite(v.grad).all())
               for v in tp.values())
    assert float(tp["a_log"].grad.abs().sum()) > 0
    with pytest.raises(ValueError, match="impl"):
        tmamba.mamba_block(tp, x, tcfg, impl="pallas")


def test_chunk128_at_jax_init_decay_jax_overflows_port_matches_recurrence():
    """zamba2-7b's own chunk of 128 and state/head widths of 64, with
    JAX's init (a_log = dt_bias = 0: softplus(dt) ~ ln 2 a step): a
    chunk decays past float32's range, and JAX's chunked block gives
    non-finite outputs (recorded here: the oracle's fault, not the
    port's).  The port's block is finite and equals JAX's token-by-token
    decode (``gla_decode``) over the same 512 tokens."""
    jcfg, tcfg = (dataclasses.replace(c, ssm=dataclasses.replace(
        c.ssm, state_dim=64, head_dim=64, chunk=128)) for c in (
        get(ARCH).reduced(num_layers=2, d_model=256)
        for get in (jget_config, tconfigs.get_config)))
    jp, tp = _layer_params(jcfg, drawn=False)
    x = np.random.default_rng(0).normal(size=(1, 512, 256)).astype(
        np.float32)
    ref, _ = jmamba.mamba_block(jp, jnp.asarray(x), jcfg, dtype=jnp.float32)
    bad = int((~np.isfinite(np.asarray(ref))).sum())
    print(f"JAX's mamba_block at chunk 128: {bad} of {ref.size} outputs "
          f"non-finite")                               # shown with -s
    assert bad > 0
    out, (conv, ssm) = tmamba.mamba_block(tp, torch.as_tensor(x), tcfg,
                                          dtype=torch.float32)
    assert bool(torch.isfinite(out).all()) and bool(torch.isfinite(ssm).all())
    step = jax.jit(lambda s, xt: jmamba.mamba_decode(
        jp, xt, jcfg, state=s, dtype=jnp.float32))
    state = jmamba.init_mamba_state(1, jcfg, jnp.float32)
    ys = []
    for t in range(512):
        yt, state = step(state, jnp.asarray(x[:, t:t + 1]))
        ys.append(np.asarray(yt))
    np.testing.assert_allclose(out.numpy(), np.concatenate(ys, 1), **F32)
    np.testing.assert_allclose(ssm.numpy(), np.asarray(state[1]),
                               atol=1e-3, rtol=1e-4)
    np.testing.assert_allclose(conv.numpy(), np.asarray(state[0]), **F32)
