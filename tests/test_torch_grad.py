"""Gradients in the port: no kernel wrapper cuts autograd, and the
differentiable path matches JAX's.

``_build.refuse_grad`` is what every kernel wrapper calls on its CUDA
branch: with grad enabled, a floating-point input that requires grad
raises (no kernel has a backward pass), instead of an output without a
``grad_fn``.  On CPU tensors the wrappers run their plain versions, which
autograd differentiates.  ``nn.rwkv.time_mix(impl="plain")`` runs the
plain ``gla_chunked`` on any device; its gradients are held against
``jax.grad`` of JAX's ``time_mix`` (the jnp ``gla_chunked``) at a reduced
width and chunk 32 (at chunk 128 JAX's chunked form overflows at rwkv6's
decay).  The CUDA side is ``tests/test_torch_kernels_cuda.py``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.nn import param as jparam
from repro.nn import rwkv as jrwkv
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.kernels import _build
from repro_torch.kernels.alpha_combine import ops as ac
from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.kernels.ssm_scan import ops as ss
from repro_torch.nn import rwkv as trwkv

torch.set_num_threads(2)          # six test workers share the box

RNG = np.random.default_rng(0)


def test_refuse_grad_raises_only_for_a_float_input_needing_grad():
    x = torch.ones(3, requires_grad=True)
    with pytest.raises(RuntimeError, match="k: an input requires grad.*"
                                           "plain_k"):
        _build.refuse_grad("k", "plain_k", None, torch.ones(2), x)
    with torch.no_grad():
        _build.refuse_grad("k", "plain_k", x)
    _build.refuse_grad("k", "plain_k", torch.ones(3), None,
                       torch.arange(3), x.detach())


@pytest.mark.parametrize("name", ["alpha_combine", "flash_attention",
                                  "gla_chunked"])
def test_wrappers_stay_differentiable_on_the_cpu(name):
    # CPU tensors take the plain version: the guard never sees them
    r = lambda *s: torch.as_tensor(RNG.normal(size=s),  # noqa: E731
                                   dtype=torch.float32)
    x = r(2, 32, 2, 16).requires_grad_()
    if name == "alpha_combine":
        out = ac.alpha_combine(r(2, 64).requires_grad_(), x.reshape(2, -1))
    elif name == "flash_attention":
        out = fa.flash_attention(x, r(2, 32, 2, 16), r(2, 32, 2, 16))
    else:
        out = ss.gla_chunked(x, r(2, 32, 2, 16), r(2, 32, 2, 16),
                             -r(2, 32, 2, 16).abs(), chunk=16)[0]
    out.square().sum().backward()
    assert x.grad is not None and bool(torch.isfinite(x.grad).all())
    assert float(x.grad.abs().sum()) > 0


def _cfgs():
    """(JAX config, port config): rwkv6 at 2 layers, d_model 128 (4 heads
    of 32), chunk 32, in float32."""
    return tuple(dataclasses.replace(
        get("rwkv6-1.6b").reduced(num_layers=2, d_model=128),
        dtype="float32") for get in (jget_config, tconfigs.get_config))


@pytest.mark.parametrize("impl", ["plain", "kernel"])
def test_time_mix_gradients_match_jax(impl):
    jcfg, tcfg = _cfgs()
    jp = jparam.materialize(jrwkv.time_mix_specs(jcfg),
                            jax.random.PRNGKey(4))
    for name in ("w0", "bonus"):          # zero at init: draw them
        jp[name] = jnp.asarray(RNG.normal(size=jp[name].shape) * 0.5,
                               jnp.float32)
    h, hd = jcfg.num_heads, jcfg.resolved_head_dim()
    x = RNG.normal(size=(2, 40, 128)).astype(np.float32)   # 2 chunks
    prev = RNG.normal(size=(2, 128)).astype(np.float32)
    st = RNG.normal(size=(2, h, hd, hd)).astype(np.float32)
    w_out = RNG.normal(size=(2, 40, 128)).astype(np.float32)
    w_st = RNG.normal(size=(2, h, hd, hd)).astype(np.float32)

    def jloss(p, x):
        out, (_, s) = jrwkv.time_mix(p, x, jcfg, prev_x=jnp.asarray(prev),
                                     state=jnp.asarray(st),
                                     dtype=jnp.float32)
        return jnp.sum(out * w_out) + jnp.sum(s * w_st)

    jg_p, jg_x = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))

    tp = {k_: v_.requires_grad_() for k_, v_ in convert.lm_params_from_jax(
        jax.tree_util.tree_map(np.asarray, jp), "cpu").items()}
    tx = torch.as_tensor(x).requires_grad_()
    out, (_, s) = trwkv.time_mix(tp, tx, tcfg, prev_x=torch.as_tensor(prev),
                                 state=torch.as_tensor(st),
                                 dtype=torch.float32, impl=impl)
    loss = (out * torch.as_tensor(w_out)).sum() \
        + (s * torch.as_tensor(w_st)).sum()
    loss.backward()
    # the same function in fp32, summed in other orders on both sides
    for name, g in [("x", tx.grad)] + [(k_, v_.grad) for k_, v_ in
                                       tp.items()]:
        ref = np.asarray(jg_x if name == "x" else jg_p[name])
        assert g is not None, name
        scale = float(np.abs(ref).max())
        np.testing.assert_allclose(g.numpy(), ref, rtol=1e-3,
                                   atol=1e-4 * scale, err_msg=name)


def test_time_mix_rejects_an_unknown_impl():
    _, tcfg = _cfgs()
    with pytest.raises(ValueError, match="impl"):
        trwkv.time_mix({}, torch.zeros(1, 4, 128), tcfg,
                       prev_x=torch.zeros(1, 128), state=None, impl="xla")
