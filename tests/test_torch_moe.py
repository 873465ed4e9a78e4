"""The port's ``nn/moe.py`` against the JAX package's ``repro.nn.moe`` on
the same seeded inputs: the router, the top-k gates, the load-balance
loss, the grouped capacity-bounded dispatch (which choices are dropped)
and the expert MLPs, their gradients, and bf16 with the routing pinned.
The weights are JAX's, carried across by ``convert.lm_params_from_jax``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.nn import moe as jmoe
from repro.nn import param as jparam
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.nn import moe as tmoe

torch.set_num_threads(2)          # six test workers share the box

# fp32: the same function summed in another order
F32 = dict(atol=1e-5, rtol=1e-5)
GRAD_RTOL = 1e-4                  # max|g_port - g_jax| <= this * max|g_jax|
# + this: top-1's renormalised gate is g / g, whose gradient cancels to
# fp32 rounding of the gate's upstream gradient (observed 1.1e-7 on the
# router leaf, whose true gradient is the aux loss's alone, ~5e-4)
GRAD_ATOL = 1e-6
# bf16 with the routing pinned: both round the dispatch, each expert
# product and the gate products to bf16; a product's sum order differs
BF16 = dict(atol=2e-2, rtol=2e-2)

# (config, activation): grok-1's top-2 GeGLU and llama4-scout's top-1
# SwiGLU at reduced() (4 experts), and the 2-matrix GELU experts
CASES = [("grok-1-314b", None), ("llama4-scout-17b-a16e", None),
         ("grok-1-314b", "gelu")]


def _setup(name, act, cf=None, d=64, f=96, seed=0):
    """(JAX MoEConfig, port MoEConfig, activation, JAX params, port
    params) of ``name``'s reduced MoE layer."""
    jcfg, tcfg = jget_config(name).reduced(), \
        tconfigs.get_config(name).reduced()
    jm, tm = jcfg.moe, tcfg.moe
    if cf is not None:
        jm = dataclasses.replace(jm, capacity_factor=cf)
        tm = dataclasses.replace(tm, capacity_factor=cf)
    act = act or jcfg.mlp_activation
    jp = jparam.materialize(jmoe.moe_specs(d, f, jm, act),
                            jax.random.PRNGKey(seed))
    tp = convert.lm_params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                                    "cpu")
    return jm, tm, act, jp, tp


def _x(shape, seed=1):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _jax_routing(jp, x, moe):
    """JAX's own routing of ``moe_mlp`` (its router, softmax and
    ``lax.top_k``), and which choices its dispatch keeps."""
    b, s, _ = x.shape
    e, k = moe.num_experts, moe.top_k
    logits = jnp.einsum("bsd,de->bse", jnp.asarray(x, jnp.float32),
                        jp["router"].astype(jnp.float32))
    ids = jax.lax.top_k(jax.nn.softmax(logits, -1), k)[1]
    flat = jnp.reshape(ids, (b, s * k))
    onehot = jax.nn.one_hot(flat, e, dtype=jnp.int32)
    pos = jnp.sum((jnp.cumsum(onehot, axis=1) - 1) * onehot, axis=-1)
    cap = tmoe.capacity(s, moe)
    return np.array(ids), np.array(pos < cap)


@pytest.mark.parametrize("cf", [1.25, 0.5])
@pytest.mark.parametrize("name,act", CASES)
def test_moe_mlp_matches_jax_fp32(name, act, cf):
    """Output and aux loss in fp32 compute; at cf 0.5 the dispatch drops
    choices, and the port drops exactly JAX's."""
    jm, tm, act, jp, tp = _setup(name, act, cf)
    x = _x((3, 40, 64))
    ref, raux = jmoe.moe_mlp(jp, jnp.asarray(x), jm, act,
                             dtype=jnp.float32)
    out, aux = tmoe.moe_mlp(tp, torch.as_tensor(x), tm, act,
                            torch.float32)
    assert out.dtype == torch.float32 and aux.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **F32)
    np.testing.assert_allclose(float(aux), float(raux), **F32)
    jids, jkeep = _jax_routing(jp, x, jm)
    ids = tmoe.route(tp, torch.as_tensor(x), tm)[1]
    np.testing.assert_array_equal(ids.numpy(), jids)
    _, keep = tmoe.dispatch_slots(ids, tmoe.capacity(40, tm),
                                  tm.num_experts)
    np.testing.assert_array_equal(keep.numpy(), jkeep)
    if cf < 1:
        assert not jkeep.all()           # the case drops choices
    # a dropped choice contributes 0: the pinned output of a token whose
    # every choice is dropped is 0
    gone = ~keep.reshape(3, 40, -1).any(-1)
    assert torch.all(out[gone] == 0)


def test_capacity_and_slots_token_major():
    """Slots run token-major over (S, k); past ``cap`` they go to the
    trash row E * cap."""
    moe = tconfigs.MoEConfig(num_experts=2, top_k=2, capacity_factor=0.5)
    cap = tmoe.capacity(3, moe)                  # ceil(3 * 2 / 2 * 0.5)
    assert cap == 2
    ids = torch.tensor([[[0, 1], [1, 0], [0, 1]]])
    slot, keep = tmoe.dispatch_slots(ids, cap, 2)
    assert slot.tolist() == [[0, 2, 3, 1, 4, 4]]
    assert keep.tolist() == [[True, True, True, True, False, False]]


@pytest.mark.parametrize("name,act", CASES[:2])
def test_moe_mlp_gradients_match_jax(name, act):
    """d(sum(y * w) + aux) of x and of every leaf against ``jax.grad``,
    with choices dropped (cf 0.5)."""
    jm, tm, act, jp, tp = _setup(name, act, cf=0.5)
    x = _x((2, 24, 64))
    w = _x((2, 24, 64), seed=2)

    def jf(p, x_):
        y, aux = jmoe.moe_mlp(p, x_, jm, act, dtype=jnp.float32)
        return jnp.sum(y * jnp.asarray(w)) + aux

    jgp, jgx = jax.grad(jf, argnums=(0, 1))(jp, jnp.asarray(x))
    tx = torch.as_tensor(x).requires_grad_()
    req = {k: v.clone().requires_grad_() for k, v in tp.items()}
    y, aux = tmoe.moe_mlp(req, tx, tm, act, torch.float32)
    (torch.sum(y * torch.as_tensor(w)) + aux).backward()
    pairs = [(tx.grad, jgx)] + [(req[k].grad, jgp[k]) for k in sorted(req)]
    for a, b in pairs:
        b = np.asarray(b)
        assert np.abs(a.numpy() - b).max() <= \
            GRAD_RTOL * np.abs(b).max() + GRAD_ATOL
    assert float(np.abs(np.asarray(jgp["router"])).max()) > 0


@pytest.mark.parametrize("name,act", CASES[:2])
def test_moe_mlp_bf16_with_the_routing_pinned(name, act):
    """bf16 compute: the port's own routing against JAX's (its flip
    count reported), and the output with JAX's expert ids pinned held
    against JAX's.  The router sees the same bf16 input in both, so the
    two routings differ only where fp32 sums tie."""
    jm, tm, act, jp, tp = _setup(name, act)
    x = np.asarray(jnp.asarray(_x((3, 40, 64)), jnp.bfloat16), np.float32)
    jx = jnp.asarray(x, jnp.bfloat16)
    ref, raux = jmoe.moe_mlp(jp, jx, jm, act, dtype=jnp.bfloat16)
    tx = torch.as_tensor(x).to(torch.bfloat16)
    jids, _ = _jax_routing(jp, x, jm)
    own = tmoe.route(tp, tx, tm)[1].numpy()
    flips = int((np.sort(own, -1) != np.sort(jids, -1)).any(-1).sum())
    print(f"{name}: {flips} of {own.shape[0] * own.shape[1]} tokens "
          f"routed differently from JAX in bf16")
    out, aux = tmoe.moe_mlp(tp, tx, tm, act, torch.bfloat16,
                            expert_ids=torch.as_tensor(jids))
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref, np.float32), **BF16)
    np.testing.assert_allclose(float(aux), float(raux), **F32)


def test_pinned_routing_equals_own_routing():
    """``expert_ids`` equal to the router's own choice changes nothing;
    other ids change the output and the gates follow the router's
    probabilities at them."""
    _, tm, act, _, tp = _setup("grok-1-314b", None)
    x = torch.as_tensor(_x((2, 16, 64)))
    y, aux, ids = tmoe.moe_mlp_routed(tp, x, tm, act, torch.float32)
    y2, aux2 = tmoe.moe_mlp(tp, x, tm, act, torch.float32, expert_ids=ids)
    assert torch.equal(y, y2) and torch.equal(aux, aux2)
    other = (ids + 1) % tm.num_experts
    y3, _ = tmoe.moe_mlp(tp, x, tm, act, torch.float32, expert_ids=other)
    assert not torch.allclose(y, y3)


def test_moe_specs_match_jax():
    for act in ("geglu", "swiglu", "gelu"):
        t = tmoe.moe_specs(32, 48, tconfigs.get_config("grok-1-314b").moe,
                           act)
        j = jmoe.moe_specs(32, 48, jget_config("grok-1-314b").moe, act)
        assert sorted(t) == sorted(j)
        for k in t:
            assert dataclasses.astuple(t[k]) == dataclasses.astuple(j[k])
