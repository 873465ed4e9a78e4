"""The rwkv6 LM's serving path in the port against the JAX package on
``rwkv6-1.6b`` ``reduced()`` (2 layers, d_model 128, 4 heads of 32, chunk
32), with JAX's weights (and JAX's recurrent state) carried across by
``convert.lm_params_from_jax``: the time-mix (full sequence through the
``ssm_scan`` wrapper, and one decode step), the channel-mix,
``RWKVModel.prefill`` / ``decode_step``, ``serve.generate`` and the CLI.
JAX's model runs the jnp ``gla_chunked``; the port's wrapper runs its
plain version on CPU tensors."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.launch import serve as jserve
from repro.models.api import build_model as jbuild_model
from repro.nn import param as jparam
from repro.nn import rwkv as jrwkv
from repro.nn.layers import ShardCtx
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.launch import serve as tserve
from repro_torch.models.api import build_model
from repro_torch.models.rwkv_model import RWKVModel
from repro_torch.nn import param as tparam
from repro_torch.nn import rwkv as trwkv

torch.set_num_threads(2)          # six test workers share the box

RNG = np.random.default_rng(0)
ARCH = "rwkv6-1.6b"
F32 = dict(atol=1e-4, rtol=1e-4)          # same algorithm, other sum order
BF16 = dict(atol=0.15, rtol=0.05)         # test_decode_parity.py's bar


def _cfgs(**over):
    """(JAX config, port config) of the 2-layer, d_model 128 variant."""
    return tuple(dataclasses.replace(
        get(ARCH).reduced(num_layers=2, d_model=128), **over)
        for get in (jget_config, tconfigs.get_config))


def _to_port(tree):
    return convert.lm_params_from_jax(
        jax.tree_util.tree_map(np.asarray, tree), "cpu")


def _model_pair(seed=0, **over):
    jcfg, tcfg = _cfgs(**over)
    jm = jbuild_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(seed))
    return jm, jp, build_model(tcfg), _to_port(jp)


def _tokens(cfg, shape, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape)


def _layer_params(specs, seed):
    """One layer's parameters from JAX's init, with the zero-init ``w0``
    and ``bonus`` drawn too, so that they are exercised."""
    jp = jparam.materialize(specs, jax.random.PRNGKey(seed))
    for name in ("w0", "bonus"):
        if name in jp:
            jp[name] = jnp.asarray(RNG.normal(size=jp[name].shape) * 0.5,
                                   jnp.float32)
    return jp, _to_port(jp)


def test_rwkv_param_specs_and_count_match_jax():
    for jcfg, tcfg in (_cfgs(), (jget_config(ARCH),
                                 tconfigs.get_config(ARCH))):
        t = build_model(tcfg).param_specs()
        j = jbuild_model(jcfg).param_specs()
        tl = jax.tree_util.tree_leaves(t, is_leaf=tparam.is_spec)
        jl = jax.tree_util.tree_leaves(j, is_leaf=jparam.is_spec)
        assert [dataclasses.astuple(a) for a in tl] == \
            [dataclasses.astuple(b) for b in jl]
        assert tparam.count_params(t) == jparam.count_params(j)
    assert tparam.count_params(build_model(
        tconfigs.get_config(ARCH)).param_specs()) == 1_583_943_680


@pytest.mark.parametrize("s", [40, 64])
def test_time_mix_matches_jax(s):
    """A ragged (40) and a whole (64) number of chunks of 32, from a
    nonzero carried state and previous token."""
    jcfg, tcfg = _cfgs(dtype="float32")
    jp, tp = _layer_params(jrwkv.time_mix_specs(jcfg), 1)
    h, hd = jcfg.num_heads, jcfg.resolved_head_dim()
    x = RNG.normal(size=(2, s, 128)).astype(np.float32)
    prev = RNG.normal(size=(2, 128)).astype(np.float32)
    st = RNG.normal(size=(2, h, hd, hd)).astype(np.float32)
    out, (last, state) = trwkv.time_mix(
        tp, torch.as_tensor(x), tcfg, prev_x=torch.as_tensor(prev),
        state=torch.as_tensor(st), dtype=torch.float32)
    ref, (jlast, jstate) = jrwkv.time_mix(
        jp, jnp.asarray(x), jcfg, prev_x=jnp.asarray(prev),
        state=jnp.asarray(st), dtype=jnp.float32)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **F32)
    np.testing.assert_allclose(state.numpy(), np.asarray(jstate), **F32)
    np.testing.assert_array_equal(last.numpy(), np.asarray(jlast))


def test_time_mix_decode_matches_jax():
    jcfg, tcfg = _cfgs(dtype="float32")
    jp, tp = _layer_params(jrwkv.time_mix_specs(jcfg), 2)
    h, hd = jcfg.num_heads, jcfg.resolved_head_dim()
    x = RNG.normal(size=(2, 1, 128)).astype(np.float32)
    prev = RNG.normal(size=(2, 128)).astype(np.float32)
    st = RNG.normal(size=(2, h, hd, hd)).astype(np.float32)
    out, (last, state) = trwkv.time_mix_decode(
        tp, torch.as_tensor(x), tcfg, prev_x=torch.as_tensor(prev),
        state=torch.as_tensor(st), dtype=torch.float32)
    ref, (jlast, jstate) = jrwkv.time_mix_decode(
        jp, jnp.asarray(x), jcfg, prev_x=jnp.asarray(prev),
        state=jnp.asarray(st), dtype=jnp.float32)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **F32)
    np.testing.assert_allclose(state.numpy(), np.asarray(jstate), **F32)
    np.testing.assert_array_equal(last.numpy(), np.asarray(jlast))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_channel_mix_matches_jax(dtype):
    jcfg, _ = _cfgs()
    jp, tp = _layer_params(jrwkv.channel_mix_specs(jcfg), 3)
    x = RNG.normal(size=(2, 7, 128)).astype(np.float32)
    prev = RNG.normal(size=(2, 128)).astype(np.float32)
    out, last = trwkv.channel_mix(
        tp, torch.as_tensor(x).to(getattr(torch, dtype)),
        prev_x=torch.as_tensor(prev).to(getattr(torch, dtype)),
        dtype=getattr(torch, dtype))
    ref, jlast = jrwkv.channel_mix(
        jp, jnp.asarray(x, dtype), prev_x=jnp.asarray(prev, dtype),
        dtype=jnp.dtype(dtype))
    assert out.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(
        out.float().numpy(), np.asarray(ref, np.float32),
        **(F32 if dtype == "float32" else dict(atol=2e-2, rtol=2e-2)))
    np.testing.assert_array_equal(last.float().numpy(),
                                  np.asarray(jlast, np.float32))


@pytest.mark.parametrize("dtype,s", [("float32", 75), ("float32", 64),
                                     ("bfloat16", 75)])
def test_prefill_matches_jax(dtype, s):
    jm, jp, tm, tp = _model_pair(dtype=dtype)
    toks = _tokens(jm.cfg, (2, s))
    ref = np.asarray(jm.prefill(jp, {"tokens": jnp.asarray(toks,
                                                           jnp.int32)}),
                     np.float32)
    out = tm.prefill(tp, {"tokens": torch.as_tensor(toks)})
    assert out.shape == ref.shape == (2, 1, jm.cfg.vocab_size)
    assert out.dtype == torch.float32
    if dtype == "float32":
        np.testing.assert_allclose(out.numpy(), ref, **F32)
    else:
        np.testing.assert_allclose(out.numpy(), ref, **BF16)
        assert np.array_equal(out.numpy().argmax(-1), ref.argmax(-1))


def test_decode_steps_from_carried_jax_state():
    """JAX steps 5 tokens, its state is carried across, then both step 8
    more: logits and the state tuple agree at every step."""
    jm, jp, tm, tp = _model_pair(dtype="float32")
    toks = _tokens(jm.cfg, (2, 13))
    step = jax.jit(lambda p, c, b: jm.decode_step(p, c, b))
    jc = jm.init_cache(2, 16)
    pos = lambda t: jnp.full((2,), t, jnp.int32)  # noqa: E731
    for t in range(5):
        _, jc = step(jp, jc, {"token": jnp.asarray(toks[:, t:t + 1],
                                                   jnp.int32), "pos": pos(t)})
    tc = _to_port(jc)
    assert isinstance(tc, tuple) \
        and [a.dtype for a in tc] == [torch.float32] * 3
    for t in range(5, 13):
        tok = toks[:, t:t + 1]
        ref, jc = step(jp, jc, {"token": jnp.asarray(tok, jnp.int32),
                                "pos": pos(t)})
        out, tc = tm.decode_step(tp, tc, {"token": torch.as_tensor(tok),
                                          "pos": torch.full((2,), t)})
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), **F32)
    for a, b in zip(convert.lm_params_to_numpy(tc), jc):
        np.testing.assert_allclose(a, np.asarray(b), **F32)


def test_decode_matches_prefill_in_port():
    """JAX's serving invariant (tests/test_decode_parity.py) in the port,
    bf16, across a chunk boundary (40 tokens, chunk 32)."""
    _, _, tm, tp = _model_pair()
    toks = torch.as_tensor(_tokens(tm.cfg, (2, 40)))
    full = tm.prefill(tp, {"tokens": toks})
    cache = tm.init_cache(2, 40, device="cpu")
    for t in range(40):
        logits, cache = tm.decode_step(tp, cache, {
            "token": toks[:, t:t + 1], "pos": torch.full((2,), t)})
    np.testing.assert_allclose(logits[:, 0].numpy(), full[:, 0].numpy(),
                               **BF16)
    assert torch.equal(logits[:, 0].argmax(-1), full[:, 0].argmax(-1))


def test_generate_greedy_matches_jax():
    jm, jp, tm, tp = _model_pair(dtype="float32")
    prompts = _tokens(jm.cfg, (2, 8))
    ref = jserve.generate(jm, jp, jnp.asarray(prompts, jnp.int32), 6, 14,
                          ShardCtx())
    out = tserve.generate(tm, tp, torch.as_tensor(prompts), 6, 14)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_serve_cli_rwkv_on_cpu(capsys):
    tserve.main(["--arch", ARCH, "--smoke", "--batch", "2", "--prompt-len",
                 "4", "--gen", "3", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "rwkv6-1.6b-smoke" in out and "generated 2x3 tokens" in out


def test_rwkv_entry_points_refuse_silent_cpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    model = build_model(_cfgs()[1])
    assert isinstance(model, RWKVModel)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.init_cache(1, 4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserve.main(["--arch", ARCH, "--smoke"])
