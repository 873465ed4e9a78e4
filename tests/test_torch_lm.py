"""The decoder LM's serving path in the port against the JAX package:
configs, layers, attention (every impl, cached decode with a full and a
ring-buffer cache), ``DecoderLM.prefill`` / ``decode_step`` and
``serve.generate`` for the dense, MoE (with the routing pinned in bf16)
and stub-frontend decoders, with JAX's weights carried across by
``convert.lm_params_from_jax``.  JAX's Pallas path runs in interpret
mode, as ``tests/test_attention_impls.py`` runs it."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.launch import serve as jserve
from repro.models.api import build_model as jbuild_model
from repro.nn import attention as jattn
from repro.nn import layers as jlayers
from repro.nn import mlp as jmlp
from repro.nn import param as jparam
from repro.nn.layers import ShardCtx
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.launch import serve as tserve
from repro_torch.models.api import build_model
from repro_torch.nn import attention as tattn
from repro_torch.nn import layers as tlayers
from repro_torch.nn import mlp as tmlp
from repro_torch.nn import param as tparam

torch.set_num_threads(2)          # six test workers share the box

RNG = np.random.default_rng(0)
F32 = dict(atol=1e-4, rtol=1e-4)          # same algorithm, other sum order
BF16 = dict(atol=0.15, rtol=0.05)         # test_decode_parity.py's bar
IMPLS = {"xla": "dot", "chunked": "chunked", "pallas": "kernel"}


def _cfgs(name, **over):
    """(JAX config, port config) of the 2-layer, d_model 128 variant."""
    j = dataclasses.replace(
        jget_config(name).reduced(num_layers=2, d_model=128), **over)
    t = dataclasses.replace(
        tconfigs.get_config(name).reduced(num_layers=2, d_model=128),
        **{k: convert.ATTENTION_IMPL_FROM_JAX[v]
           if k == "attention_impl" else v for k, v in over.items()})
    return j, t


def _model_pair(name="llama3.2-1b", seed=0, **over):
    jcfg, tcfg = _cfgs(name, **over)
    jm = jbuild_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(seed))
    tp = convert.lm_params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                                    "cpu")
    return jm, jp, build_model(tcfg), tp


def _tokens(cfg, shape, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape)


# ------------------------------------------------------------------ configs
def _as_port(d):
    return dict(d, attention_impl=IMPLS[d["attention_impl"]])


@pytest.mark.parametrize("name",
                         ["llama3.2-1b", "repro-100m", "rwkv6-1.6b",
                          "gemma-7b", "granite-34b", "minitron-8b",
                          "zamba2-7b", "grok-1-314b",
                          "llama4-scout-17b-a16e", "internvl2-2b",
                          "seamless-m4t-large-v2"])
def test_config_copies_match_jax(name):
    j, t = jget_config(name), tconfigs.get_config(name)
    assert dataclasses.asdict(t) == _as_port(dataclasses.asdict(j))
    for kw in ({}, dict(num_layers=2, d_model=128)):
        assert dataclasses.asdict(t.reduced(**kw)) == \
            _as_port(dataclasses.asdict(j.reduced(**kw)))
    assert t.resolved_head_dim() == j.resolved_head_dim()
    assert t.supports_long_context == j.supports_long_context
    assert convert.ATTENTION_IMPL_FROM_JAX == IMPLS
    assert sorted(tconfigs.all_configs()) == [
        "gemma-7b", "granite-34b", "grok-1-314b", "internvl2-2b",
        "llama3.2-1b", "llama4-scout-17b-a16e", "minitron-8b",
        "repro-100m", "rwkv6-1.6b", "seamless-m4t-large-v2", "zamba2-7b"]


def test_param_specs_and_count_match_jax():
    for name in ("llama3.2-1b", "repro-100m", "gemma-7b", "granite-34b",
                 "minitron-8b", "grok-1-314b", "llama4-scout-17b-a16e",
                 "internvl2-2b", "seamless-m4t-large-v2"):
        cfg = tconfigs.get_config(name)
        t, j = build_model(cfg).param_specs(), \
            jbuild_model(jget_config(name)).param_specs()
        tl = jax.tree_util.tree_leaves(t, is_leaf=tparam.is_spec)
        jl = jax.tree_util.tree_leaves(j, is_leaf=jparam.is_spec)
        assert jax.tree_util.tree_structure(
            jax.tree_util.tree_map(lambda s: 0, t, is_leaf=tparam.is_spec)) \
            == jax.tree_util.tree_structure(
                jax.tree_util.tree_map(lambda s: 0, j, is_leaf=jparam.is_spec))
        assert [dataclasses.astuple(a) for a in tl] == \
            [dataclasses.astuple(b) for b in jl]
        assert tparam.count_params(t) == jparam.count_params(j)
    assert tparam.count_params(build_model(
        tconfigs.get_config("llama3.2-1b")).param_specs()) == 1_235_814_400


def test_materialize_nested_inits():
    _, tcfg = _cfgs("llama3.2-1b")
    model = build_model(tcfg)
    p = model.init(torch.Generator().manual_seed(0), device="cpu")
    q = model.init(torch.Generator().manual_seed(0), device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(
        jax.tree_util.tree_leaves(p), jax.tree_util.tree_leaves(q)))
    assert torch.equal(p["ln_f"], torch.ones(128))
    assert torch.equal(p["layers"]["ln1"], torch.ones(2, 128))
    assert abs(float(p["embedding"].std()) - 0.02) < 1e-3      # "embed"
    # JAX's fan-in is every axis but the last: L * D * H = 1024 here
    wq = p["layers"]["attn"]["wq"]
    assert abs(float(wq.std()) * 1024 ** 0.5 - 1.0) < 0.05
    assert wq.shape == (2, 128, 4, 32) and wq.dtype == torch.float32


def test_lm_params_round_trip():
    jm, jp, _, tp = _model_pair()
    back = convert.lm_params_to_numpy(tp)
    for a, b in zip(jax.tree_util.tree_leaves(jp),
                    jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(np.asarray(a), b)
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(jax.tree_util.tree_map(np.asarray, jp))
    bf = convert.lm_params_from_jax(
        {"a": {"w": np.asarray(jnp.asarray([1.5, -2.0], jnp.bfloat16))}},
        "cpu")
    assert bf["a"]["w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        convert.lm_params_to_numpy(bf)["a"]["w"], [1.5, -2.0])


def test_moe_params_round_trip():
    """An MoE layer's ``moe`` subtree (router, stacked experts) carried
    both ways."""
    _, jp, _, tp = _model_pair("grok-1-314b")
    back = convert.lm_params_to_numpy(tp)
    assert sorted(back["layers"]["moe"]) == ["router", "wi_gate", "wi_up",
                                             "wo"]
    for a, b in zip(jax.tree_util.tree_leaves(jp),
                    jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(np.asarray(a), b)


# ------------------------------------------------------------------- layers
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_matches_jax(dtype):
    x = RNG.normal(size=(2, 5, 64)).astype(np.float32) * 3
    scale = RNG.normal(size=(64,)).astype(np.float32)
    out = tlayers.rmsnorm(torch.as_tensor(x).to(getattr(torch, dtype)),
                          torch.as_tensor(scale))
    ref = jlayers.rmsnorm(jnp.asarray(x, dtype), jnp.asarray(scale))
    assert out.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref, np.float32),
                               **(F32 if dtype == "float32"     # 1 ulp:
                                  else dict(atol=1e-6, rtol=2 ** -8)))


def test_apply_rope_matches_jax_to_9216():
    x = RNG.normal(size=(1, 48, 2, 64)).astype(np.float32)
    pos = np.sort(RNG.integers(0, 9217, (1, 48)))
    pos[0, -1] = 9216
    out = tlayers.apply_rope(torch.as_tensor(x), torch.as_tensor(pos),
                             500000.0)
    ref = jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos, jnp.int32),
                             500000.0)
    # fp32 angles up to 9216 rad: both take sin/cos of the same fp32
    # angle, to within an ulp or two of the result
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)
    np.testing.assert_allclose(
        tlayers.rope_freqs(64, 500000.0).numpy(),
        np.asarray(jlayers.rope_freqs(64, 500000.0)), rtol=1e-6)


@pytest.mark.parametrize("act", ["swiglu", "geglu", "gelu"])
def test_mlp_matches_jax(act):
    specs = jmlp.mlp_specs(32, 64, act)
    jp = jparam.materialize(specs, jax.random.PRNGKey(0))
    x = RNG.normal(size=(2, 5, 32)).astype(np.float32)
    out = tmlp.mlp(convert.lm_params_from_jax(
        jax.tree_util.tree_map(np.asarray, jp), "cpu"),
        torch.as_tensor(x), act, torch.float32)
    ref = jmlp.mlp(jp, jnp.asarray(x), act, dtype=jnp.float32)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **F32)


# ---------------------------------------------------------------- attention
def _attn_params(d=64, h=4, kv=2, hd=16, seed=0):
    jp = jparam.materialize(jattn.attention_specs(d, h, kv, hd),
                            jax.random.PRNGKey(seed))
    return jp, convert.lm_params_from_jax(
        jax.tree_util.tree_map(np.asarray, jp), "cpu")


@pytest.mark.parametrize("window", [None, 24])
@pytest.mark.parametrize("impl", ["xla", "chunked", "pallas"])
def test_attend_matches_jax(impl, window):
    jp, tp = _attn_params()
    x = RNG.normal(size=(2, 48, 64)).astype(np.float32)
    pos = np.tile(np.arange(48), (2, 1))
    kw = dict(num_heads=4, num_kv_heads=2, head_dim=16, rope_theta=1e4,
              window=window)
    out = tattn.attend(tp, torch.as_tensor(x), torch.as_tensor(pos),
                       dtype=torch.float32, impl=IMPLS[impl], **kw)
    ref = jattn.attend(jp, jnp.asarray(x), jnp.asarray(pos, jnp.int32),
                       dtype=jnp.float32, impl=impl, **kw)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **F32)


@pytest.mark.parametrize("window,cache_len", [(None, 16), (6, 6)])
def test_decode_attend_matches_jax(window, cache_len):
    """12 single-token steps; with a window the cache is a ring buffer
    of ``window`` slots, so it wraps twice."""
    jp, tp = _attn_params()
    kw = dict(num_heads=4, num_kv_heads=2, head_dim=16, rope_theta=1e4,
              window=window)
    jc = jattn.init_cache(2, cache_len, 2, 16, jnp.float32)
    tc = tattn.init_cache(2, cache_len, 2, 16, torch.float32)
    for t in range(12):
        x = RNG.normal(size=(2, 1, 64)).astype(np.float32)
        pos = np.array([t, t + 3])
        out, tc = tattn.decode_attend(tp, torch.as_tensor(x),
                                      tc, torch.as_tensor(pos),
                                      dtype=torch.float32, **kw)
        ref, jc = jattn.decode_attend(jp, jnp.asarray(x), jc,
                                      jnp.asarray(pos, jnp.int32),
                                      dtype=jnp.float32, **kw)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), **F32)
    for k in ("k", "v"):
        np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]), **F32)


# -------------------------------------------------------------------- model
def _prefill_pair(dtype, s, **over):
    jm, jp, tm, tp = _model_pair(dtype=dtype, attention_impl="pallas",
                                 **over)
    toks = _tokens(jm.cfg, (2, s))
    ref = np.asarray(jm.prefill(jp, {"tokens": jnp.asarray(toks,
                                                           jnp.int32)}),
                     np.float32)
    out = tm.prefill(tp, {"tokens": torch.as_tensor(toks)})
    assert out.shape == ref.shape and out.dtype == torch.float32
    return out.numpy(), ref


# the dense configs at reduced size: llama3.2-1b (GQA, SwiGLU), gemma-7b
# (GeGLU, tied embeddings), granite-34b (MQA, GELU), minitron-8b (GQA,
# SwiGLU)
DENSE = ["llama3.2-1b", "gemma-7b", "granite-34b", "minitron-8b"]


@pytest.mark.parametrize("name", DENSE)
@pytest.mark.parametrize("over", [dict(sliding_window=None),
                                  dict(sliding_window=24)])
def test_prefill_kernel_matches_jax_pallas_f32(over, name):
    out, ref = _prefill_pair("float32", 64, name=name, **over)
    np.testing.assert_allclose(out, ref, **F32)


@pytest.mark.parametrize("name", DENSE)
def test_prefill_kernel_matches_jax_pallas_bf16(name):
    out, ref = _prefill_pair("bfloat16", 64, name=name, sliding_window=None)
    np.testing.assert_allclose(out, ref, **BF16)
    assert np.array_equal(out.argmax(-1), ref.argmax(-1))


@pytest.mark.parametrize("name", DENSE)
@pytest.mark.parametrize("cache_len,window", [(16, None), (8, 8)])
def test_decode_steps_match_jax(cache_len, window, name):
    """12 decode steps; with ``sliding_window == cache_len`` the model
    picks the ring-buffer cache itself."""
    jm, jp, tm, tp = _model_pair(name, dtype="float32",
                                 sliding_window=window)
    toks = _tokens(jm.cfg, (2, 12))
    jc, tc = jm.init_cache(2, cache_len), tm.init_cache(2, cache_len,
                                                        device="cpu")
    step = jax.jit(lambda p, c, b: jm.decode_step(p, c, b))
    for t in range(12):
        ref, jc = step(jp, jc, {"token": jnp.asarray(toks[:, t:t + 1],
                                                     jnp.int32),
                                "pos": jnp.full((2,), t, jnp.int32)})
        out, tc = tm.decode_step(tp, tc, {
            "token": torch.as_tensor(toks[:, t:t + 1]),
            "pos": torch.full((2,), t)})
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), **F32)
    np.testing.assert_allclose(tc["k"].numpy(), np.asarray(jc["k"]), **F32)


def test_decode_matches_prefill_in_port():
    """JAX's serving invariant (tests/test_decode_parity.py), in the port
    with the kernel path's plain version."""
    _, _, tm, tp = _model_pair(attention_impl="pallas")
    toks = torch.as_tensor(_tokens(tm.cfg, (2, 12)))
    full = tm.prefill(tp, {"tokens": toks})
    cache = tm.init_cache(2, 16, device="cpu")
    for t in range(12):
        logits, cache = tm.decode_step(tp, cache, {
            "token": toks[:, t:t + 1], "pos": torch.full((2,), t)})
    np.testing.assert_allclose(logits[:, 0].float().numpy(),
                               full[:, 0].float().numpy(), **BF16)
    assert torch.equal(logits[:, 0].argmax(-1), full[:, 0].argmax(-1))


def test_generate_greedy_matches_jax():
    jm, jp, tm, tp = _model_pair(dtype="float32")
    prompts = _tokens(jm.cfg, (2, 8))
    ref = jserve.generate(jm, jp, jnp.asarray(prompts, jnp.int32), 6, 14,
                          ShardCtx())
    out = tserve.generate(tm, tp, torch.as_tensor(prompts), 6, 14)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_generate_sampling_stays_in_vocab():
    _, _, tm, tp = _model_pair(dtype="float32")
    prompts = torch.as_tensor(_tokens(tm.cfg, (2, 4)))
    a = tserve.generate(tm, tp, prompts, 5, 9, temperature=1.0,
                        generator=torch.Generator().manual_seed(3))
    b = tserve.generate(tm, tp, prompts, 5, 9, temperature=1.0,
                        generator=torch.Generator().manual_seed(3))
    assert torch.equal(a, b) and a.shape == (2, 5)
    assert bool(((a >= 0) & (a < tm.cfg.vocab_size)).all())


def test_serve_cli_on_cpu(capsys):
    tserve.main(["--smoke", "--batch", "2", "--prompt-len", "4", "--gen",
                 "3", "--device", "cpu"])
    assert "generated 2x3 tokens" in capsys.readouterr().out


@pytest.mark.parametrize("over,cls", [
    (dict(encdec=tconfigs.EncDecConfig(num_encoder_layers=2,
                                       encoder_seq=8)), "EncDecModel"),
    (dict(moe=tconfigs.MoEConfig(num_experts=4, top_k=2)), "DecoderLM"),
    (dict(frontend=tconfigs.FrontendStub("vision", 4, 128)), "DecoderLM")])
def test_new_families_build_and_prefill(over, cls):
    """Each family that waited for its slice now builds its model class
    and runs a prefill: the encoder-decoder over stub frames, MoE layers
    in place of the MLP, and a stub frontend's rows before the tokens."""
    _, tcfg = _cfgs("llama3.2-1b", dtype="float32")
    cfg = dataclasses.replace(tcfg, **over)
    model = build_model(cfg)
    assert type(model).__name__ == cls
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    batch = {"tokens": torch.as_tensor(_tokens(cfg, (2, 6)))}
    if cfg.encdec is not None:
        batch["src_embeds"] = torch.randn(2, 8, 128)
    if cfg.frontend.kind != "none":
        batch["embeds"] = torch.randn(2, 4, 128)
    out = model.prefill(params, batch)
    assert out.shape == (2, 1, cfg.vocab_size)
    assert bool(torch.isfinite(out).all())
    if cls == "DecoderLM":
        assert ("moe" in params["layers"]) == (cfg.moe is not None)


def test_build_model_gives_rwkv_for_ssm():
    from repro_torch.models.rwkv_model import RWKVModel
    for cfg in (tconfigs.get_config("rwkv6-1.6b"),
                dataclasses.replace(tconfigs.get_config("llama3.2-1b"),
                                    arch_type="ssm")):
        assert isinstance(build_model(cfg), RWKVModel)


def test_lm_entry_points_refuse_silent_cpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    _, tcfg = _cfgs("llama3.2-1b")
    model = build_model(tcfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.init(torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.init_cache(1, 4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserve.main(["--smoke"])


# ------------------------------------------------------------ MoE and vlm
# grok-1 (top-2 of 4 experts at reduced(), GeGLU) and llama4-scout (top-1,
# SwiGLU), 4/2 heads of 32
MOE = ["grok-1-314b", "llama4-scout-17b-a16e"]


def _jax_routing(jm, jp, tokens):
    """The expert ids (L, B, S, k) that JAX's ``DecoderLM.prefill`` routes
    each layer's tokens to: its blocks run one by one, the router read
    between attention and MoE (rmsnorm, fp32 softmax, ``lax.top_k``)."""
    cfg = jm.cfg
    dtype = jnp.dtype(cfg.dtype)
    x = jm._embed_inputs(jp, {"tokens": jnp.asarray(tokens, jnp.int32)},
                         dtype)
    b, s, _ = x.shape
    positions = jnp.broadcast_to(jnp.arange(s, dtype=jnp.int32), (b, s))
    ids = []
    for i in range(cfg.num_layers):
        lp = jax.tree_util.tree_map(lambda a: a[i], jp["layers"])
        h = jattn.attend(lp["attn"], jlayers.rmsnorm(x, lp["ln1"],
                                                     cfg.norm_eps),
                         positions, num_heads=cfg.num_heads,
                         num_kv_heads=cfg.num_kv_heads,
                         head_dim=cfg.resolved_head_dim(),
                         rope_theta=cfg.rope_theta, causal=True,
                         dtype=dtype, impl=cfg.attention_impl)
        xn = jlayers.rmsnorm(x + h, lp["ln2"], cfg.norm_eps)
        logits = jnp.einsum("bsd,de->bse", xn.astype(jnp.float32),
                            lp["moe"]["router"].astype(jnp.float32))
        ids.append(np.array(jax.lax.top_k(jax.nn.softmax(logits, -1),
                                          cfg.moe.top_k)[1]))
        x, _ = jm._block(lp, x, positions, jlayers.NO_SHARD, None, dtype)
    return np.stack(ids)


@pytest.mark.parametrize("name", MOE)
def test_moe_prefill_matches_jax_f32(name):
    """fp32 compute through the kernel route (JAX's Pallas in interpret
    mode): the routing is JAX's token for token, the logits within F32."""
    jm, jp, tm, tp = _model_pair(name, dtype="float32",
                                 attention_impl="pallas",
                                 sliding_window=None)
    toks = _tokens(jm.cfg, (2, 64))
    ref = np.asarray(jm.prefill(jp, {"tokens": jnp.asarray(toks,
                                                           jnp.int32)}))
    out = tm.prefill(tp, {"tokens": torch.as_tensor(toks)})
    np.testing.assert_allclose(out.numpy(), ref, **F32)
    ids = tm.routing(tp, {"tokens": torch.as_tensor(toks)})
    np.testing.assert_array_equal(ids.numpy(), _jax_routing(jm, jp, toks))


@pytest.mark.parametrize("name", MOE)
def test_moe_prefill_bf16_with_jax_routing_pinned(name):
    """bf16: the port's own routing differs from JAX's only at near-ties
    (the count is printed); with JAX's expert ids pinned through
    ``batch["expert_ids"]`` the logits hold to BF16, argmax equal."""
    jm, jp, tm, tp = _model_pair(name, dtype="bfloat16",
                                 attention_impl="pallas",
                                 sliding_window=None)
    toks = _tokens(jm.cfg, (2, 64))
    ref = np.asarray(jm.prefill(jp, {"tokens": jnp.asarray(toks,
                                                           jnp.int32)}),
                     np.float32)
    jids = _jax_routing(jm, jp, toks)
    own = tm.routing(tp, {"tokens": torch.as_tensor(toks)}).numpy()
    flips = int((np.sort(own, -1) != np.sort(jids, -1)).any(-1).sum())
    print(f"{name}: {flips} of {own[..., 0].size} (layer, token) routings "
          f"differ from JAX's in bf16")
    out = tm.prefill(tp, {"tokens": torch.as_tensor(toks),
                          "expert_ids": torch.as_tensor(jids)}).numpy()
    np.testing.assert_allclose(out, ref, **BF16)
    assert np.array_equal(out.argmax(-1), ref.argmax(-1))


@pytest.mark.parametrize("name", MOE)
def test_moe_decode_steps_match_jax(name):
    """12 fp32 decode steps: the MoE layer on (B, 1, D), where a group is
    one token and nothing is dropped."""
    jm, jp, tm, tp = _model_pair(name, dtype="float32")
    toks = _tokens(jm.cfg, (2, 12))
    jc, tc = jm.init_cache(2, 16), tm.init_cache(2, 16, device="cpu")
    step = jax.jit(lambda p, c, b: jm.decode_step(p, c, b))
    for t in range(12):
        ref, jc = step(jp, jc, {"token": jnp.asarray(toks[:, t:t + 1],
                                                     jnp.int32),
                                "pos": jnp.full((2,), t, jnp.int32)})
        out, tc = tm.decode_step(tp, tc, {
            "token": torch.as_tensor(toks[:, t:t + 1]),
            "pos": torch.full((2,), t)})
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), **F32)


@pytest.mark.parametrize("name", MOE)
def test_moe_decode_matches_prefill_when_dropless(name):
    """JAX's serving invariant on its dropless config
    (``capacity_factor = num_experts``, tests/test_decode_parity.py): at
    cf 1.25 prefill may drop choices that decode (one token a group)
    keeps."""
    jcfg, tcfg = _cfgs(name, dtype="float32")
    moe = dataclasses.replace(tcfg.moe,
                              capacity_factor=float(tcfg.moe.num_experts))
    tm = build_model(dataclasses.replace(tcfg, moe=moe))
    tp = tm.init(torch.Generator().manual_seed(0), device="cpu")
    toks = torch.as_tensor(_tokens(tcfg, (2, 12)))
    full = tm.prefill(tp, {"tokens": toks})
    cache = tm.init_cache(2, 16, device="cpu")
    for t in range(12):
        logits, cache = tm.decode_step(tp, cache, {
            "token": toks[:, t:t + 1], "pos": torch.full((2,), t)})
    np.testing.assert_allclose(logits.numpy(), full.numpy(), **F32)


def _vlm_batch(cfg, s, seed=0):
    r = np.random.default_rng(seed)
    return {"tokens": r.integers(0, cfg.vocab_size, (2, s)),
            "embeds": r.normal(size=(2, cfg.frontend.num_embeds,
                                     cfg.d_model)).astype(np.float32),
            "labels": r.integers(0, cfg.vocab_size, (2, s))}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_vlm_prefill_with_embeds_matches_jax(dtype):
    """internvl2-2b: 16 frontend rows before 48 tokens, positions over
    all 64, the kernel route (sliding window 24 inside the prompt)."""
    jm, jp, tm, tp = _model_pair("internvl2-2b", dtype=dtype,
                                 attention_impl="pallas",
                                 sliding_window=24)
    b = _vlm_batch(jm.cfg, 48)
    ref = np.asarray(jm.prefill(jp, {
        "tokens": jnp.asarray(b["tokens"], jnp.int32),
        "embeds": jnp.asarray(b["embeds"])}), np.float32)
    out = tm.prefill(tp, {"tokens": torch.as_tensor(b["tokens"]),
                          "embeds": torch.as_tensor(b["embeds"])})
    assert out.shape == ref.shape
    if dtype == "float32":
        np.testing.assert_allclose(out.numpy(), ref, **F32)
    else:
        np.testing.assert_allclose(out.float().numpy(), ref, **BF16)
        assert np.array_equal(out.numpy().argmax(-1), ref.argmax(-1))


def test_vlm_loss_skips_the_frontend_rows_as_jax():
    jm, jp, tm, tp = _model_pair("internvl2-2b", dtype="float32")
    b = _vlm_batch(jm.cfg, 40, seed=1)
    jl, jmet = jm.loss(jp, {"tokens": jnp.asarray(b["tokens"], jnp.int32),
                            "embeds": jnp.asarray(b["embeds"]),
                            "labels": jnp.asarray(b["labels"], jnp.int32)})
    tl, tmet = tm.loss(tp, {k: torch.as_tensor(v) for k, v in b.items()})
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    assert float(tmet["aux"]) == float(jmet["aux"]) == 0.0


@pytest.mark.parametrize("arch", MOE + ["internvl2-2b",
                                        "seamless-m4t-large-v2"])
def test_serve_cli_on_cpu_new_families(arch, capsys):
    """``launch.serve --smoke`` on the new families: tokens only, as
    JAX's ``generate`` (no frontend rows; the encoder-decoder's cross
    cache the zeros ``init_cache`` gives)."""
    tserve.main(["--arch", arch, "--smoke", "--batch", "2", "--prompt-len",
                 "4", "--gen", "3", "--device", "cpu"])
    assert "generated 2x3 tokens" in capsys.readouterr().out


@pytest.mark.parametrize("window", [None, 24])
def test_dot_attention_in_row_blocks_matches_one_block(window,
                                                       monkeypatch):
    """Past SCORES_BLOCK score elements the dot route takes its queries
    a block of rows at a time (a ragged last block here): the same
    function, and still JAX's."""
    jp, tp = _attn_params()
    x = RNG.normal(size=(2, 50, 64)).astype(np.float32)
    pos = np.tile(np.arange(50), (2, 1))
    kw = dict(num_heads=4, num_kv_heads=2, head_dim=16, rope_theta=1e4,
              window=window)
    whole = tattn.attend(tp, torch.as_tensor(x), torch.as_tensor(pos),
                         dtype=torch.float32, **kw)
    monkeypatch.setattr(tattn, "SCORES_BLOCK", 2 * 4 * 50 * 7)   # 7 rows
    blocked = tattn.attend(tp, torch.as_tensor(x), torch.as_tensor(pos),
                           dtype=torch.float32, **kw)
    torch.testing.assert_close(blocked, whole, atol=1e-6, rtol=1e-6)
    ref = jattn.attend(jp, jnp.asarray(x), jnp.asarray(pos, jnp.int32),
                       dtype=jnp.float32, **kw)
    np.testing.assert_allclose(blocked.numpy(), np.asarray(ref), **F32)
