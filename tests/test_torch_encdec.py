"""The port's encoder-decoder (``models/encdec.py``, seamless-m4t-large-v2
at ``reduced(num_layers=2, d_model=128)``: 2 + 2 layers, 32 stub source
frames) against the JAX package's ``EncDecModel`` on the same seeded
inputs: ``loss`` and its gradients, ``prefill``, ``build_cross_cache``
with ``decode_step``, the caches, ``serve.generate``, and decode =
prefill in the port.  JAX's weights are carried across by
``convert.lm_params_from_jax``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.launch import serve as jserve
from repro.models.api import build_model as jbuild_model
from repro.nn.layers import NO_SHARD, ShardCtx
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.launch import serve as tserve
from repro_torch.launch import steps as tsteps
from repro_torch.models.api import build_model
from repro_torch.models.encdec import EncDecModel
from repro_torch.nn.param import tree_leaves

torch.set_num_threads(2)          # six test workers share the box

NAME = "seamless-m4t-large-v2"
F32 = dict(atol=1e-4, rtol=1e-4)          # same algorithm, other sum order
BF16 = dict(atol=0.15, rtol=0.05)         # test_decode_parity.py's bar
GRAD_REL = 1e-4                   # max|g_port - g_jax| <= this * max|g_jax|


def _pair(dtype="float32", **over):
    jcfg = dataclasses.replace(
        jget_config(NAME).reduced(num_layers=2, d_model=128), dtype=dtype,
        **over)
    tcfg = dataclasses.replace(
        tconfigs.get_config(NAME).reduced(num_layers=2, d_model=128),
        dtype=dtype, **over)
    jm = jbuild_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tp = convert.lm_params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                                    "cpu")
    return jm, jp, build_model(tcfg), tp


def _batch(cfg, b, s, seed=0):
    r = np.random.default_rng(seed)
    return {"src_embeds": r.normal(size=(b, cfg.encdec.encoder_seq,
                                         cfg.d_model)).astype(np.float32),
            "tokens": r.integers(0, cfg.vocab_size, (b, s)).astype(np.int32),
            "labels": r.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)}


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _t(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def test_build_model_gives_encdec_with_jax_trees():
    jm, jp, tm, tp = _pair()
    assert isinstance(tm, EncDecModel)
    assert jax.tree_util.tree_structure(
        jax.tree_util.tree_map(np.asarray, jp)) == \
        jax.tree_util.tree_structure(convert.lm_params_to_numpy(tp))
    jc = jax.tree_util.tree_map(np.asarray, jm.init_cache(2, 16))
    tc = tm.init_cache(2, 16, device="cpu")
    assert sorted(tc) == ["cross", "self"]
    for a, b in zip(jax.tree_util.tree_leaves(jc), tree_leaves(tc)):
        assert a.shape == tuple(b.shape) and not b.any()
        assert str(b.dtype) == f"torch.{a.dtype}"


def test_loss_and_every_gradient_leaf_match_jax():
    jm, jp, tm, tp = _pair()
    batch = _batch(tm.cfg, 2, 24)
    fn = jax.jit(jax.value_and_grad(lambda p: jm.loss(p, _j(batch)),
                                    has_aux=True))
    (jl, jmet), jg = fn(jp)
    (tl, tmet), tg = tsteps.value_and_grad(lambda p: tm.loss(p, _t(batch)),
                                           tp)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    assert float(tmet["aux"]) == float(jmet["aux"]) == 0.0
    jleaves = jax.tree_util.tree_leaves(jg)
    tleaves = tree_leaves(tg)
    assert len(jleaves) == len(tleaves)
    for a, b in zip(tleaves, jleaves):
        a, b = a.double().numpy(), np.asarray(b, np.float64)
        assert np.abs(a - b).max() <= GRAD_REL * np.abs(b).max() + 1e-9


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_matches_jax(dtype):
    jm, jp, tm, tp = _pair(dtype)
    batch = _batch(tm.cfg, 2, 20, seed=1)
    del batch["labels"]
    ref = np.asarray(jm.prefill(jp, _j(batch)), np.float32)
    out = tm.prefill(tp, _t(batch))
    assert out.shape == ref.shape == (2, 1, tm.cfg.vocab_size)
    if dtype == "float32":
        np.testing.assert_allclose(out.numpy(), ref, **F32)
    else:
        np.testing.assert_allclose(out.numpy(), ref, **BF16)
        assert np.array_equal(out.numpy().argmax(-1), ref.argmax(-1))


def test_cross_cache_and_decode_steps_match_jax():
    """``build_cross_cache`` of the encoder memory, then 12 fp32 decode
    steps against it; the caches after them."""
    jm, jp, tm, tp = _pair()
    batch = _batch(tm.cfg, 2, 12, seed=2)
    jmem = jm._encode(jp, jnp.asarray(batch["src_embeds"]), NO_SHARD)
    tmem = tm._encode(tp, torch.as_tensor(batch["src_embeds"]))
    np.testing.assert_allclose(tmem.numpy(), np.asarray(jmem), **F32)
    jcross = jm.build_cross_cache(jp, jmem)
    tcross = tm.build_cross_cache(tp, tmem)
    for k in ("k", "v"):
        np.testing.assert_allclose(tcross[k].numpy(),
                                   np.asarray(jcross[k]), **F32)
    jc = dict(jm.init_cache(2, 16), cross=jcross)
    tc = dict(tm.init_cache(2, 16, device="cpu"), cross=tcross)
    step = jax.jit(lambda p, c, b: jm.decode_step(p, c, b))
    toks = batch["tokens"]
    for t in range(12):
        ref, jc = step(jp, jc, {"token": jnp.asarray(toks[:, t:t + 1]),
                                "pos": jnp.full((2,), t, jnp.int32)})
        out, tc = tm.decode_step(tp, tc, {
            "token": torch.as_tensor(toks[:, t:t + 1]),
            "pos": torch.full((2,), t)})
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), **F32)
    for k in ("k", "v"):
        np.testing.assert_allclose(tc["self"][k].numpy(),
                                   np.asarray(jc["self"][k]), **F32)


def test_decode_matches_prefill_in_port():
    """The serving invariant: decode over the prompt from an empty self
    cache and the memory's cross cache reaches prefill's logits."""
    _, _, tm, tp = _pair()
    batch = _t(_batch(tm.cfg, 2, 12, seed=3))
    full = tm.prefill(tp, batch)
    cache = dict(tm.init_cache(2, 16, device="cpu"),
                 cross=tm.build_cross_cache(
                     tp, tm._encode(tp, batch["src_embeds"])))
    for t in range(12):
        logits, cache = tm.decode_step(tp, cache, {
            "token": batch["tokens"][:, t:t + 1],
            "pos": torch.full((2,), t)})
    np.testing.assert_allclose(logits.numpy(), full.numpy(), **F32)


def test_generate_greedy_matches_jax():
    """``serve.generate`` as JAX's: its cache's cross keys and values are
    the zeros ``init_cache`` gives (JAX's generate builds no cross
    cache)."""
    jm, jp, tm, tp = _pair()
    prompts = np.random.default_rng(4).integers(0, tm.cfg.vocab_size,
                                                (2, 6))
    ref = jserve.generate(jm, jp, jnp.asarray(prompts, jnp.int32), 5, 11,
                          ShardCtx())
    out = tserve.generate(tm, tp, torch.as_tensor(prompts), 5, 11)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_jax_caches_and_trees_carry_across():
    """``convert`` carries JAX's encoder-decoder trees both ways (the
    ``enc_layers``/``dec_layers`` parameters, a cache with its ``cross``
    keys and values): the port continues JAX's decode from JAX's cache."""
    jm, jp, tm, tp = _pair()
    back = convert.lm_params_to_numpy(tp)
    for a, b in zip(jax.tree_util.tree_leaves(jp),
                    jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(np.asarray(a), b)
    batch = _batch(tm.cfg, 2, 6, seed=5)
    jmem = jm._encode(jp, jnp.asarray(batch["src_embeds"]), NO_SHARD)
    jc = dict(jm.init_cache(2, 8), cross=jm.build_cross_cache(jp, jmem))
    step = jax.jit(lambda p, c, b: jm.decode_step(p, c, b))
    toks = batch["tokens"]
    for t in range(3):
        _, jc = step(jp, jc, {"token": jnp.asarray(toks[:, t:t + 1]),
                              "pos": jnp.full((2,), t, jnp.int32)})
    tc = convert.lm_params_from_jax(jax.tree_util.tree_map(np.asarray, jc),
                                    "cpu")
    assert sorted(tc) == ["cross", "self"]
    for t in range(3, 6):
        ref, jc = step(jp, jc, {"token": jnp.asarray(toks[:, t:t + 1]),
                                "pos": jnp.full((2,), t, jnp.int32)})
        out, tc = tm.decode_step(tp, tc, {
            "token": torch.as_tensor(toks[:, t:t + 1]),
            "pos": torch.full((2,), t)})
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), **F32)
