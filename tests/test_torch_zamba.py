"""The zamba2 hybrid's serving path in the port against the JAX package on
``zamba2-7b`` ``reduced(num_layers=5, d_model=128)`` with two shared
blocks: groups of (2, 2, 1) mamba layers, so the shared blocks alternate
and the last group is ragged; 4 heads of 32, state 32, chunk 32, window
64.  JAX's weights (and JAX's cache) are carried across by
``convert.lm_params_from_jax``.  ``ZambaModel.param_specs``, ``prefill``
(both attention routes: JAX's ``"xla"`` and its Pallas kernel in
interpret mode against the port's ``"dot"`` and the flash wrapper, whose
plain version CPU tensors take), ``decode_step`` and its cache, the KV
ring buffer, ``serve.generate`` and the CLI; and, in the port, decode
over the prompt reaching prefill's logits."""
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
from repro.nn.layers import ShardCtx
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.launch import serve as tserve
from repro_torch.models.api import build_model
from repro_torch.models.zamba import ZambaModel
from repro_torch.nn import param as tparam

torch.set_num_threads(2)          # six test workers share the box

ARCH = "zamba2-7b"
F32 = dict(atol=1e-4, rtol=1e-4)          # same algorithm, other sum order
BF16 = dict(atol=0.15, rtol=0.05)         # test_decode_parity.py's bar
IMPLS = {"xla": "dot", "pallas": "kernel"}


def _cfgs(**over):
    """(JAX config, port config): 5 layers, d_model 128, 2 shared
    blocks; ``attention_impl`` given by JAX's name."""
    out = []
    for get in (jget_config, tconfigs.get_config):
        c = get(ARCH).reduced(num_layers=5, d_model=128)
        c = dataclasses.replace(c, hybrid=dataclasses.replace(
            c.hybrid, num_shared_blocks=2), **over)
        out.append(c)
    jcfg, tcfg = out
    if "attention_impl" in over:
        tcfg = dataclasses.replace(
            tcfg, attention_impl=IMPLS[over["attention_impl"]])
    return jcfg, tcfg


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


def _leaves_close(port, ref, **tol):
    a = jax.tree_util.tree_leaves(convert.lm_params_to_numpy(port))
    b = jax.tree_util.tree_leaves(ref)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.shape == y.shape
        np.testing.assert_allclose(x, np.asarray(y, np.float32), **tol)


def test_zamba_param_specs_and_count_match_jax():
    for jcfg, tcfg in (_cfgs(), (jget_config(ARCH),
                                 tconfigs.get_config(ARCH))):
        t = build_model(tcfg).param_specs()
        j = jbuild_model(jcfg).param_specs()
        tl = jax.tree_util.tree_leaves(t, is_leaf=tparam.is_spec)
        jl = jax.tree_util.tree_leaves(j, is_leaf=jparam.is_spec)
        assert [dataclasses.astuple(a) for a in tl] == \
            [dataclasses.astuple(b) for b in jl]
        assert tparam.count_params(t) == jparam.count_params(j)
    full = build_model(tconfigs.get_config(ARCH))
    assert tparam.count_params(full.param_specs()) == 6_956_658_896
    # 81 layers in 14 groups: 13 of 6 and one of 3, so 14 applications
    # of the 2 shared blocks
    assert full.group_sizes == [6] * 13 + [3]
    assert build_model(_cfgs()[1]).group_sizes == [2, 2, 1]


def test_build_model_gives_zamba_for_hybrid():
    for cfg in (tconfigs.get_config(ARCH), _cfgs()[1]):
        assert isinstance(build_model(cfg), ZambaModel)
    with pytest.raises(ValueError, match="scan_impl"):
        ZambaModel(_cfgs()[1], scan_impl="pallas")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_prefill_matches_jax(impl, dtype):
    """80 tokens: past the reduced window of 64, two and a half chunks."""
    jm, jp, tm, tp = _model_pair(dtype=dtype, attention_impl=impl)
    toks = _tokens(jm.cfg, (2, 80))
    ref = np.asarray(jm.prefill(jp, {"tokens": jnp.asarray(toks,
                                                           jnp.int32)}),
                     np.float32)
    out = tm.prefill(tp, {"tokens": torch.as_tensor(toks)})
    assert out.shape == ref.shape and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref,
                               **(F32 if dtype == "float32" else BF16))
    if dtype == "bfloat16":
        assert np.array_equal(out.numpy().argmax(-1), ref.argmax(-1))


def test_prefill_scan_impls_agree():
    """``scan_impl="plain"`` runs ``nn.linear_attn.gla_chunked``, which
    is the kernel route's plain version on CPU tensors."""
    _, _, tm, tp = _model_pair(dtype="float32")
    toks = torch.as_tensor(_tokens(tm.cfg, (2, 40)))
    plain = ZambaModel(tm.cfg, scan_impl="plain")
    torch.testing.assert_close(plain.prefill(tp, {"tokens": toks}),
                               tm.prefill(tp, {"tokens": toks}),
                               atol=0, rtol=0)


def _decode_both(jm, jp, tm, tp, toks, cache_len, carry_at=None):
    """Decode ``toks`` token by token in both packages, the logits held
    step by step; with ``carry_at`` the port's cache is replaced by JAX's
    (converted) at that step.  Returns the port's last logits and both
    caches."""
    b = toks.shape[0]
    jc, tc = jm.init_cache(b, cache_len), tm.init_cache(b, cache_len,
                                                        device="cpu")
    step = jax.jit(lambda p, c, bt: jm.decode_step(p, c, bt))
    for t in range(toks.shape[1]):
        if t == carry_at:
            tc = _to_port(jc)
        ref, jc = step(jp, jc, {"token": jnp.asarray(toks[:, t:t + 1],
                                                     jnp.int32),
                                "pos": jnp.full((b,), t, jnp.int32)})
        out, tc = tm.decode_step(tp, tc, {
            "token": torch.as_tensor(toks[:, t:t + 1]),
            "pos": torch.full((b,), t)})
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), **F32)
    return out, tc, jc


def test_decode_steps_and_cache_match_jax():
    """12 steps into a 16-slot cache; from step 6 the port carries on
    from JAX's own cache (conv and SSD states of 5 layers, 3 groups' KV)."""
    jm, jp, tm, tp = _model_pair(dtype="float32")
    toks = _tokens(jm.cfg, (2, 12))
    _, tc, jc = _decode_both(jm, jp, tm, tp, toks, 16, carry_at=6)
    assert tc["mamba"][0].shape == (5, 2, 3, 320)      # conv: W - 1 = 3
    assert tc["mamba"][1].shape == (5, 2, 8, 32, 32)   # SSD state, fp32
    assert tc["kv"]["k"].shape == (3, 2, 16, 4, 32)    # one ring a group
    assert tc["mamba"][1].dtype == torch.float32
    _leaves_close(tc, jc, **F32)


def test_sliding_window_ring_buffer_matches_jax():
    """``sliding_window`` 8 and a prompt of 20: each group's KV cache is
    an 8-slot ring buffer that wraps twice; decode against JAX's step by
    step, and in the port the last step's logits against prefill's, whose
    attention takes the same window."""
    jm, jp, tm, tp = _model_pair(dtype="float32", sliding_window=8)
    toks = _tokens(jm.cfg, (2, 20), seed=1)
    out, tc, jc = _decode_both(jm, jp, tm, tp, toks, 32)
    assert tc["kv"]["k"].shape[2] == 8                   # min(32, window)
    _leaves_close(tc, jc, **F32)
    pre = tm.prefill(tp, {"tokens": torch.as_tensor(toks)})
    torch.testing.assert_close(out, pre, **F32)


def test_decode_matches_prefill_in_port():
    """JAX's serving invariant (tests/test_decode_parity.py, which runs
    it for zamba2-7b), in the port, bf16, through the kernel routes'
    plain versions."""
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


@pytest.mark.parametrize("arch", [ARCH, "gemma-7b"])
def test_serve_cli_on_cpu(arch, capsys):
    tserve.main(["--arch", arch, "--smoke", "--batch", "2", "--prompt-len",
                 "4", "--gen", "3", "--device", "cpu"])
    assert "generated 2x3 tokens" in capsys.readouterr().out
