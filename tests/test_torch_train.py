"""LM training in the port against the JAX package: the chunked
cross-entropy, each family's ``loss`` and every gradient leaf against
``jax.value_and_grad`` of JAX's, the train step against
``make_train_bundle``'s, JAX's chunk-128 overflow held against its decode
recurrence, the kernel route under grad on the CPU, and the training
entry point with a checkpoint restore.  JAX's weights are carried across by
``convert.lm_params_from_jax``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs.base import InputShape
from repro.launch.mesh import make_local_mesh
from repro.launch.steps import make_train_bundle
from repro.models import common as jcommon
from repro.models.api import build_model as jbuild_model
from repro.nn.sharding import RULE_SETS
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.models import common as tcommon
from repro_torch.models.api import build_model
from repro_torch.nn.param import tree_leaves

torch.set_num_threads(2)          # six test workers share the box

# fp32: the same function summed in another order.  Observed on this
# suite's inputs: losses within 1.4e-7 relative; the leaves held to
# GRAD_REL within 8.2e-6 of their max
LOSS_RTOL = 1e-5
GRAD_REL = 1e-4                   # max|g_port - g_jax| <= this * max|g_jax|
GRAD_ABS = 1e-7                   #   + this
# Both packages keep bf16 rounding points in an fp32 config: each
# projection's weight is cast to bf16 at use (rwkv6's and mamba's blocks
# take dtype=bfloat16 whatever cfg.dtype), so that leaf's gradient is
# rounded to bf16 in both, and rwkv6's channel mix rounds its receptance
# gate to bf16.  One bf16 ulp (2^-8 relative) flips where the fp32 sums
# before the rounding differ in their last bits, so those leaves, and
# every leaf of rwkv6 downstream of the gate, are held in norms:
BF16_LEAF_FRO = 1e-3              # observed <= 3.7e-4
BF16_LEAF_MAX = 1e-2              # of max|g_jax|; observed <= 4.3e-3
RWKV_FRO = 1e-3                   # observed <= 1.3e-4
RWKV_MAX = 1e-3                   # of max|g_jax|; observed <= 2.2e-4
# bf16 compute: roundings of two stacks of casts (JAX also sums the
# embedding's gradient rows in bf16, the port in fp32).  Observed: loss
# within 3.7e-4, leaves within 0.036 (rwkv6, zamba2-7b) and 0.013
BF16_LOSS_ATOL = 2e-2
BF16_GRAD_FRO = 5e-2              # ||g_port - g_jax|| / ||g_jax||
# grok-1-314b: MoE layers (top-2 of 4 experts at reduced()), its loss
# ce + the summed load-balance aux
FAMILIES = ["repro-100m", "rwkv6-1.6b", "zamba2-7b", "gemma-7b",
            "grok-1-314b"]


def _pair(name, *, layers=2, d_model=128, seed=0, **over):
    """(JAX model, JAX params, port model, port params) of ``name``'s
    ``reduced(layers, d_model)`` config with ``over`` replaced."""
    jcfg = dataclasses.replace(
        jget_config(name).reduced(num_layers=layers, d_model=d_model), **over)
    tcfg = dataclasses.replace(
        tconfigs.get_config(name).reduced(num_layers=layers,
                                          d_model=d_model), **over)
    jm = jbuild_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(seed))
    tp = convert.lm_params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                                    "cpu")
    return jm, jp, build_model(tcfg), tp


def _batch(vocab, b, s, seed=0):
    r = np.random.default_rng(seed)
    return {"tokens": r.integers(0, vocab, (b, s)).astype(np.int32),
            "labels": r.integers(0, vocab, (b, s)).astype(np.int32)}


def _tb(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def _jax_value_and_grad(jm, jp, batch):
    fn = jax.jit(jax.value_and_grad(
        lambda p: jm.loss(p, {k: jnp.asarray(v) for k, v in batch.items()}),
        has_aux=True))
    (loss, metrics), g = fn(jp)
    return float(loss), metrics, jax.tree_util.tree_map(np.asarray, g)


def _leaves_np(tree):
    return [np.asarray(x, np.float64)
            for x in jax.tree_util.tree_leaves(convert.lm_params_to_numpy(
                tree) if isinstance(next(iter(tree.values())), (
                    torch.Tensor, dict)) else tree)]


# ------------------------------------------------------ chunked_softmax_xent
@pytest.mark.parametrize("s,chunk", [(64, 16), (70, 16), (8, 16)])
@pytest.mark.parametrize("masked", [False, True])
def test_chunked_softmax_xent_value_and_grads(s, chunk, masked):
    r = np.random.default_rng(s + masked)
    x = r.normal(size=(2, s, 32)).astype(np.float32)
    table = (0.3 * r.normal(size=(50, 32))).astype(np.float32)
    labels = r.integers(0, 50, (2, s)).astype(np.int32)
    mask = (r.random((2, s)) > 0.3) if masked else None

    def jf(x_, t_):
        return jcommon.chunked_softmax_xent(
            x_, t_, jnp.asarray(labels),
            None if mask is None else jnp.asarray(mask), chunk=chunk)

    jv, (jgx, jgt) = jax.value_and_grad(jf, argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(table))
    tx = torch.as_tensor(x).requires_grad_()
    tt = torch.as_tensor(table).requires_grad_()
    tv = tcommon.chunked_softmax_xent(
        tx, tt, torch.as_tensor(labels),
        None if mask is None else torch.as_tensor(mask), chunk=chunk)
    tgx, tgt = torch.autograd.grad(tv, (tx, tt))
    np.testing.assert_allclose(float(tv.detach()), float(jv), rtol=1e-5)
    np.testing.assert_allclose(tgx.numpy(), np.asarray(jgx), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(tgt.numpy(), np.asarray(jgt), atol=1e-5,
                               rtol=1e-5)
    with torch.no_grad():                  # no checkpointing without grad
        assert float(tcommon.chunked_softmax_xent(
            tx, tt, torch.as_tensor(labels),
            None if mask is None else torch.as_tensor(mask),
            chunk=chunk)) == float(tv)


# ----------------------------------------------------- loss and gradients
@pytest.mark.parametrize("name", FAMILIES)
def test_loss_and_every_gradient_leaf_match_jax_fp32(name):
    """reduced() (d_model 256; rwkv6 and zamba2-7b at chunk 32), fp32
    compute, 96 tokens: past the dense configs' reduced window of 64."""
    jm, jp, tm, tp = _pair(name, d_model=256, dtype="float32")
    batch = _batch(tm.cfg.vocab_size, 2, 96)
    jl, jmet, jg = _jax_value_and_grad(jm, jp, batch)
    (tl, tmet), tg = tsteps.value_and_grad(
        lambda p: tm.loss(p, _tb(batch)), tp)
    np.testing.assert_allclose(float(tl), jl, rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(tmet["ce"]), float(jmet["ce"]),
                               rtol=LOSS_RTOL)
    if name == "grok-1-314b":
        assert float(jmet["aux"]) > 0
        np.testing.assert_allclose(float(tmet["aux"]), float(jmet["aux"]),
                                   rtol=LOSS_RTOL)
    else:
        assert float(tmet["aux"]) == float(jmet["aux"]) == 0.0
    jleaves = jax.tree_util.tree_leaves(jg)
    tleaves = [x.double().numpy() for x in tree_leaves(tg)]
    assert len(jleaves) == len(tleaves)
    for a, b in zip(tleaves, jleaves):
        assert a.shape == b.shape
        bf16_valued = np.array_equal(
            b, np.asarray(jnp.asarray(b).astype(jnp.bfloat16), np.float32))
        b = np.asarray(b, np.float64)
        err, top = np.abs(a - b).max(), np.abs(b).max()
        fro = np.linalg.norm(a - b) / np.linalg.norm(b)
        if bf16_valued and b.size > 64:
            assert fro <= BF16_LEAF_FRO and err <= BF16_LEAF_MAX * top
        elif name == "rwkv6-1.6b":
            assert fro <= RWKV_FRO and err <= RWKV_MAX * top
        else:
            assert err <= GRAD_REL * top + GRAD_ABS


@pytest.mark.parametrize("name", FAMILIES)
def test_loss_and_gradients_match_jax_bf16(name):
    jm, jp, tm, tp = _pair(name)
    batch = _batch(tm.cfg.vocab_size, 2, 96, seed=1)
    jl, _, jg = _jax_value_and_grad(jm, jp, batch)
    (tl, _), tg = tsteps.value_and_grad(lambda p: tm.loss(p, _tb(batch)),
                                        tp)
    assert abs(float(tl) - jl) <= BF16_LOSS_ATOL
    for a, b in zip(tree_leaves(tg), jax.tree_util.tree_leaves(jg)):
        a = a.double().numpy()
        b = np.asarray(b, np.float64)
        assert np.linalg.norm(a - b) <= BF16_GRAD_FRO * np.linalg.norm(b)


@pytest.mark.parametrize("name", ["repro-100m", "rwkv6-1.6b", "zamba2-7b",
                                  "grok-1-314b"])
def test_remat_gives_the_same_loss_and_gradients(name):
    cfg = dataclasses.replace(
        tconfigs.get_config(name).reduced(num_layers=2, d_model=128),
        dtype="float32")
    params = build_model(cfg).init(torch.Generator().manual_seed(0), "cpu")
    batch = _tb(_batch(cfg.vocab_size, 2, 64, seed=2))
    out = {}
    for remat in (False, True):
        m = build_model(dataclasses.replace(cfg, remat=remat))
        out[remat] = tsteps.value_and_grad(lambda p: m.loss(p, batch),
                                           params)
    assert float(out[True][0][0]) == float(out[False][0][0])
    for a, b in zip(tree_leaves(out[True][1]), tree_leaves(out[False][1])):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-9)


# ------------------------------------------------------------- train step
@pytest.mark.parametrize("state", ["float32", "bfloat16"])
def test_train_step_matches_make_train_bundle(state):
    """Three steps of the port's step and JAX's bundle's on the same
    batches, fp32 compute.  Δp is held in a relative norm, not element
    by element: Adam turns a near-zero gradient whose sign differs with
    summation order into a full ±lr step."""
    name = "repro-100m"
    jm, jp, tm, tp = _pair(name, dtype="float32")
    cfg = tm.cfg
    bundle = make_train_bundle(jm.cfg, InputShape("t", 64, 2, "train"),
                               make_local_mesh(1), RULE_SETS["default"],
                               opt_state_dtype=getattr(jnp, state))
    jstep = jax.jit(bundle.fn)
    tstep = tsteps.make_train_step(cfg,
                                   opt_state_dtype=getattr(torch, state))
    from repro.optim import adamw as jadamw
    from repro_torch.optim import adamw as tadamw
    js = jadamw(3e-4, weight_decay=0.1,
                state_dtype=getattr(jnp, state)).init(jp)
    ts = tadamw(3e-4, weight_decay=0.1,
                state_dtype=getattr(torch, state)).init(tp)
    for i in range(3):
        batch = _batch(cfg.vocab_size, 2, 64, seed=10 + i)
        jprev, tprev = _leaves_np(jp), _leaves_np(tp)
        jp, js, jl, _ = jstep(jp, js, {k: jnp.asarray(v)
                                       for k, v in batch.items()})
        tp, ts, tl, _ = tstep(tp, ts, _tb(batch))
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
        for a0, a1, b0, b1 in zip(tprev, _leaves_np(tp), jprev,
                                  _leaves_np(jp)):
            dj = b1 - b0
            assert np.linalg.norm((a1 - a0) - dj) \
                <= 1e-3 * np.linalg.norm(dj)
    assert int(ts["step"]) == 3 and ts["m"]["embedding"].dtype == \
        getattr(torch, state)


# ------------------------------------------------------------- chunk 128
def _decode_xent(jm, jp, tokens, labels):
    """The mean next-token CE in numpy from JAX's ``decode_step`` logits,
    one token at a time from an empty cache (float64 log-softmax)."""
    b, s = tokens.shape
    cache = jm.init_cache(b, s)
    step = jax.jit(jm.decode_step)
    nll = []
    for t in range(s):
        logits, cache = step(jp, cache, {
            "token": jnp.asarray(tokens[:, t:t + 1]),
            "pos": jnp.full((b,), t, jnp.int32)})
        lg = np.asarray(logits[:, 0], np.float64)
        m = lg.max(-1, keepdims=True)
        logz = (m + np.log(np.exp(lg - m).sum(-1, keepdims=True)))[:, 0]
        nll.append(logz - lg[np.arange(b), labels[:, t]])
    return float(np.mean(nll))


@pytest.mark.parametrize("name,d_model,ssm", [
    ("rwkv6-1.6b", 256, dict(chunk=128)),            # 4 heads of 64
    ("zamba2-7b", 256, dict(chunk=128, state_dim=64, head_dim=64))])
def test_chunk128_jax_loss_overflows_port_matches_decode(name, d_model, ssm):
    """At the families' own chunk of 128 and JAX's init decay, JAX's
    chunked form passes fp32's range and its loss is non-finite (the
    oracle's fault, kept on record); the port's loss is finite and
    equals the CE of JAX's decode recurrence over the same 256 tokens."""
    cfg = jget_config(name).reduced(num_layers=2, d_model=d_model)
    jm, jp, tm, tp = _pair(name, d_model=d_model, dtype="float32",
                           ssm=dataclasses.replace(cfg.ssm, **ssm))
    batch = _batch(tm.cfg.vocab_size, 1, 256, seed=3)
    jl, _ = jm.loss(jp, {k: jnp.asarray(v) for k, v in batch.items()})
    assert not np.isfinite(float(jl))
    with torch.no_grad():
        tl, _ = tm.loss(tp, _tb(batch))
    assert np.isfinite(float(tl))
    ref = _decode_xent(jm, jp, batch["tokens"], batch["labels"])
    assert abs(float(tl) - ref) <= 1e-4


# ------------------------------------------------------- kernel route, CPU
def test_kernel_attention_route_on_cpu_trains_through_the_plain_version():
    """CPU tensors that require grad take the flash kernel's plain
    version, which is differentiable: the loss and gradients equal the
    dot route's.  (A CUDA input that requires grad raises; the card
    tests and chip_smoke.py pin that.)"""
    cfg = dataclasses.replace(
        tconfigs.get_config("repro-100m").reduced(num_layers=2,
                                                  d_model=128),
        dtype="float32")
    params = build_model(cfg).init(torch.Generator().manual_seed(1), "cpu")
    batch = _tb(_batch(cfg.vocab_size, 2, 80, seed=4))      # window 64
    out = {}
    for impl in ("kernel", "dot"):
        m = build_model(dataclasses.replace(cfg, attention_impl=impl))
        out[impl] = tsteps.value_and_grad(lambda p: m.loss(p, batch), params)
    np.testing.assert_allclose(float(out["kernel"][0][0]),
                               float(out["dot"][0][0]), rtol=1e-6)
    for a, b in zip(tree_leaves(out["kernel"][1]), tree_leaves(out["dot"][1])):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7)


# --------------------------------------------------------- the entry point
def test_train_cli_runs_and_restores_parameters_only(tmp_path, capsys):
    ckpt = str(tmp_path / "ckpt")
    argv = ["--smoke", "--batch", "2", "--seq", "64", "--device", "cpu",
            "--ckpt-dir", ckpt, "--ckpt-every", "2", "--log-every", "1"]
    first = ttrain.main(argv + ["--steps", "4"])
    assert sorted(first["losses"]) == [1, 2, 3, 4]
    assert all(np.isfinite(v) for v in first["losses"].values())
    assert first["restored"] is None and first["cfg"].remat is False
    from repro_torch.checkpoint import available_steps, load_arrays
    assert available_steps(ckpt) == [2, 4]
    second = ttrain.main(argv + ["--steps", "6"])
    out = capsys.readouterr().out
    assert f"[train] restored step 4 from {ckpt}" in out
    assert sorted(second["losses"]) == [5, 6]
    _, saved = load_arrays(ckpt, 4)
    from repro_torch.checkpoint.store import flatten_tree
    restored = flatten_tree(second["restored"])
    assert sorted(restored) == sorted(saved)
    for k, v in restored.items():                      # bit for bit
        np.testing.assert_array_equal(v.numpy(), saved[k])
    # the moments restart at zero: two steps from step 4's restore
    assert int(second["opt_state"]["step"]) == 2
    # the restored run's step 5 equals one step of a fresh state
    step = tsteps.make_train_step(second["cfg"],
                                  opt_state_dtype=torch.float32)
    from repro_torch.data import LMStream, LMStreamConfig
    from repro_torch.optim import adamw
    stream = LMStream(LMStreamConfig(vocab_size=1024, topic_vocab=1024))
    toks, labs = stream.sample(2, 64, seed=5)
    _, _, loss5, _ = step(second["restored"],
                          adamw(3e-4, weight_decay=0.1).init(
                              second["restored"]),
                          _tb({"tokens": toks, "labels": labs}))
    assert float(loss5) == pytest.approx(second["losses"][5], abs=1e-4)


def test_train_cli_takes_the_moe_aux_loss(capsys):
    """``launch.train --arch grok-1-314b --smoke``: the MoE family trains
    through the same step, its logged loss ce + aux."""
    run = ttrain.main(["--arch", "grok-1-314b", "--smoke", "--batch", "2",
                       "--seq", "32", "--steps", "3", "--log-every", "1",
                       "--device", "cpu"])
    assert run["cfg"].moe is not None
    assert sorted(run["losses"]) == [1, 2, 3]
    assert all(np.isfinite(v) for v in run["losses"].values())
    assert "grok-1-314b-smoke" in capsys.readouterr().out
