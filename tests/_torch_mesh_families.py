"""What ``tests/test_torch_mesh_ssm.py`` and ``tests/test_torch_mesh_moe.py``
share: each runs two families' prefill, decode and train steps on
('data', 'model') meshes of four ``gloo`` ranks
(``_torch_mesh_ranks.families_on_meshes``), the same calls in one
process, and JAX's jitted (2, 2) bundles in a subprocess of four forced
host devices, all on JAX's weights at ``reduced()`` in fp32."""
import dataclasses
import os
import pickle
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import torch

from repro.configs import get_config as jget_config
from repro.models.api import build_model as jbuild_model
from repro_torch import convert
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import steps as tsteps
from repro_torch.models.api import build_model
from repro_torch.optim import adamw

sys.path.insert(0, str(Path(__file__).resolve().parent))
import _torch_mesh_ranks as ranks  # noqa: E402

# fp32 on every mesh: the same function, its sums split over the ranks
F32 = dict(atol=1e-5, rtol=1e-5)
# against JAX's (2, 2) bundles: tests/test_torch_lm.py's bar
JAX_LM = dict(atol=1e-4, rtol=1e-4)
LOSS_RTOL = 1e-5
# the loss's gradients, mesh against one process.  A leaf that is cast
# to bf16 at use (rwkv6's and mamba's projections, whatever cfg.dtype;
# tests/test_torch_train.py) has a bf16 gradient: one process rounds the
# whole batch's sum once, a mesh that splits the batch rounds each
# rank's partial sum and adds them, so those leaves are held in norm
# (observed <= 3.4e-3 on (2, 2), 3.2e-4 on (1, 4)); every other leaf to
# GRAD_REL of its largest element (observed <= 3.5e-6 of it), except
# rwkv6's, which lie downstream of its receptance gate's bf16 rounding
# (tests/test_torch_train.py), held in norm and to RWKV_MAX of the
# largest element (observed <= 2.4e-3 and 2.0e-3 on (2, 2))
MESH_BF16_LEAF_FRO = 5e-3
GRAD_REL, GRAD_ABS = 1e-4, 1e-7
RWKV_FRO, RWKV_MAX = 5e-3, 5e-3
B, S, DECODE, N_TRAIN = 4, 40, 3, 2
SPAWN_S = 240                     # a hard limit on each world of ranks

JAX_SCRIPT = r"""
import os, pickle, sys
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=4")
import dataclasses
import jax, jax.numpy as jnp, numpy as np
from repro.configs import get_config
from repro.configs.base import InputShape
from repro.launch.mesh import make_local_mesh
from repro.launch.steps import (make_decode_bundle, make_prefill_bundle,
                                make_train_bundle)
from repro.models.api import build_model
from repro.nn.layers import NO_SHARD
from repro.nn.sharding import RULE_SETS
from repro.optim import adamw

inp = pickle.load(open(sys.argv[1], "rb"))
mesh, rules = make_local_mesh(2), RULE_SETS["default"]
tree = lambda t: jax.tree_util.tree_map(jnp.asarray, t)
# each call takes host arrays: under jax 0.9 a jit's outputs are typed as
# sharded on ('data', 'model'), and fed back they make the embedding's
# gather and the cache's scatter ambiguous to the partitioner
host = lambda t: jax.tree_util.tree_map(np.asarray, t)
jit = lambda bd: jax.jit(bd.fn, in_shardings=bd.in_shardings,
                         out_shardings=bd.out_shardings)
out = {"mesh": dict(mesh.shape)}
with mesh:
    for name in inp["names"]:
        cfg = dataclasses.replace(get_config(name).reduced(),
                                  dtype="float32")
        model, fam, params = build_model(cfg), inp[name], tree(
            inp["trees"][name])
        prompt = fam["prompt"]
        b, s = prompt.shape
        batch = {"tokens": jnp.asarray(prompt)}
        if cfg.encdec is not None:
            batch["src_embeds"] = jnp.asarray(fam["src"])
        r = {}
        f = jit(make_prefill_bundle(cfg, InputShape("t", s, b, "prefill"),
                                    mesh, rules))
        r["prefill"] = np.asarray(f(params, batch))
        f = jit(make_decode_bundle(cfg, InputShape("t", s, b, "decode"),
                                   mesh, rules))
        cache = host(model.init_cache(b, s))
        if cfg.encdec is not None:
            cache["cross"] = host(model.build_cross_cache(
                params, model._encode(params, batch["src_embeds"],
                                      NO_SHARD)))
        logits = []
        for i in range(fam["decode"]):
            lg, cache = f(params, cache, {
                "token": jnp.asarray(prompt[:, i:i + 1]),
                "pos": jnp.full((b,), i, jnp.int32)})
            cache = host(cache)
            logits.append(np.asarray(lg))
        r["decode"] = np.stack(logits)
        f = jit(make_train_bundle(cfg, InputShape("t", s, b, "train"),
                                  mesh, rules, opt_state_dtype=jnp.float32))
        p = params
        st = adamw(3e-4, weight_decay=0.1, state_dtype=jnp.float32).init(p)
        r["train_losses"] = []
        for labels in fam["labels"]:
            p, st, loss, met = f(p, st, dict(batch,
                                             labels=jnp.asarray(labels)))
            p, st = host(p), host(st)
            r["train_losses"].append((float(loss), float(met["aux"])))
        out[name] = r
pickle.dump(out, open(sys.argv[2], "wb"))
"""


def f32_config(name):
    return ranks.f32_config(name, attention_impl="kernel")


def jax_tree(name, seed):
    cfg = dataclasses.replace(jget_config(name).reduced(), dtype="float32")
    return jax.tree_util.tree_map(
        np.asarray, jbuild_model(cfg).init(jax.random.PRNGKey(seed)))


def family_inputs(name, seed):
    """A prompt (B, S), N_TRAIN label batches and, for the
    encoder-decoder, its frames; for MoE the one-process routing of the
    prompt (``pins``) is added by ``single``."""
    cfg = f32_config(name)
    rng = np.random.default_rng(seed)
    inp = dict(prompt=rng.integers(0, cfg.vocab_size, (B, S)),
               labels=[rng.integers(0, cfg.vocab_size, (B, S))
                       for _ in range(N_TRAIN)], decode=DECODE)
    if cfg.encdec is not None:
        inp["src"] = rng.normal(size=(B, cfg.encdec.encoder_seq,
                                      cfg.d_model)).astype(np.float32)
    return inp


def single(name, tree, inp):
    """``ranks.family_steps``'s calls in one process, no mesh."""
    cfg = f32_config(name)
    model = build_model(cfg)
    params = convert.lm_params_from_jax(tree, "cpu")
    prompt = torch.as_tensor(inp["prompt"])
    batch = {"tokens": prompt}
    if cfg.encdec is not None:
        batch["src_embeds"] = torch.as_tensor(inp["src"])
    out = {"prefill": model.prefill(params, batch)}
    if cfg.moe is not None:
        out["routing"] = model.routing(params, batch)
        inp["pins"] = out["routing"].numpy()
        out["prefill_pinned"] = model.prefill(
            params, dict(batch, expert_ids=out["routing"]))
    cache = model.init_cache(B, S, device="cpu")
    if cfg.encdec is not None:
        cache["cross"] = model.build_cross_cache(
            params, model._encode(params, batch["src_embeds"]))
    out["decode"] = torch.stack([model.decode_step(params, cache, {
        "token": prompt[:, i:i + 1], "pos": torch.full((B,), i)})[0]
        for i in range(inp["decode"])])
    out["cache"] = cache
    tbatch = dict(batch, labels=torch.as_tensor(inp["labels"][0]))
    (loss, _), grads = tsteps.value_and_grad(
        lambda p: model.loss(p, tbatch), params)
    out["loss"], out["grads"] = float(loss), grads
    step = tsteps.make_train_step(cfg, opt_state_dtype=torch.float32)
    st = adamw(3e-4, weight_decay=0.1, state_dtype=torch.float32).init(params)
    p, out["train_losses"] = params, []
    for labels in inp["labels"]:
        p, st, loss, met = step(p, st, dict(batch,
                                            labels=torch.as_tensor(labels)))
        out["train_losses"].append((float(loss), float(met["aux"])))
    return out


# the meshes on which rank 0's count of each step is held to the fake
# process group's (test_rank0_count_equals_the_fake_groups)
COUNTED_MESHES = ((2, 2), (1, 4))


def start_child(args, tmp, name):
    """A Python child (``args`` after the interpreter) on the CPU, its
    output to ``tmp/name.log``."""
    log = open(tmp / f"{name}.log", "w")
    return subprocess.Popen([sys.executable, *args],
                            env=dict(os.environ, JAX_PLATFORMS="cpu"),
                            stdout=log, stderr=subprocess.STDOUT), log


def finish_child(proc_log, tmp, name):
    """Wait for a ``start_child`` child (``SPAWN_S`` at most) and load its
    pickled result ``tmp/name.pkl``."""
    proc, log = proc_log
    try:
        proc.wait(timeout=SPAWN_S)
    finally:
        proc.kill()
        log.close()
    assert proc.returncode == 0, (tmp / f"{name}.log").read_text()[-4000:]
    with open(tmp / f"{name}.pkl", "rb") as f:
        return pickle.load(f)


def start_fake_counts(jobs, tmp):
    """``ranks.fake_counts(jobs)`` in a child process (its process group
    lives and dies there)."""
    with open(tmp / "jobs.pkl", "wb") as f:
        pickle.dump(jobs, f)
    return start_child([ranks.__file__, str(tmp / "jobs.pkl"),
                        str(tmp / "fake.pkl")], tmp, "fake")


def family_jobs(runs, names, inputs, skip=()):
    """``ranks.fake_counts``'s jobs for ``family_steps``' counted calls
    on COUNTED_MESHES: {(name, shape, rules, kind): job}, the batch inputs
    in the dtypes the worlds feed (numpy's integers as int64)."""
    jobs = {}
    for shape, rules in runs:
        for name in names:
            if shape not in COUNTED_MESHES or (name, shape, rules) in skip:
                continue
            src = {"src_embeds": "float32"} if "src" in inputs[name] else {}
            for kind, dtypes in (
                    ("prefill", dict(tokens="int64", **src)),
                    ("decode", dict(token="int64", pos="int64")),
                    ("train", dict(tokens="int64", labels="int64", **src))):
                jobs[(name, shape, rules, kind)] = (
                    name, "kernel", kind, (B, S), shape, rules, dtypes)
    return jobs


def run_worlds(runs, names, trees, inputs, tmp, skip=()):
    """JAX's (2, 2) bundles (a subprocess of four forced host devices) and
    the fake process group's counts (``family_jobs``, a subprocess),
    started first, beside ``families_on_meshes`` on four gloo ranks, a
    world for each family on each (mesh, rules) of ``runs``: (the port's
    results on rank 0, each counted run's also under ``"fake_counts"``,
    JAX's).  A world a family and mesh keeps each world short on a loaded
    host: its ranks meet at every collective, and each meeting waits for
    the slowest rank's turn on the cores."""
    with open(tmp / "in.pkl", "wb") as f:
        pickle.dump(dict(inputs, names=names, trees=trees), f)
    jax_proc = start_child(["-c", JAX_SCRIPT, str(tmp / "in.pkl"),
                            str(tmp / "jax.pkl")], tmp, "jax")
    fake = start_fake_counts(family_jobs(runs, names, inputs, skip), tmp)
    try:
        port = {}
        for run in runs:
            for name in names:
                if (name, *run) in skip:
                    continue
                port.update(mesh_lib.launch(
                    ranks.families_on_meshes, 4, device_type="cpu",
                    timeout=SPAWN_S,
                    args=([run], [name], {name: trees[name]}, inputs))[0])
        jx = finish_child(jax_proc, tmp, "jax")
        counts = finish_child(fake, tmp, "fake")
    finally:
        jax_proc[0].kill()
        fake[0].kill()
    for (name, shape, rules, kind), c in counts.items():
        port[(name, shape, rules)].setdefault("fake_counts", {})[kind] = c
    return port, jx


def leaves(tree):
    """The tensors of nested dicts and tuples, in order, as float64
    numpy arrays."""
    return [np.asarray(t.double()) for t in ranks._leaves(tree)]


def assert_grads_close(got, ref, name):
    """Each gradient leaf of ``name`` on a mesh against one process's (see
    MESH_BF16_LEAF_FRO)."""
    for a, b in zip(leaves(got), leaves(ref)):
        assert a.shape == b.shape
        bf16_valued = np.array_equal(
            b, torch.as_tensor(b).to(torch.bfloat16).double().numpy())
        err, top = np.abs(a - b).max(), np.abs(b).max()
        fro = np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)
        if bf16_valued and b.size > 64:
            assert fro <= MESH_BF16_LEAF_FRO, (a.shape, fro)
        elif name == "rwkv6-1.6b":
            assert fro <= RWKV_FRO and err <= RWKV_MAX * top, \
                (a.shape, fro, err, top)
        else:
            assert err <= GRAD_REL * top + GRAD_ABS, (a.shape, err, top)


def mesh_id(run):
    (d, m), rules = run
    return f"{d}x{m}-{rules}"


def logits_placements(mesh):
    """('batch', None, 'vocab') on a (data, model) mesh."""
    return ["Shard(dim=0)" if mesh[0] > 1 else "Replicate()",
            "Shard(dim=2)" if mesh[1] > 1 else "Replicate()"]
