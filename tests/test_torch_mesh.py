"""The dense decoder's train, prefill and decode steps on a ('data',
'model') mesh of ``gloo`` ranks on the CPU (``launch.mesh.launch``,
DTensor parameters laid out by the default rules, ``launch.steps.on_mesh``)
held against one process and against JAX's jitted bundles on a (2, 2)
mesh of forced host devices; the flash op's sharding rule; the mesh
entry points (``launch.train --devices/--model-axis``, ``launch.serve``'s
data mesh); the launcher's failure and timeout; the shard-local
parameter draws.  Weights are JAX's, carried across by
``convert.lm_params_from_jax``.  The other families on a mesh:
``tests/test_torch_mesh_ssm.py`` and ``tests/test_torch_mesh_moe.py``."""
import dataclasses
import pickle
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models.api import build_model as jbuild_model
from repro_torch import convert
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import serve as tserve
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.models.api import build_model
from repro_torch.nn import param as P
from repro_torch.nn import sharding as shd
from repro_torch.nn.param import tree_leaves
from repro_torch.optim import adamw

sys.path.insert(0, str(Path(__file__).resolve().parent))
import _torch_mesh_families as fam  # noqa: E402
import _torch_mesh_ranks as ranks  # noqa: E402

torch.set_num_threads(2)

# fp32 on every mesh: the same function, its sums split over the ranks
F32 = dict(atol=1e-5, rtol=1e-5)
# against JAX's (2, 2) bundles: tests/test_torch_lm.py's and
# tests/test_torch_train.py's bars
JAX_LM = dict(atol=1e-4, rtol=1e-4)
LOSS_RTOL = 1e-5
DELTA_REL = 1e-3                  # ||dp_mesh - dp_ref|| <= this * ||dp_ref||
# the train CLI's default bf16 compute: the ranks' split sums round
# elsewhere (observed <= 4.1e-4 on these steps)
BF16_LOSS_ATOL = 2e-3
MESHES = [(2, 2), (1, 4), (4, 1)]
B, S, DECODE, GEN, GEN_PROMPT = 4, 32, 6, 5, 3
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
from repro.nn.sharding import RULE_SETS
from repro.optim import adamw

inp = pickle.load(open(sys.argv[1], "rb"))
mesh, rules = make_local_mesh(2), RULE_SETS["default"]
cfg = lambda n: dataclasses.replace(get_config(n).reduced(), dtype="float32")
tree = lambda t: jax.tree_util.tree_map(jnp.asarray, t)
# each call takes host arrays: under jax 0.9 a jit's outputs are typed as
# sharded on ('data', 'model'), and fed back they make the embedding's
# gather and the cache's scatter ambiguous to the partitioner
host = lambda t: jax.tree_util.tree_map(np.asarray, t)
jit = lambda bd: jax.jit(bd.fn, in_shardings=bd.in_shardings,
                         out_shardings=bd.out_shardings)
out = {"mesh": dict(mesh.shape)}
with mesh:
    lc, prompt = cfg("llama3.2-1b"), inp["prompt"]
    b, s = prompt.shape
    f = jit(make_prefill_bundle(lc, InputShape("t", s, b, "prefill"), mesh,
                                rules))
    params = tree(inp["llama"])
    out["prefill"] = np.asarray(f(params, {"tokens": jnp.asarray(prompt)}))
    f = jit(make_decode_bundle(lc, InputShape("t", s + inp["gen"], b,
                                              "decode"), mesh, rules))
    cache, logits = build_model(lc).init_cache(b, s + inp["gen"]), []
    for i in range(inp["decode"]):
        lg, cache = f(params, cache, {"token": jnp.asarray(prompt[:, i:i + 1]),
                                      "pos": jnp.full((b,), i, jnp.int32)})
        cache = host(cache)
        logits.append(np.asarray(lg))
    out["decode"] = np.stack(logits)
    rc, batches = cfg("repro-100m"), inp["train"]
    f = jit(make_train_bundle(rc, InputShape(
        "t", batches[0]["tokens"].shape[1], batches[0]["tokens"].shape[0],
        "train"), mesh, rules, opt_state_dtype=jnp.float32))
    p = tree(inp["repro"])
    st = adamw(3e-4, weight_decay=0.1, state_dtype=jnp.float32).init(p)
    out["train_losses"] = []
    for bt in batches:
        p, st, loss, _ = f(p, st, tree(bt))
        p, st = host(p), host(st)
        out["train_losses"].append(float(loss))
    out["train_params"] = jax.tree_util.tree_map(np.asarray, p)
pickle.dump(out, open(sys.argv[2], "wb"))
"""


def _jax_params(name, seed):
    cfg = dataclasses.replace(jget_config(name).reduced(), dtype="float32")
    return jax.tree_util.tree_map(
        np.asarray, jbuild_model(cfg).init(jax.random.PRNGKey(seed)))


def _train_batches(vocab, seed=10):
    r = np.random.default_rng(seed)
    return [{k: r.integers(0, vocab, (B, S)).astype(np.int32)
             for k in ("tokens", "labels")} for _ in range(3)]


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    llama, repro = _jax_params("llama3.2-1b", 0), _jax_params("repro-100m", 1)
    cfg = ranks.f32_config("llama3.2-1b")
    return dict(llama=llama, repro=repro,
                prompt=rng.integers(0, cfg.vocab_size, (B, S)),
                train=_train_batches(ranks.f32_config("repro-100m")
                                     .vocab_size),
                decode=DECODE, gen=GEN)


def _fake_jobs():
    """``ranks.fake_counts``'s jobs for ``lm_steps``' counted calls on
    the counted meshes, the batch inputs in the dtypes the world feeds."""
    jobs = {}
    for mesh in fam.COUNTED_MESHES:
        for route in ("dot", "kernel"):
            jobs[(mesh, f"prefill_{route}")] = (
                "llama3.2-1b", route, "prefill", (B, S), mesh, "default",
                {"tokens": "int64"})
        jobs[(mesh, "decode")] = (
            "llama3.2-1b", None, "decode", (B, S + GEN), mesh, "default",
            {"token": "int64", "pos": "int64"})
        jobs[(mesh, "train")] = (
            "repro-100m", None, "train", (B, S), mesh, "default",
            {"tokens": "int32", "labels": "int32"})
    return jobs


@pytest.fixture(scope="module")
def runs(inputs, tmp_path_factory):
    """JAX's (2, 2) run (a subprocess of four forced host devices) and the
    fake process group's counts (``_fake_jobs``, a subprocess), started
    first, beside the port's run on each mesh of MESHES (a world of four
    gloo ranks each, as ``_torch_mesh_families.run_worlds`` runs them);
    each counted mesh's fake counts under ``"fake_counts"``."""
    tmp = tmp_path_factory.mktemp("mesh")
    with open(tmp / "in.pkl", "wb") as f:
        pickle.dump(inputs, f)
    jax_proc = fam.start_child(["-c", JAX_SCRIPT, str(tmp / "in.pkl"),
                                str(tmp / "jax.pkl")], tmp, "jax")
    fake = fam.start_fake_counts(_fake_jobs(), tmp)
    try:
        port = {}
        for mesh in MESHES:
            port.update(mesh_lib.launch(
                ranks.lm_steps_on_meshes, 4, device_type="cpu",
                timeout=SPAWN_S,
                args=([mesh], inputs["llama"], inputs["repro"],
                      inputs["prompt"], DECODE, inputs["train"], GEN,
                      GEN_PROMPT))[0])
        jx = fam.finish_child(jax_proc, tmp, "jax")
        counts = fam.finish_child(fake, tmp, "fake")
    finally:
        jax_proc[0].kill()
        fake[0].kill()
    for (mesh, kind), c in counts.items():
        port[mesh].setdefault("fake_counts", {})[kind] = c
    return port, jx


@pytest.fixture(scope="module")
def single(inputs):
    """The same calls in one process, no mesh."""
    cfg = ranks.f32_config("llama3.2-1b")
    params = convert.lm_params_from_jax(inputs["llama"], "cpu")
    prompt = torch.as_tensor(inputs["prompt"])
    out = {}
    for route in ("dot", "kernel"):
        out[f"prefill_{route}"] = build_model(dataclasses.replace(
            cfg, attention_impl=route)).prefill(params, {"tokens": prompt})
    model = build_model(cfg)
    cache = model.init_cache(B, S + GEN, device="cpu")
    out["decode"] = torch.stack([model.decode_step(params, cache, {
        "token": prompt[:, i:i + 1], "pos": torch.full((B,), i)})[0]
        for i in range(DECODE)])
    out["cache"] = cache
    out["generate"] = tserve.generate(model, params, prompt[:, :GEN_PROMPT],
                                      GEN, S + GEN)
    rcfg = ranks.f32_config("repro-100m")
    p = convert.lm_params_from_jax(inputs["repro"], "cpu")
    step = tsteps.make_train_step(rcfg, opt_state_dtype=torch.float32)
    st = adamw(3e-4, weight_decay=0.1, state_dtype=torch.float32).init(p)
    out["train_losses"] = []
    for bt in inputs["train"]:
        p, st, loss, _ = step(p, st, {k: torch.as_tensor(v)
                                      for k, v in bt.items()})
        out["train_losses"].append(float(loss))
    out["train_params"] = p
    return out


def _delta_apart(got, ref, init):
    """The largest leaf's ||(got - init) - (ref - init)|| / ||ref - init||."""
    return max(float(np.linalg.norm((g - p0) - (r - p0))
                     / np.linalg.norm(r - p0))
               for g, r, p0 in zip(got, ref, init))


def _np_leaves(tree):
    return [np.asarray(t, np.float64) for t in tree_leaves(
        convert.lm_params_to_numpy(tree) if isinstance(
            tree_leaves(tree)[0], torch.Tensor) else tree)]


# ------------------------------------- rank 0's count vs a fake group's
@pytest.mark.parametrize("kind", ["prefill_dot", "prefill_kernel", "decode",
                                  "train"])
@pytest.mark.parametrize("mesh", fam.COUNTED_MESHES,
                         ids=lambda m: f"{m[0]}x{m[1]}")
def test_rank0_count_equals_the_fake_groups(runs, mesh, kind):
    """Rank 0's count of each step's first call in the live world
    (``launch.hlo.StepCounter`` around ``bundle.fn``) equals the count of
    the same step on a ``"fake"`` process group of four ranks over
    ``meta`` shards (``launch.dryrun.rank0_count``), exactly: FLOPs,
    bytes, each collective's count and bytes.  Both take the same route:
    the flash op (its CPU implementation in the world, its fake on
    ``meta``) on the prefill's kernel route and the decode, counted by
    its formula at the local shapes its sharding rule gives; the plain
    attention on the train step, whose inputs require grad."""
    got = runs[0][mesh]
    assert got["fake_counts"][kind] == got["counts"][kind]
    assert got["counts"][kind]["per_collective"], "no collective counted"


# ------------------------------------------------------- each mesh vs one
@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_mesh_shape_and_local_shards(runs, mesh):
    got = runs[0][mesh]
    assert got["mesh"] == {"data": mesh[0], "model": mesh[1]}
    # params (two routes), the decode cache, the train params: each
    # rank's local shard has NamedSharding.shard_shape's shape
    assert got["shard_shapes_ok"] == [True] * 4


@pytest.mark.parametrize("route", ["dot", "kernel"])
@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_prefill_on_mesh_matches_one_process(runs, single, mesh, route):
    got = runs[0][mesh]
    np.testing.assert_allclose(got[f"prefill_{route}"].numpy(),
                               single[f"prefill_{route}"].numpy(), **F32)
    # the logits come out as JAX constrains them: ('batch', None, 'vocab')
    want = ["Shard(dim=0)" if mesh[0] > 1 else "Replicate()",
            "Shard(dim=2)" if mesh[1] > 1 else "Replicate()"]
    assert got[f"prefill_{route}_placements"] == want


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_decode_on_mesh_matches_one_process(runs, single, mesh):
    got = runs[0][mesh]
    np.testing.assert_allclose(got["decode"].numpy(),
                               single["decode"].numpy(), **F32)
    assert torch.equal(got["decode"].argmax(-1), single["decode"].argmax(-1))
    # the sharded cache was written in place, each rank its own rows
    assert got["cache_in_place"]
    for k in ("k", "v"):
        np.testing.assert_allclose(got["cache"][k].numpy(),
                                   single["cache"][k].numpy(), **F32)
    assert torch.equal(got["generate"], single["generate"])


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_train_steps_on_mesh_match_one_process(runs, single, inputs, mesh):
    got = runs[0][mesh]
    np.testing.assert_allclose(got["train_losses"], single["train_losses"],
                               rtol=LOSS_RTOL)
    assert got["train_step"] == 3
    assert _delta_apart(_np_leaves(got["train_params"]),
                        _np_leaves(single["train_params"]),
                        _np_leaves(inputs["repro"])) <= DELTA_REL


# ------------------------------------------------- (2, 2) against JAX's
def test_prefill_and_decode_match_jax_mesh_bundles(runs):
    port, jx = runs
    assert jx["mesh"] == {"data": 2, "model": 2}
    np.testing.assert_allclose(port[(2, 2)]["prefill_kernel"].numpy(),
                               jx["prefill"], **JAX_LM)
    np.testing.assert_allclose(port[(2, 2)]["prefill_dot"].numpy(),
                               jx["prefill"], **JAX_LM)
    np.testing.assert_allclose(port[(2, 2)]["decode"].numpy(),
                               jx["decode"], **JAX_LM)


def test_train_steps_match_jax_mesh_bundle(runs, inputs):
    port, jx = runs
    np.testing.assert_allclose(port[(2, 2)]["train_losses"],
                               jx["train_losses"], rtol=LOSS_RTOL)
    assert _delta_apart(_np_leaves(port[(2, 2)]["train_params"]),
                        _np_leaves(jx["train_params"]),
                        _np_leaves(inputs["repro"])) <= DELTA_REL


# ------------------------------------------------- the flash sharding rule
@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_flash_rule_keeps_each_query_head_on_its_kv_head(runs, mesh):
    """q, k, v laid out as the rules lay them out (heads and kv heads on
    'model' where they divide it).  GQA 8/2 on four devices: the kv heads
    do not divide every split the mesh can make, and on (1, 4) a local
    query head would read the wrong kv head; the rule offers no head
    split (DTensor gathers the heads, or may split the batch over
    'model').  MQA 8/1 (K/V replicated) and GQA 8/4 keep their heads
    split.  Every layout equals the plain version."""
    from repro_torch.kernels.flash_attention.ops import heads_split_ok
    got = runs[0][mesh]["flash"]
    for (h, kv), r in got.items():
        assert r["err"] <= 1e-5, (h, kv, r)
        assert r["placements"][0] == "Shard(dim=0)", r      # batch on data
        if mesh[1] > 1 and heads_split_ok(h, kv, 4):
            assert r["placements"][1] == "Shard(dim=2)", (h, kv, r)
        elif mesh[1] > 1:       # gathered heads, or the batch split
            assert r["placements"][1] != "Shard(dim=2)", (h, kv, r)
    if mesh == (1, 4):      # the layout the rule must not run as it is
        assert got[(8, 2)]["inputs"][0] == ["Shard(dim=0)", "Shard(dim=2)"]
        assert got[(8, 2)]["inputs"][1] == ["Shard(dim=0)", "Replicate()"]


@pytest.mark.parametrize("mesh", MESHES)
def test_decode_attention_reads_each_rank_s_kv_heads(runs, mesh):
    """A decode query laid out on its rows and heads reads from a cache
    whose kv heads are split (GQA 8/2 and 8/4 where they divide 'model')
    or replicated (MQA 8/1; 8/2 on a 'model' axis of 4) only the kv heads
    its own query heads use: the repeated K on each rank holds its rows
    and H/m heads, equal to the plain repeat; the attention and the
    cache's gradient (a partial sum over the ranks that split the heads,
    where the cache is replicated) equal the plain tensors'."""
    got = runs[0][mesh]["decode_gqa"]
    for (h, kv), r in got.items():
        assert r["repeat_err"] == 0.0, (h, kv, r)
        assert r["local_k"] == (4 // mesh[0], 12, h // mesh[1], 16), r
        assert r["err"] <= 1e-5 and r["grad_err"] <= 1e-5, (h, kv, r)
    if mesh[1] > 1:     # the slice of a replicated cache is exercised
        assert got[(8, 1)]["cache"][1] == "Replicate()"


@pytest.mark.parametrize("h,kv,split,ok", [
    (32, 8, 2, True), (32, 8, 4, True), (48, 1, 4, True), (8, 2, 4, False),
    (6, 3, 2, False), (6, 2, 4, False), (4, 4, 4, True)])
def test_heads_split_ok(h, kv, split, ok):
    from repro_torch.kernels.flash_attention.ops import heads_split_ok
    assert heads_split_ok(h, kv, split) is ok


# ------------------------------------------------- entry points
def test_train_cli_on_meshes(capfd, tmp_path):
    """``--devices 4 --model-axis 2`` gives a one-device run's losses (the
    same weights: a CPU mesh draws as one process does; bf16 compute
    summed in another order); its checkpoint holds full tensors, so
    ``--devices 4 --model-axis 3`` restores it on the mesh JAX's
    remainder rule leaves, (1, 3) on three ranks."""
    ckpt = str(tmp_path / "ckpt")
    argv = ["--smoke", "--batch", "4", "--seq", "32", "--log-every", "1",
            "--device", "cpu", "--ckpt-every", "2"]
    one = ttrain.main(argv + ["--steps", "2", "--devices", "1"])
    four = ttrain.main(argv + ["--steps", "2", "--devices", "4",
                               "--model-axis", "2", "--ckpt-dir", ckpt])
    assert "mesh {'data': 2, 'model': 2}" in capfd.readouterr().out
    assert sorted(four["losses"]) == [1, 2]
    assert four["losses"][1] == pytest.approx(one["losses"][1], abs=1e-4)
    np.testing.assert_allclose(four["losses"][2], one["losses"][2],
                               atol=BF16_LOSS_ATOL)
    assert int(four["opt_state"]["step"]) == 2
    three = ttrain.main(argv + ["--steps", "3", "--devices", "4",
                                "--model-axis", "3", "--ckpt-dir", ckpt])
    out = capfd.readouterr().out
    assert "mesh {'data': 1, 'model': 3}" in out
    assert f"restored step 2 from {ckpt}" in out
    assert sorted(three["losses"]) == [3]
    for a, b in zip(tree_leaves(three["restored"]),
                    tree_leaves(four["params"])):
        assert torch.equal(a, b)


def test_mesh_shape_follows_jax_remainder_rule():
    with pytest.raises(RuntimeError, match="model_axis=5 needs 5 devices"):
        mesh_lib.mesh_shape(4, 5)
    assert mesh_lib.mesh_shape(4, 3) == (1, 3)
    assert mesh_lib.mesh_shape(8, 3) == (2, 3)
    assert mesh_lib.mesh_shape(4) == (4, 1)
    assert mesh_lib.mesh_shape(1, None) == (1, 1)


def test_serve_cli_on_a_data_mesh(capfd):
    toks = tserve.main(["--arch", "llama3.2-1b", "--smoke", "--batch", "4",
                        "--prompt-len", "8", "--gen", "4", "--devices", "2",
                        "--device", "cpu"])
    assert toks.shape == (4, 4) and ((toks >= 0) & (toks < 1024)).all()
    assert "mesh {'data': 2, 'model': 1}" in capfd.readouterr().out


# ------------------------------------------------- the launcher
def test_launch_raises_with_the_failing_ranks_traceback():
    with pytest.raises(RuntimeError, match="rank 1 fails on purpose"):
        mesh_lib.launch(ranks.fail_on_rank, 2, device_type="cpu",
                        args=(1,), timeout=SPAWN_S)


def test_launch_kills_ranks_past_its_timeout():
    with pytest.raises(RuntimeError, match="did not finish within 3 s"):
        mesh_lib.launch(ranks.hang, 2, device_type="cpu", timeout=3)


# ------------------------------------------------- shard-local draws
@pytest.mark.parametrize("shape,spec", [
    ((6, 64, 40), shd.PartitionSpec(None, "data", "model")),
    ((96, 48), shd.PartitionSpec("model", "data")),
    ((40,), shd.PartitionSpec("data")),
    ((12, 8, 10), shd.PartitionSpec(("data", "model")))])
def test_draw_shard_does_not_depend_on_the_split(shape, spec, monkeypatch):
    """Each (2, 2) device's block, drawn alone, equals that block of the
    whole leaf drawn at once, across chunk edges."""
    monkeypatch.setattr(P, "DRAW_CHUNK", 700)    # several chunks a leaf
    leaf = P.ParamSpec(shape, (None,) * len(shape), init="normal",
                       scale=2.0)
    whole = P.draw_shard(leaf, 7, "/w", [(0, n) for n in shape], "cpu")
    sizes = {"data": 2, "model": 2}
    for d in range(2):
        for m in range(2):
            bounds = P.shard_bounds(shape, spec, sizes,
                                    {"data": d, "model": m})
            block = P.draw_shard(leaf, 7, "/w", bounds, "cpu")
            assert torch.equal(block, whole[tuple(slice(a, b)
                                                  for a, b in bounds)])
    assert float(whole.std()) == pytest.approx(
        2.0 / np.sqrt(np.prod(shape[:-1])), rel=0.2)
