"""The sharded device pool on the port (``repro_torch.sim.shard``: the
mesh, the per-shard ops, ``ShardedPool``) against the port's
``LocalPool`` and against ``repro.sim``; ``alpha_combine_slab`` against
JAX's (the Pallas kernel in interpret mode); ``--mesh`` through the
port's CLI; the autotuner's mesh search and the replay CLI's ``--mesh``
against the reference's numpy results.

Meshes of more than one shard are emulated on the CPU
(``emulate=True``), the counterpart of JAX's
``--xla_force_host_platform_device_count``.

Tolerances: the per-shard ops equal the local ones where the lanes are
computed alone (training, Algorithm 1, accuracies); the transfer, whose
k slabs of T/k targets may sum in another order than one (S, T) call,
within rtol/atol 1e-6.  Whole runs: every decision field equal, floats
within rtol 1e-6 / atol 1e-7 (NaN equal to NaN), against the port's
``LocalPool`` run and against a live reference run on the reference's
draws (``JaxSimDraws``).  The reference is run at mesh 1 for the sync
scenario; its async executor cannot run sharded under jax 0.9.0 (the
gossip exchange's ``.at[d].set`` on a mesh-sharded leaf raises
``ShardingTypeError``, the fault behind ``tests/test_sim_resume.py``'s
known sharded failure), so the async runs are held against the
reference's ``LocalPool`` run, which its sharded pool claims to
reproduce bit for bit."""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_draws import JaxSimDraws
from test_torch_sim_engine import SMALL, assert_rows_match
from repro.kernels.alpha_combine.ops import \
    alpha_combine_slab as jax_alpha_combine_slab
from repro.sim.engine import SimConfig as JSimConfig
from repro.sim.engine import SimulationEngine as JSimulationEngine
from repro.sim.metrics import NONDETERMINISTIC_FIELDS
from repro.sim.trace import model as jmodel
from repro.sim.trace import replay as jreplay
from repro.sim.trace import tune as jtune
from repro_torch.kernels.alpha_combine import ops as ac
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.rng import generator
from repro_torch.sim import SimConfig, SimulationEngine
from repro_torch.sim import run as trun
from repro_torch.sim.shard import (DEVICE_AXIS, LocalPool, ShardedPool,
                                   make_pool, make_pool_mesh)
from repro_torch.sim.trace import model, replay, tune

torch.set_num_threads(2)          # six test workers share the box

TINY = dict(scenario="static", devices=5, rounds=1, samples_per_device=20,
            train_iters=4, div_tau=1, div_T=4, batch=5, solver_max_outer=2,
            solver_inner_steps=100)
FLOAT_FIELDS = ("drift", "mean_target_acc", "mean_source_acc", "energy",
                "energy_cum", "link_churn")


def _engine(mesh=0, **kw):
    return SimulationEngine(SimConfig(**{**TINY, **kw}, mesh=mesh),
                            device="cpu", emulate=mesh > 1)


# ------------------------------------------------------------------ mesh
@pytest.mark.parametrize("case", ["single", "oversubscribed", "zero",
                                  "emulated"])
def test_make_pool_mesh(case):
    cpu = torch.device("cpu")
    if case == "single":
        mesh = make_pool_mesh(1, "cpu")
        assert mesh.shape == {DEVICE_AXIS: 1}
        assert mesh.axis_names == (DEVICE_AXIS,)
        assert mesh.devices == (cpu,)
    elif case == "oversubscribed":
        with pytest.raises(RuntimeError, match="emulate=True"):
            make_pool_mesh(3, "cpu")
    elif case == "zero":
        with pytest.raises(ValueError, match="n_shards"):
            make_pool_mesh(0, "cpu")
    else:
        mesh = make_pool_mesh(4, "cpu", emulate=True)
        assert mesh.shape[DEVICE_AXIS] == 4 and mesh.devices == (cpu,) * 4
    # the local-mesh factory: a 1-D mesh over the devices it is given
    m = make_local_mesh([cpu] * 3, "a")
    assert m.shape == {"a": 3} and m.axis_names == ("a",) \
        and m.devices == (cpu,) * 3


@pytest.mark.parametrize("mesh,emulate,cls,name", [
    (0, False, LocalPool, "local"), (1, False, ShardedPool, "sharded-1"),
    (3, True, ShardedPool, "sharded-3")])
def test_make_pool_picks_the_backend(mesh, emulate, cls, name):
    eng = SimulationEngine(SimConfig(**TINY, mesh=mesh), device="cpu",
                           emulate=emulate)
    assert type(eng.pool) is cls and eng.pool.name == name
    assert type(make_pool(eng, emulate=emulate)) is cls
    if mesh == 0:
        with pytest.raises(ValueError, match="cfg.mesh is 0"):
            make_pool(eng, emulate=True)
    else:
        assert eng.pool.n_shards == mesh
    if mesh == 3:      # no emulation unless asked for
        with pytest.raises(RuntimeError, match="emulate"):
            SimulationEngine(SimConfig(**TINY, mesh=3), device="cpu")


def test_padding_helpers():
    """Pool 5 over 4 shards pads to 8: arrays edge-replicated, masks
    zero, blocks of 2 (the last shard owns only padding)."""
    pool = _engine(mesh=4).pool
    assert pool._pad(5) == 3 and pool._pad(8) == 0
    t = torch.arange(10.0).reshape(5, 2)
    padded = pool._pad_tree({"w": t}, 3)["w"]
    assert padded.shape == (8, 2)
    np.testing.assert_array_equal(padded[5:].numpy(),
                                  t[4:5].repeat(3, 1).numpy())
    mask = pool._pad_mask(np.ones(5, bool), 3, "cpu")
    assert mask.dtype == torch.bool and int(mask.sum()) == 5 \
        and not mask[5:].any()
    c = pool._pad_clients(pool.engine.state.clients, 3)
    assert c.n_devices == 8 and torch.equal(c.x[7], c.x[4])
    assert [pool.shard_devices(s) for s in range(4)] == \
        [[0, 1], [2, 3], [4], []]


# ---------------------------------------------------------- the slab
@pytest.mark.parametrize("s,t", [(8, 2), (20, 10), (24, 6)])
def test_alpha_combine_slab_matches_jax(s, t):
    rng = np.random.default_rng(s)
    theta = rng.normal(size=(s, 3000)).astype(np.float32)
    cols = rng.random((s, t)).astype(np.float32)
    ref = np.asarray(jax_alpha_combine_slab(jnp.asarray(theta),
                                            jnp.asarray(cols),
                                            interpret=True))
    before = ac.alpha_combine.launches
    out = ac.alpha_combine_slab(torch.as_tensor(theta),
                                torch.as_tensor(cols, dtype=torch.float64))
    assert out.dtype == torch.float32 and out.shape == (t, 3000)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)
    assert ac.alpha_combine.launches == before      # the plain version
    # the slab is the transfer's columns: (S, T) mixed per column block
    full = ac.alpha_combine_plain(torch.as_tensor(theta),
                                  torch.as_tensor(cols))
    np.testing.assert_allclose(out.numpy(), full.numpy(), rtol=1e-6,
                               atol=1e-6)


# ------------------------------------------------------- the four ops
@pytest.mark.parametrize("mesh", [1, 4])
@pytest.mark.parametrize("op", ["train", "train_async", "pair_values",
                                "targeted_values", "transfer",
                                "accuracies"])
def test_sharded_op_matches_local_pool(op, mesh):
    eng = _engine(mesh=mesh)
    sh, loc = eng.pool, LocalPool(eng)
    st = eng.state
    params = {k: v + 0.01 * torch.randn(v.shape, generator=generator(3))
              for k, v in st.params.items()}          # distinct devices
    active = np.array([True, True, False, True, True])
    if op in ("train", "train_async"):
        def run(pool):
            if op == "train":
                return pool.train(params, st.clients, generator(5), active)
            elig = np.array([True, False, True, True, False])
            return pool.train_async(params, st.clients, generator(5),
                                    active, elig, np.full(5, 0.5),
                                    np.full(5, 0.25))
        (pa, ea, aa), (pb, eb, ab) = run(sh), run(loc)
        for k in pa:
            np.testing.assert_array_equal(pa[k].numpy(), pb[k].numpy(), k)
        np.testing.assert_array_equal(ea, eb)
        np.testing.assert_array_equal(aa, ab)
    elif op in ("pair_values", "targeted_values"):
        pairs = np.array([[0, 3], [1, 2], [2, 4]])
        fn = sh.update_divergences if op == "pair_values" \
            else sh.refresh_divergences
        out = fn(np.zeros((5, 5)), st.clients, 11, pairs)
        ref = loc.update_divergences(np.zeros((5, 5)), st.clients, 11,
                                     pairs)
        np.testing.assert_array_equal(out, ref)
        assert out[0, 3] == out[3, 0] and np.count_nonzero(out) > 0
    elif op == "transfer":
        psi = np.array([0.0, 0.0, 0.0, 1.0, 1.0])
        alpha = np.zeros((5, 5))
        alpha[:3, 3] = [0.2, 0.5, 0.3]
        alpha[:3, 4] = [0.6, 0.0, 0.4]
        out, ref = sh.transfer(params, alpha, psi), \
            loc.transfer(params, alpha, psi)
        for k in out:
            assert out[k].shape == params[k].shape
            np.testing.assert_allclose(out[k].numpy(), ref[k].numpy(),
                                       rtol=1e-6, atol=1e-6, err_msg=k)
            np.testing.assert_array_equal(out[k][:3].numpy(),
                                          params[k][:3].numpy())
    else:
        np.testing.assert_array_equal(sh.accuracies(params, st.clients),
                                      loc.accuracies(params, st.clients))


def test_sharded_transfer_counts_one_slab_a_shard(monkeypatch):
    """Each shard mixes only its own target columns: k slab calls of
    (S_pad, S_pad / k)."""
    pool = _engine(mesh=4).pool
    seen = []
    real = ac.alpha_combine_slab

    def spy(theta, cols):
        seen.append((tuple(theta.shape), tuple(cols.shape)))
        return real(theta, cols)

    monkeypatch.setattr("repro_torch.sim.shard.ops.alpha_combine_slab", spy)
    alpha = np.zeros((5, 5))
    alpha[0, 1:] = 1.0
    pool.transfer(pool.engine.state.params, alpha,
                  np.array([0.0, 1.0, 1.0, 1.0, 1.0]))
    p = seen[0][0][1]
    assert seen == [((8, p), (8, 2))] * 4


# ------------------------------------------------------- whole runs
#: ``SMALL`` with a cheaper solve (each run still has targets)
RUNS = {"static": dict(scenario="static", solver_inner_steps=200,
                       solver_inner_steps_warm=100),
        "async-gossip": dict(scenario="async-gossip", engine="async-gossip",
                             rounds=4, solver_inner_steps=200,
                             solver_inner_steps_warm=100)}


@pytest.fixture(scope="module")
def references():
    """Per scenario: (reference rows, its initial params, the port's
    LocalPool rows on the reference's draws); the reference sync run is
    sharded (mesh 1), the async one local (see the module docstring)."""
    out = {}
    for name, kw in RUNS.items():
        jcfg = JSimConfig(**{**SMALL, **kw},
                          mesh=1 if name == "static" else 0)
        ref = JSimulationEngine(jcfg)
        p0 = jax.tree_util.tree_map(np.asarray, ref.state.params)
        ref_rows = ref.run()
        cfg = SimConfig(**dict(dataclasses.asdict(jcfg), mesh=0))
        local = SimulationEngine(cfg, device="cpu", params0=p0,
                                 draws=JaxSimDraws(cfg)).run()
        out[name] = (ref_rows, p0, local, cfg)
    return out


def _decisions_equal(a_rows, b_rows):
    assert len(a_rows) == len(b_rows)
    for a, b in zip(a_rows, b_rows):
        for k in a:
            if k in NONDETERMINISTIC_FIELDS:
                continue
            if k in FLOAT_FIELDS:
                np.testing.assert_allclose(a[k], b[k], rtol=1e-6,
                                           atol=1e-7)
            else:
                assert a[k] == b[k], (a["round"], k, a[k], b[k])


@pytest.mark.parametrize("mesh", [1, 2, 4])
@pytest.mark.parametrize("name", list(RUNS))
def test_sharded_run_matches_local_and_reference(references, name, mesh):
    ref_rows, p0, local, cfg = references[name]
    cfg = dataclasses.replace(cfg, mesh=mesh)
    eng = SimulationEngine(cfg, device="cpu", params0=p0,
                           draws=JaxSimDraws(cfg), emulate=mesh > 1)
    rows = eng.run()
    assert eng.pool.name == f"sharded-{mesh}"
    assert any(r["n_targets"] > 0 for r in rows), "no round had targets"
    _decisions_equal(rows, local)
    assert_rows_match(ref_rows, rows)
    if name == "async-gossip":
        assert any(r["gossip"] for r in rows)


# ---------------------------------------------------------------- CLI
@pytest.mark.parametrize("argv", [["--mesh", "1"], ["--mesh=1"]])
def test_cli_runs_the_sharded_pool(argv, tmp_path, capsys):
    out = tmp_path / "run.jsonl"
    assert trun.main(["--device", "cpu", "--scenario", "static",
                      "--devices", "4", "--rounds", "2", "--samples", "16",
                      "--train-iters", "3", "--div-T", "2",
                      "--solver-max-outer", "2", "--solver-inner-steps",
                      "60", "--quiet", "--out", str(out)] + argv) == 0
    assert "pool=sharded-1" in capsys.readouterr().out
    rows = [json.loads(ln) for ln in out.read_text().splitlines()]
    assert len(rows) == 2 and rows[0]["resolve_reason"] == "cold"
    with pytest.raises(RuntimeError, match="emulate=True"):
        trun.main(["--device", "cpu", "--mesh", "2", "--rounds", "1",
                   "--out", str(tmp_path / "x.jsonl")])


# ------------------------------------------------ cost model with meshes
def _mesh_events():
    """Synthetic events of known linear costs at meshes 0, 2 and 4 (a
    lane's cost the same: the per-shard lane count is what falls)."""
    rng = np.random.default_rng(0)
    evs = []
    for mesh in (0, 2, 4):
        for tick in range(4):
            for n in (4, 8, 16, 32):
                ctx = dict(tick=tick, n_devices=n, mesh=mesh)
                lanes = -(-n // max(mesh, 1))
                evs += [dict(ctx, phase="train",
                             seconds=0.01 * lanes + 0.2
                             + 1e-4 * rng.random()),
                        dict(ctx, phase="divergence", n_pairs=n // 2,
                             seconds=0.05 * n + 0.1),
                        dict(ctx, phase="transfer",
                             seconds=1e-4 * n * lanes + 0.01),
                        dict(ctx, phase="eval", seconds=0.002 * lanes),
                        dict(ctx, phase="solve", seconds=0.3 * n + 1.0)]
    return evs


@pytest.mark.parametrize("kw", [
    dict(), dict(max_mesh=2),
    dict(max_mesh=8, allow_mesh_extrapolation=True)])
def test_autotune_mesh_search_matches_reference(kw):
    evs = _mesh_events()
    ours, theirs = model.CostModel.fit(evs), jmodel.CostModel.fit(evs)
    assert ours.to_dict() == theirs.to_dict()
    assert ours.known_meshes() == theirs.known_meshes() == {0, 2, 4}
    for ckw in (dict(scenario="static", devices=16, rounds=4),
                dict(scenario="feature-drift-async", engine="async-gossip",
                     devices=32, rounds=6, mesh=2)):
        a = tune.autotune(SimConfig(**ckw), ours, **kw)
        assert a == jtune.autotune(JSimConfig(**ckw), theirs, **kw)
        assert a["knobs"].get("mesh", ckw.get("mesh", 0)) <= \
            kw.get("max_mesh", 4)
    assert tune.TUNED_KNOBS == jtune.TUNED_KNOBS


@pytest.mark.parametrize("mesh", ["0", "4"])
def test_replay_mesh_matches_reference(mesh, tmp_path):
    path = tmp_path / "model.json"
    path.write_text(json.dumps(
        {"model": model.CostModel.fit(_mesh_events()).to_dict()}))
    argv = ["--scenario", "feature-drift", "--n", "16", "--rounds", "3",
            "--mesh", mesh, "--model", str(path)]
    ours, theirs = tmp_path / "ours.json", tmp_path / "theirs.json"
    assert replay.main(argv + ["--json", str(ours)]) == 0
    assert jreplay.main(argv + ["--json", str(theirs)]) == 0
    a, b = json.loads(ours.read_text()), json.loads(theirs.read_text())
    assert a == b and a["mesh"] == int(mesh)
