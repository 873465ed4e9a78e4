"""Fault injection and crash-consistent checkpoint/resume on the port
against ``repro.sim``: the ``faulty`` scenario (sync and async) against
live reference runs (the reference's initial parameters and in-tick
draws injected, as in ``test_torch_sim_async.py``); a resumed run equal
to the uninterrupted one field for field on the CPU (sync, async with
faults, feature drift: the cases of ``tests/test_sim_resume.py``); a
port archive and a reference archive of the same round holding the same
members and the same arrays; config mismatch and empty directories;
``--kill-after`` (a real SIGKILL) followed by the CLI's ``--resume``;
and the fault layer's units against the reference's."""
import json
import os
import signal
import subprocess
import sys

import jax
import numpy as np
import pytest

from test_torch_draws import JaxSimDraws
from test_torch_sim_async import check_scenario
from test_torch_sim_engine import SMALL, assert_rows_match
from repro.checkpoint import load_arrays as jload_arrays
from repro.sim import faults as jfaults
from repro.sim.engine import SimConfig as JSimConfig
from repro.sim.engine import SimulationEngine as JSimulationEngine
from repro.sim.shard import pool as jpool
from repro_torch.checkpoint import load_arrays, load_metadata
from repro_torch.sim import SimConfig, SimulationEngine, faults
from repro_torch.sim.metrics import read_jsonl, strip_nondeterministic
from repro_torch.sim.snapshot import save_run

# the reference's resume settings (tests/test_sim_resume.py)
SMOKE = dict(samples_per_device=40, train_iters=8, div_tau=1, div_T=6,
             solver_max_outer=3, solver_inner_steps=200)
FAULTY = dict(fault_crash_p=0.5, fault_op_p=0.5, fault_gossip_drop_p=0.5,
              fault_backoff_s=0.0)


def _canon(rows):
    """NaN-tolerant comparable form of a stripped row list."""
    return json.dumps(strip_nondeterministic(rows), sort_keys=True)


# --------------------------------------------------- faulty vs reference
def test_faulty_sync_matches_reference():
    rows = check_scenario("faulty", rounds=4, **FAULTY)
    assert sum(r["n_faults"] for r in rows) > 0
    assert sum(r["n_recovered"] for r in rows) > 0
    assert any(e["event"] == "pool_fault" for r in rows
               for e in r["events"])


def test_faulty_async_matches_reference():
    """Dropped gossip exchanges keep the link's energy but not the
    blend; crashes rejoin through the churn/reseed path."""
    rows = check_scenario("faulty", engine="async-gossip", devices=8,
                          rounds=5, **FAULTY)
    assert sum(r["n_faults"] for r in rows) > 0
    assert any(e["event"] == "crash" for r in rows for e in r["events"])


# --------------------------------------------------- resume = straight run
def _roundtrip(tmp_path, rounds=5, cut=2, emulate=False, **kw):
    """Run uninterrupted; run to ``cut`` rounds with checkpointing; run
    again with resume=True to the full horizon (the port's own seeds).
    Returns (ref rows, resumed rows)."""
    def run(**more):
        return SimulationEngine(SimConfig(**SMOKE, **kw, **more),
                                device="cpu", emulate=emulate).run()
    ref = run(rounds=rounds, log_path=str(tmp_path / "ref.jsonl"))
    ck = str(tmp_path / "ck")
    run(rounds=cut, log_path=str(tmp_path / "res.jsonl"),
        checkpoint_every=1, ckpt_dir=ck)
    rows = run(rounds=rounds, log_path=str(tmp_path / "res.jsonl"),
               checkpoint_every=1, ckpt_dir=ck, resume=True)
    return ref, rows


def test_sync_resume_matches_uninterrupted(tmp_path):
    ref, rows = _roundtrip(tmp_path, scenario="device-churn", devices=6,
                           seed=3)
    assert _canon(ref) == _canon(rows)
    assert all(r["resume_count"] == 1 for r in rows[2:])
    assert _canon(read_jsonl(str(tmp_path / "ref.jsonl"))) == \
        _canon(read_jsonl(str(tmp_path / "res.jsonl")))


def test_async_faulty_resume_matches_uninterrupted(tmp_path):
    ref, rows = _roundtrip(tmp_path, scenario="faulty",
                           engine="async-gossip", devices=8, seed=4,
                           fault_crash_p=0.5, fault_op_p=0.5,
                           fault_gossip_drop_p=0.5)
    assert _canon(ref) == _canon(rows)
    assert sum(r["n_faults"] for r in rows) > 0


def test_feature_drift_resume_matches_uninterrupted(tmp_path):
    ref, rows = _roundtrip(tmp_path, scenario="feature-drift", devices=6,
                           seed=4, feature_drift_p=0.8)
    assert _canon(ref) == _canon(rows)
    assert sum(r["n_drifted"] for r in ref) > 0


# ------------------------------------------------ sharded shard loss
SHARD_LOSS = dict(scenario="faulty", devices=6, seed=4, fault_shard_p=0.7,
                  fault_crash_p=0.0)


@pytest.mark.parametrize("mesh", [1, 2])
def test_sharded_faulty_resume_matches_uninterrupted(tmp_path, mesh):
    """ShardedPool (mesh 1, and 2 emulated): lost shards are recovered
    through the churn/reseed path, and the resumed run reproduces the
    uninterrupted one (the reference's case, which fails there under
    jax 0.9.0: ``tests/test_sim_resume.py``)."""
    ref, rows = _roundtrip(tmp_path, mesh=mesh, emulate=mesh > 1,
                           **SHARD_LOSS)
    assert _canon(ref) == _canon(rows)
    assert sum(r["n_recovered"] for r in rows) > 0
    assert any(e["event"] == "shard_lost" for r in rows
               for e in r["events"])


class _JaxShardRecovery(jpool.LocalPool):
    """The reference's LocalPool doing, on unsharded arrays, what its
    ShardedPool's ``_recover_shard`` does (which cannot run under jax
    0.9.0: ``.at[j].set`` on a mesh-sharded leaf raises): ``n_shards``
    shards over the padded pool, a lost shard's active devices handed
    to ``engine._recover_devices``.  The injector draws the shard from
    ``n_shards`` as it would against the sharded pool."""

    def __init__(self, engine, n_shards):
        super().__init__(engine)
        self.n_shards = n_shards

    def _recover_shard(self, s):
        n = self.engine.state.pool_size
        blk = -(-n // self.n_shards)
        devs = [d for d in range(s * blk, min((s + 1) * blk, n))
                if bool(self.engine.state.active[d])]
        if devs:
            self.engine._recover_devices(devs, shard=s)


@pytest.mark.parametrize("mesh", [1, 2])
def test_sharded_faulty_matches_reference_recovery(mesh):
    jcfg = JSimConfig(**{**SMALL, **SHARD_LOSS, "rounds": 4})
    ref = JSimulationEngine(jcfg)
    ref.pool = _JaxShardRecovery(ref, mesh)
    p0 = jax.tree_util.tree_map(np.asarray, ref.state.params)
    ref_rows = ref.run()
    cfg = SimConfig(**dict(
        {f: getattr(jcfg, f) for f in jcfg.__dataclass_fields__},
        mesh=mesh))
    eng = SimulationEngine(cfg, device="cpu", params0=p0,
                           draws=JaxSimDraws(cfg), emulate=mesh > 1)
    rows = eng.run()
    assert eng.pool.name == f"sharded-{mesh}"
    assert_rows_match(ref_rows, rows)
    assert sum(r["n_recovered"] for r in rows) > 0
    assert any(r["resolve_reason"] == "membership" for r in rows)
    for k, v in eng.state.params.items():
        np.testing.assert_allclose(v.numpy(), np.asarray(ref.state.params[k]),
                                   rtol=1e-5, atol=1e-5, err_msg=k)


# ------------------------------------------- archive against the reference
def test_archive_matches_reference_archive(tmp_path):
    """Both packages checkpoint the same round of the same run (the
    reference's draws injected into the port): the same members; every
    integer, boolean and data array equal; every float within the run
    parity's bars.  ``['key']`` holds the port's seed where the
    reference saves its PRNG key."""
    kw = dict(SMALL, scenario="feature-drift-async", engine="async-gossip",
              rounds=2, feature_drift_p=0.9, feature_drift_step=0.4,
              checkpoint_every=1)
    jcfg = JSimConfig(**kw, ckpt_dir=str(tmp_path / "jax"))
    ref = JSimulationEngine(jcfg)
    p0 = jax.tree_util.tree_map(np.asarray, ref.state.params)
    ref.run()
    cfg = SimConfig(**kw, ckpt_dir=str(tmp_path / "torch"))
    SimulationEngine(cfg, device="cpu", params0=p0,
                     draws=JaxSimDraws(cfg)).run()
    js, theirs = jload_arrays(str(tmp_path / "jax"))
    ps, ours = load_arrays(str(tmp_path / "torch"))
    assert js == ps == 2
    assert set(ours) == set(theirs)
    assert "['clocks']['period']" in ours
    assert any(k.startswith("['drift']") for k in ours)
    for k in sorted(ours):
        if k == "['key']":
            continue
        a, b = ours[k], theirs[k]
        assert a.shape == b.shape, k
        if k.startswith(("['params']", "['solver']")):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5,
                                       err_msg=k)
        elif np.issubdtype(b.dtype, np.floating) and not k.startswith(
                ("['pool']", "['drift']", "['energy_K']")):
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(a, b, err_msg=k)
    meta = load_metadata(str(tmp_path / "torch"), 2)
    jmeta = json.load(open(tmp_path / "jax" / "step_00000002.json"))
    assert set(meta) == set(jmeta)
    for k in ("engine_rng", "scenario", "executor", "prev_links",
              "solve_tick", "drift_domains"):
        assert meta[k] == jmeta[k], k
    assert {k: v for k, v in meta["cfg"].items() if k != "ckpt_dir"} == \
        {k: v for k, v in jmeta["cfg"].items() if k != "ckpt_dir"}


def test_network_state_roundtrip(tmp_path):
    cfg = dict(SMOKE, scenario="feature-drift", devices=6, rounds=2,
               seed=5, feature_drift_p=1.0, ckpt_dir=str(tmp_path))
    eng = SimulationEngine(SimConfig(**cfg), device="cpu")
    eng.run()
    save_run(eng, 2)
    eng2 = SimulationEngine(SimConfig(**cfg, resume=True), device="cpu")
    a, b = eng.state, eng2.state
    assert b.round == 2 and eng2._resume_count == 1
    for f in ("active", "eps_hat", "div_hat", "div_known", "div_dirty",
              "div_tick", "psi", "alpha", "solve_active"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), f)
    for k in a.params:
        assert a.params[k].dtype == b.params[k].dtype
        np.testing.assert_array_equal(a.params[k].numpy(),
                                      b.params[k].numpy())
    for j in range(a.pool_size):
        np.testing.assert_array_equal(a.pool[j].images, b.pool[j].images)
    np.testing.assert_array_equal(a.solver.psi_relaxed,
                                  b.solver.psi_relaxed)
    assert set(eng._drift_base) == set(eng2._drift_base)
    for j in eng._drift_base:
        assert eng._drift_domain[j] == eng2._drift_domain[j]
        np.testing.assert_array_equal(eng._drift_alt[j], eng2._drift_alt[j])
    assert eng.scenario.rng.bit_generator.state == \
        eng2.scenario.rng.bit_generator.state
    assert eng.key == eng2.key


def test_resume_cfg_mismatch_raises(tmp_path):
    base = dict(scenario="static", devices=6, seed=0,
                ckpt_dir=str(tmp_path))
    SimulationEngine(SimConfig(**base, **SMOKE, rounds=1,
                               checkpoint_every=1), device="cpu").run()
    with pytest.raises(ValueError, match="div_T"):
        SimulationEngine(SimConfig(**base, **dict(SMOKE, div_T=7),
                                   rounds=2, resume=True), device="cpu")
    # a larger horizon is fine — that's what resume is for
    eng = SimulationEngine(SimConfig(**base, **SMOKE, rounds=3,
                                     resume=True), device="cpu")
    assert eng.state.round == 1


def test_resume_empty_dir_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        SimulationEngine(SimConfig(scenario="static", devices=6, rounds=1,
                                   ckpt_dir=str(tmp_path / "nothing"),
                                   resume=True, **SMOKE), device="cpu")


# ------------------------------------------------------- true SIGKILL
def test_kill_after_and_cli_resume(tmp_path):
    env = dict(os.environ,
               PYTHONPATH=os.path.join(os.path.dirname(__file__), "..",
                                       "src"))
    base = [sys.executable, "-m", "repro_torch.sim.run", "--device", "cpu",
            "--scenario", "static", "--devices", "5", "--rounds", "3",
            "--samples", "20", "--train-iters", "4", "--div-T", "3",
            "--solver-max-outer", "2", "--solver-inner-steps", "100",
            "--quiet"]
    ref = str(tmp_path / "ref.jsonl")
    out = str(tmp_path / "out.jsonl")
    subprocess.run(base + ["--out", ref], env=env, check=True, timeout=300)
    killed = subprocess.run(base + ["--out", out, "--checkpoint-every", "1",
                                    "--kill-after", "1"], env=env,
                            timeout=300)
    assert killed.returncode == -signal.SIGKILL
    assert len(read_jsonl(out)) == 2
    done = subprocess.run(base + ["--out", out, "--checkpoint-every", "1",
                                  "--resume"], env=env, check=True,
                          timeout=300, capture_output=True, text=True)
    assert "resumed 1x" in done.stdout
    assert _canon(read_jsonl(ref)) == _canon(read_jsonl(out))


# ------------------------------------------------- fault-layer units
def test_with_retry_bounded():
    for mod in (faults, jfaults):
        calls = []

        def flaky():
            calls.append(1)
            if len(calls) < 3:
                raise mod.PoolFaultError("transient")
            return "ok"

        assert mod.with_retry(flaky, retries=3) == "ok"
        assert len(calls) == 3
        with pytest.raises(mod.PoolFaultError):
            mod.with_retry(lambda: (_ for _ in ()).throw(
                mod.PoolFaultError("x")), retries=2)


def test_fault_injector_matches_reference_and_roundtrips():
    cfg = SimConfig(scenario="faulty", devices=8, rounds=1,
                    fault_crash_p=1.0, fault_op_p=1.0, **SMOKE)
    inj = faults.FaultInjector(cfg, np.random.default_rng(7))
    jinj = jfaults.FaultInjector(cfg, np.random.default_rng(7))
    inj.down = jinj.down = {3: 9}
    inj.pending_op_failures = jinj.pending_op_failures = 2
    state = json.loads(json.dumps(inj.state_dict()))   # JSON-safe
    assert state == json.loads(json.dumps(jinj.state_dict()))
    inj2 = faults.FaultInjector(cfg, np.random.default_rng(0))
    inj2.load_state_dict(state)
    assert inj2.down == {3: 9} and inj2.pending_op_failures == 2
    assert inj.rng.random() == inj2.rng.random() == jinj.rng.random()
    assert [inj.drop_exchange() for _ in range(20)] == \
        [jinj.drop_exchange() for _ in range(20)]
