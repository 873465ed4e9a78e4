"""The trace subsystem's numpy copies on the port (``sim.trace.model``,
``replay``, ``tune``) against ``repro.sim.trace``: the fitted cost model,
the replay walker's predictions and the autotuner's choice are exactly
the reference's on the same events (a trace the port recorded, and a
synthetic one of known costs); and the port's ``--autotune`` and
``python -m repro_torch.sim.replay`` refuse to run without a model the
caller names (the reference's default, ``BENCH_trace.json``, was fitted
on another machine)."""
import json

import numpy as np
import pytest

from repro.sim.engine import SimConfig as JSimConfig
from repro.sim.trace import model as jmodel
from repro.sim.trace import replay as jreplay
from repro.sim.trace import tune as jtune
from repro_torch.sim import SimConfig, SimulationEngine
from repro_torch.sim import run as trun
from repro_torch.sim.trace import model, replay, tune

TINY = dict(devices=5, samples_per_device=16, train_iters=3, div_tau=1,
            div_T=2, batch=4, solver_max_outer=2, solver_inner_steps=60,
            solver_inner_steps_warm=30)


@pytest.fixture(scope="module")
def events(tmp_path_factory):
    """A trace recorded by the port (async gossip with compact lanes,
    then a sync drift run), plus synthetic events of known linear
    costs."""
    path = tmp_path_factory.mktemp("trace") / "run.trace.jsonl"
    SimulationEngine(SimConfig(scenario="feature-drift-async",
                               engine="async-gossip", rounds=4, trace=True,
                               trace_path=str(path), **TINY),
                     device="cpu").run()
    recorded = model.read_trace(str(path))
    assert {e["phase"] for e in recorded} >= {"train", "divergence",
                                              "solve", "transfer", "eval"}
    assert any("lanes" in e for e in recorded if e["phase"] == "train")
    rng = np.random.default_rng(0)
    synthetic = []
    for tick in range(6):
        for n in (4, 8, 16, 32):
            synthetic.append({"phase": "train", "tick": tick,
                              "n_devices": n, "mesh": 0,
                              "seconds": 0.01 * n + 0.2
                              + 1e-4 * rng.random()})
            synthetic.append({"phase": "divergence", "tick": tick,
                              "n_devices": n, "mesh": 0, "n_pairs": n // 2,
                              "seconds": 0.05 * n + 0.1})
    return recorded, synthetic, str(path)


def _cfgs():
    for kw in (dict(scenario="static", devices=16, rounds=6),
               dict(scenario="device-churn", devices=32, rounds=5),
               dict(scenario="feature-drift", devices=24, rounds=8,
                    div_budget=6),
               dict(scenario="feature-drift-async", engine="async-gossip",
                    devices=64, rounds=12, resolve_patience=7),
               dict(scenario="faulty", devices=12, rounds=4,
                    checkpoint_every=2, ckpt_dir="unused")):
        yield SimConfig(**kw), JSimConfig(**kw)


def test_fit_predict_and_autotune_match_reference(events):
    recorded, synthetic, _ = events
    for evs in (recorded, synthetic, recorded + synthetic):
        ours, theirs = model.CostModel.fit(evs), jmodel.CostModel.fit(evs)
        assert ours.to_dict() == theirs.to_dict()
        back = model.CostModel.from_dict(json.loads(json.dumps(
            ours.to_dict())))
        assert back.to_dict() == ours.to_dict()
        for cfg, jcfg in _cfgs():
            assert replay.predict_run(cfg, ours) == \
                jreplay.predict_run(jcfg, theirs)
            assert tune.autotune(cfg, ours) == jtune.autotune(jcfg, theirs)
    for phase in ("train", "eval", "transfer", "divergence", "solve"):
        ctx = {"n_devices": 10, "mesh": 0, "n_pairs": 7, "lanes": 4}
        assert model.phase_features(phase, ctx).tolist() == \
            jmodel.phase_features(phase, ctx).tolist()
    # the synthetic slopes come back
    fit = model.CostModel.fit(synthetic).phases
    np.testing.assert_allclose(fit["divergence"]["coef"], [0.1, 0.1],
                               atol=1e-9)
    assert tune.min_budget(SimConfig(scenario="feature-drift",
                                     devices=8)) == \
        jtune.min_budget(JSimConfig(scenario="feature-drift", devices=8))


def test_autotune_searches_only_the_ported_pool(events):
    """The mesh search over the fitted meshes: a model that saw mesh 2
    tunes mesh 2 as the reference does (the name dates from when only
    the local pool was ported; ``tests/test_torch_sim_shard.py`` holds
    the search to the reference's)."""
    _, synthetic, _ = events
    evs = synthetic + [dict(e, mesh=2, seconds=e["seconds"] / 4)
                       for e in synthetic]
    cfg = dict(scenario="static", devices=16, rounds=4)
    out = tune.autotune(SimConfig(**cfg), model.CostModel.fit(evs))
    assert out == jtune.autotune(JSimConfig(**cfg),
                                 jmodel.CostModel.fit(evs))
    assert out["knobs"].get("mesh") == 2
    with pytest.raises(TypeError):
        model.CostModel.from_bench()              # no default model


def test_autotune_without_model_refuses(capsys):
    with pytest.raises(SystemExit) as e:
        trun.main(["--device", "cpu", "--autotune"])
    assert e.value.code == 2
    assert "--autotune-model" in capsys.readouterr().err


def test_autotune_with_a_recorded_trace(events, tmp_path, capsys):
    _, _, path = events
    out = tmp_path / "tuned.jsonl"
    assert trun.main(["--device", "cpu", "--scenario", "static",
                      "--devices", "5", "--rounds", "1", "--samples", "16",
                      "--train-iters", "2", "--div-T", "2",
                      "--solver-max-outer", "2", "--solver-inner-steps",
                      "60", "--quiet", "--autotune", "--autotune-model",
                      path, "--out", str(out)]) == 0
    assert "[sim] autotune" in capsys.readouterr().out
    assert len(out.read_text().splitlines()) == 1


def test_replay_cli_needs_a_model(events, capsys):
    with pytest.raises(SystemExit) as e:
        replay.main(["--scenario", "static", "--n", "8"])
    assert e.value.code == 2
    assert "--model is required" in capsys.readouterr().err
    _, _, path = events
    assert replay.main(["--scenario", "feature-drift", "--n", "16",
                        "--rounds", "3", "--model", path]) == 0
    printed = capsys.readouterr().out
    assert "end-to-end" in printed and path in printed
