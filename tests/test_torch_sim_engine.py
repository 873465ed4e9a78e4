"""The simulator's sync path on the port against a live
``repro.sim.SimulationEngine`` run of the same SimConfig, with the
reference engine's initial parameters and its in-round draws injected
(``static`` and ``channel-drift`` here, the membership scenarios in
``test_torch_sim_engine_churn.py``); and the port's CLI.

Tolerances: every decision field (psi counts, links, events, re-solve
flags and reasons, solver iterations) must be equal; the float fields
(drift, accuracies, energies, link churn) within rtol 1e-6 / atol 1e-7,
NaN equal to NaN — the two runs have agreed bit for bit on this box,
and the margin only absorbs another BLAS's summation order; the final
stacked parameters within rtol/atol 1e-5, the bar the slice's parity
tests hold local SGD to.  The goldens in ``tests/golden`` are never used:
they do not reproduce under every jax version."""
import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from test_torch_draws import JaxSimDraws
from repro.sim import SimConfig as JSimConfig
from repro.sim import SimulationEngine as JSimulationEngine
from repro.sim.metrics import NONDETERMINISTIC_FIELDS, RoundRecord
from repro_torch import convert
from repro_torch.sim import SimConfig, SimulationEngine
from repro_torch.sim import run as trun

# the default train_iters (30) gives targets where SMOKE-sized training
# solves every device to a source
SMALL = dict(devices=5, rounds=3, samples_per_device=40, train_iters=30,
             div_tau=1, div_T=3, solver_max_outer=4, solver_inner_steps=300,
             solver_inner_steps_warm=150)
FLOAT_FIELDS = ("drift", "mean_target_acc", "mean_source_acc", "energy",
                "energy_cum", "link_churn")


def run_both(scenario: str, **kw):
    """(reference rows, port rows, reference engine, port engine)."""
    jcfg = JSimConfig(scenario=scenario, **SMALL, **kw)
    ref = JSimulationEngine(jcfg)
    p0 = jax.tree_util.tree_map(np.asarray, ref.state.params)
    ref_rows = ref.run()
    cfg = SimConfig(**dataclasses.asdict(jcfg))
    eng = SimulationEngine(cfg, device="cpu", params0=p0,
                           draws=JaxSimDraws(cfg))
    return ref_rows, eng.run(), ref, eng


def assert_rows_match(ref_rows, rows):
    assert len(rows) == len(ref_rows)
    for a, b in zip(rows, ref_rows):
        assert list(a) == list(b)                       # same schema
        for k in a:
            if k in NONDETERMINISTIC_FIELDS:
                continue
            if k in FLOAT_FIELDS:
                np.testing.assert_allclose(a[k], b[k], rtol=1e-6, atol=1e-7,
                                           err_msg=f"round {a['round']} {k}")
            else:
                assert a[k] == b[k], (a["round"], k, a[k], b[k])


def check_scenario(scenario: str, **kw):
    ref_rows, rows, ref, eng = run_both(scenario, **kw)
    assert_rows_match(ref_rows, rows)
    assert any(r["n_targets"] > 0 for r in rows), "no round had targets"
    gap = convert.params_max_abs_diff(
        eng.state.params, jax.tree_util.tree_map(np.asarray,
                                                 ref.state.params))
    for k, v in eng.state.params.items():
        np.testing.assert_allclose(v.numpy(), np.asarray(ref.state.params[k]),
                                   rtol=1e-5, atol=1e-5, err_msg=k)
    assert max(gap.values()) < 1e-4, gap
    np.testing.assert_array_equal(eng.state.psi, ref.state.psi)
    np.testing.assert_allclose(eng.state.div_hat, ref.state.div_hat,
                               atol=1e-6)
    return rows


@pytest.mark.parametrize("scenario", ["static", "channel-drift"])
def test_sync_run_matches_reference(scenario):
    rows = check_scenario(scenario)
    if scenario == "static":
        assert [r["resolve_reason"] for r in rows][:2] == ["cold", None]
    else:
        assert all(r["events"] for r in rows)


def test_cli_writes_the_reference_schema(tmp_path):
    out = tmp_path / "nested" / "run.jsonl"
    assert trun.main(["--device", "cpu", "--scenario", "device-churn",
                      "--devices", "5", "--rounds", "2", "--samples", "40",
                      "--train-iters", "8", "--trace", "--quiet",
                      "--out", str(out)]) == 0
    lines = out.read_text().splitlines()
    assert len(lines) == 2
    fields = [f.name for f in dataclasses.fields(RoundRecord)]
    for ln in lines:
        row = json.loads(ln)
        assert list(row) == fields
        assert row["engine"] == "sync" and row["scenario"] == "device-churn"
        assert row["train_wall_s"] > 0 and row["eval_wall_s"] > 0


@pytest.mark.parametrize("argv,match", [
    (["--mesh", "2"], "emulate=True"),
    (["--mesh=2"], "emulate=True"),
])
def test_cli_refuses_unported(argv, match, tmp_path):
    """Every flag is ported (the name dates from when some were not);
    what the CLI refuses is a mesh of more shards than the host has
    devices (it never emulates them)."""
    with pytest.raises(RuntimeError, match=match):
        trun.main(["--device", "cpu", "--out", str(tmp_path / "x.jsonl")]
                  + argv)


@pytest.mark.parametrize("argv,field,value", [
    (["--scenario", "faulty"], "scenario", "faulty"),
    (["--scenario", "feature-drift"], "scenario", "feature-drift"),
    (["--engine", "async-gossip"], "engine", "async-gossip"),
    (["--resume"], "ckpt_dir", "x.jsonl.ckpt"),
    (["--checkpoint-every", "1"], "checkpoint_every", 1),
    (["--div-key-mode", "content"], "div_key_mode", "content"),
    (["--gossip-pairs", "3"], "gossip_pairs", 3),
    (["--fault-crash-p", "0.5"], "fault_crash_p", 0.5),
    (["--tick-periods", "1,3"], "tick_periods", (1, 3)),
    (["--mesh", "2"], "mesh", 2),
])
def test_cli_takes_the_reference_flags(argv, field, value):
    """The flags the reference's CLI declares parse, with its defaults,
    into the SimConfig field they set there."""
    from repro.sim import run as jrun
    p = trun.build_parser()
    cfg = trun.config_from_args(trun.parse_args(
        p, argv + ["--out", "x.jsonl"]))
    assert getattr(cfg, field) == value
    ours = {a.dest: a.default for a in p._actions}
    theirs = {a.dest: a.default for a in jrun.build_parser()._actions}
    del ours["device"]
    assert ours == theirs


def test_cli_needs_the_gpu_unless_told(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trun.main(["--rounds", "1", "--out", str(tmp_path / "x.jsonl")])


@pytest.mark.parametrize("kw,match", [
    (dict(mesh=2), "emulate=True"),
])
def test_config_refuses_unported(kw, match):
    """Both packages take every config; the port's engine refuses a mesh
    of more shards than the host has devices unless asked to emulate."""
    assert dataclasses.asdict(SimConfig(**kw)) == \
        dataclasses.asdict(JSimConfig(**kw))
    with pytest.raises(RuntimeError, match=match):
        SimulationEngine(SimConfig(**kw, devices=3, samples_per_device=8),
                         device="cpu")


@pytest.mark.parametrize("kw", [
    dict(engine="async-gossip"),
    dict(div_key_mode="content"),
    dict(resume=True, ckpt_dir="d"),
    dict(kill_after=0),
    dict(fault_op_p=0.5),
])
def test_config_takes_what_the_reference_takes(kw):
    ours, theirs = SimConfig(**kw), JSimConfig(**kw)
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)


def test_config_keeps_the_reference_fields():
    ours = [(f.name, f.default) for f in dataclasses.fields(SimConfig)]
    theirs = [(f.name, f.default) for f in dataclasses.fields(JSimConfig)]
    assert ours == theirs
    with pytest.raises(ValueError, match="devices"):
        SimConfig(devices=0)
    with pytest.raises(KeyError, match="unknown scenario"):
        SimulationEngine(SimConfig(scenario="nope"), device="cpu")
    with pytest.raises(KeyError, match="unknown engine"):
        SimulationEngine(SimConfig(engine="nope"), device="cpu")
