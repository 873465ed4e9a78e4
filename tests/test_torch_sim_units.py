"""The simulator's building blocks on the port against ``repro.sim``:
the copied clock, state and metrics modules (exact equality), the sync
scenarios' event streams (the same numpy streams, so the same events
for one seed), the trace recorder, and one round of batched training
(``network_step``) with the reference's draws injected (parameters
within rtol/atol 1e-5, the bar of the slice's local-SGD parity;
eps_hat and own_acc equal)."""
import dataclasses
import json
import math

import jax
import numpy as np
import pytest
import torch

from test_torch_draws import jax_train_draws
from repro.data import build_network as jbuild_network
from repro.data.partition import reveal_labels as jreveal_labels
from repro.fl.client import init_client_params as jinit_client_params
from repro.fl.client import stack_clients as jstack_clients
from repro.sim import clock as jclock, metrics as jmetrics
from repro.sim import scenarios as jscenarios, state as jstate
from repro.sim import training as jtraining
from repro.sim.trace import events as jevents
from repro_torch import convert
from repro_torch.data import build_network
from repro_torch.data.partition import reveal_labels
from repro_torch.sim import clock, metrics, scenarios, state, training
from repro_torch.sim.engine import SimConfig
from repro_torch.sim.trace import events


# ----------------------------------------------------------------- clock
def test_clock_copy_matches():
    a = clock.DeviceClocks.sample(9, (1, 2, 4), np.random.default_rng(3))
    b = jclock.DeviceClocks.sample(9, (1, 2, 4), np.random.default_rng(3))
    for c in (a, b):
        c.mark_trained(np.array([0, 4]), 5)
        c.set_period(2, 3)
    for f in ("period", "phase", "last_train"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    for t in range(8):
        np.testing.assert_array_equal(a.eligible(t), b.eligible(t))
        np.testing.assert_array_equal(a.staleness(t), b.staleness(t))
    with pytest.raises(ValueError):
        clock.DeviceClocks.sample(3, (0,), np.random.default_rng(0))


# ----------------------------------------------------------------- state
def _states(p=6):
    devs = build_network("M//MM", num_devices=p, samples_per_device=12,
                         seed=1)
    jdevs = jbuild_network("M//MM", num_devices=p, samples_per_device=12,
                           seed=1)
    from repro_torch.fl.client import stack_clients
    out = []
    for mod, d, c in ((state, devs, stack_clients(devs, device="cpu")),
                      (jstate, jdevs, jstack_clients(jdevs))):
        active = np.array([True, True, False, True, True, False])
        out.append(mod.NetworkState(
            round=0, pool=d, active=active, clients=c, params={},
            eps_hat=np.ones(p), own_acc=np.zeros(p),
            div_hat=np.zeros((p, p)), div_known=np.eye(p, dtype=bool),
            div_dirty=np.zeros((p, p), bool),
            div_tick=np.full((p, p), -1, int), energy=None,
            psi=np.zeros(p), alpha=np.zeros((p, p))))
    return out


def test_state_copy_matches():
    a, b = _states()
    for s in (a, b):
        s.mark_pairs_estimated(np.array([[0, 1], [3, 4]]), 2)
        s.mark_pairs_dirty(1)
    assert a.pool_size == b.pool_size
    np.testing.assert_array_equal(a.active_idx, b.active_idx)
    np.testing.assert_array_equal(a.labeled_devices, b.labeled_devices)
    np.testing.assert_array_equal(a.unknown_active_pairs(),
                                  b.unknown_active_pairs())
    np.testing.assert_array_equal(a.dirty_active_pairs(),
                                  b.dirty_active_pairs())
    for f in ("div_known", "div_dirty", "div_tick"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


# --------------------------------------------------------------- metrics
def _record(mod, **kw):
    base = dict(round=3, scenario="static", n_active=5, n_sources=5,
                n_targets=0, resolved=False, warm=False, solver_iters=0,
                solver_wall_s=0.0, drift=0.01, mean_target_acc=float("nan"),
                mean_source_acc=0.25, energy=0.0, energy_cum=0.5,
                transmissions=0, link_churn=0.0,
                events=[{"event": "leave", "device": 2}], wall_time_s=1.5)
    base.update(kw)
    return mod.RoundRecord(**base)


def test_metrics_copy_matches(tmp_path):
    assert metrics.NONDETERMINISTIC_FIELDS == jmetrics.NONDETERMINISTIC_FIELDS
    ours = [(f.name, f.default) for f in dataclasses.fields(
        metrics.RoundRecord)]
    theirs = [(f.name, f.default) for f in dataclasses.fields(
        jmetrics.RoundRecord)]
    assert ours == theirs
    paths = []
    for mod in (metrics, jmetrics):
        path = str(tmp_path / mod.__name__ / "m.jsonl")
        log = mod.MetricsLogger(path)
        log.log(_record(mod))
        log.log(_record(mod, round=4, train_wall_s=0.25,
                        resolve_reason="drift"))
        log.close()
        paths.append(path)
    text = [open(p).read() for p in paths]
    assert text[0] == text[1] and "NaN" in text[0]
    rows = metrics.read_jsonl(paths[0])
    assert list(rows[0]) == list(json.loads(text[1].splitlines()[0]))
    assert math.isnan(rows[0]["mean_target_acc"])
    assert str(metrics.strip_nondeterministic(rows)) == str(
        jmetrics.strip_nondeterministic(jmetrics.read_jsonl(paths[1])))
    # a truncated final line (a crash mid-write) is dropped with a warning
    with open(paths[0], "a") as f:
        f.write('{"round": 5, "scen')
    with pytest.warns(UserWarning, match="truncated"):
        assert len(metrics.read_jsonl(paths[0])) == 2


# ------------------------------------------------------------- scenarios
class _StubEngine:
    """The scenario-facing surface of an engine: state, the mutation API,
    and a log of every mutation, over one package's data module."""

    def __init__(self, mod, build, reveal, cfg, p, spares):
        self.state = mod.NetworkState(
            round=0, pool=build("M//MM", num_devices=p, samples_per_device=20,
                                seed=0),
            active=np.arange(p) < p - spares, clients=None, params={},
            eps_hat=None, own_acc=None, div_hat=None, div_known=None,
            energy=None, psi=None, alpha=None)
        self._reveal = reveal
        self.calls = []

    def drift_channels(self, rng, sigma):
        self.calls.append(("drift", float(rng.normal(0.0, sigma))))

    def set_active(self, device, flag):
        self.state.active[device] = flag
        self.calls.append(("active", device, flag))

    def reveal_labels(self, device, frac, rng):
        self.state.pool[device] = self._reveal(self.state.pool[device], frac,
                                               rng)
        self.calls.append(("labels", device, self.state.pool[device]
                           .labeled_mask.tolist()))


@pytest.mark.parametrize("name", ["static", "channel-drift", "device-churn",
                                  "label-arrival"])
def test_scenario_event_streams_match(name):
    cfg = SimConfig(scenario=name, devices=6)
    streams = []
    for mod, smod, build, reveal in (
            (state, scenarios, build_network, reveal_labels),
            (jstate, jscenarios, jbuild_network, jreveal_labels)):
        cls = smod.get_scenario(name)
        eng = _StubEngine(mod, build, reveal, cfg, 6 + cls.wants_spares,
                          cls.wants_spares)
        scen = cls(cfg, np.random.default_rng(cfg.seed + 1))
        events_ = [scen.step(eng, t) for t in range(12)]
        streams.append((events_, eng.calls, eng.state.active.tolist()))
    assert streams[0] == streams[1]
    if name != "static":
        assert any(streams[0][0])


def test_unported_scenarios_are_refused():
    """Every reference scenario is ported: nothing is refused, and an
    unknown name is a KeyError."""
    assert scenarios.NOT_PORTED == {}
    assert set(scenarios.SCENARIOS) == set(jscenarios.SCENARIOS)
    with pytest.raises(KeyError):
        scenarios.get_scenario("nope")


# ----------------------------------------------------------------- trace
def test_trace_recorder_matches(tmp_path):
    """The port's and the reference's recorders on the same calls: the
    same wall fields and events (timings aside), and each writes its own
    trace file of the same 3 phases in the same order."""
    recs = []
    for name, mk in (("ours", lambda c: events.TraceRecorder(
            c, torch.device("cpu"))), ("theirs", jevents.TraceRecorder)):
        recs.append(mk(SimConfig(trace=True,
                                 trace_path=str(tmp_path / f"{name}.jsonl"))))
    ours, theirs = recs
    for rec in (ours, theirs):
        rec.begin_tick(2)
        rec.with_ctx(n_dirty=3)
        rec.add("divergence", 0.5, n_pairs=4)
        rec.stop("train", rec.start(), block={"w": torch.ones(1)}
                 if rec is ours else None, n_devices=5)
        rec.add("solve", 1.25)
    fo, ft = ours.tick_wall_fields(), theirs.tick_wall_fields()
    assert list(fo) == list(ft) == list(events.WALL_FIELDS.values())
    assert fo["div_wall_s"] == ft["div_wall_s"] == 0.5
    assert [{k: v for k, v in e.items() if k != "seconds"}
            for e in ours.events] == [
        {k: v for k, v in e.items() if k != "seconds"}
        for e in theirs.events]
    ours.close()
    theirs.close()
    phases = []
    for name in ("ours", "theirs"):
        lines = open(tmp_path / f"{name}.jsonl").read().splitlines()
        assert len(lines) == 3, (name, lines)
        phases.append([json.loads(ln)["phase"] for ln in lines])
    assert phases[0] == phases[1] == ["divergence", "train", "solve"]
    off = events.TraceRecorder(SimConfig())
    assert off.start() is None and off.tick_wall_fields() == {}
    off.add("train", 1.0)
    assert off.events == []


# ------------------------------------------------------------- training
@pytest.fixture(scope="module")
def step_pair():
    n, iters, batch = 5, 6, 10
    devs = jbuild_network("M//MM", num_devices=n, samples_per_device=30,
                          seed=0)
    jc = jstack_clients(devs)
    p0 = jinit_client_params(n, jax.random.PRNGKey(1))
    key = jax.random.PRNGKey(9)
    active = np.array([True, True, True, False, True])
    ref = jtraining.network_step(p0, jc, key, active, iters=iters,
                                 batch=batch, lr=0.01)
    c = convert.clients_from_numpy(jc, "cpu")
    draws = jax_train_draws(c, jax.random.split(key, n), iters=iters,
                            batch=batch)
    out = training.network_step(
        convert.params_from_jax(jax.tree_util.tree_map(np.asarray, p0),
                                "cpu"),
        c, None, torch.as_tensor(active), iters=iters, batch=batch, lr=0.01,
        draws=draws)
    return ref, out, p0, c


def test_network_step_matches_reference(step_pair):
    (jp, jeps, jacc), (p, eps, acc), p0, c = step_pair
    for k in jp:
        np.testing.assert_allclose(p[k].numpy(), np.asarray(jp[k]),
                                   rtol=1e-5, atol=1e-5, err_msg=k)
    np.testing.assert_array_equal(eps.numpy(), np.asarray(jeps))
    np.testing.assert_array_equal(acc.numpy(), np.asarray(jacc))
    # the inactive device and every unlabeled one keep their parameters
    keep = ~c.labeled.any(1).numpy()
    keep[3] = True
    assert keep.any() and not keep.all()
    for k in jp:
        np.testing.assert_array_equal(p[k].numpy()[keep],
                                      np.asarray(p0[k])[keep])


def test_mixed_accuracies_match_reference(step_pair):
    (jp, _, jacc), (p, _, acc), _, c = step_pair
    np.testing.assert_array_equal(training.mixed_accuracies(p, c).numpy(),
                                  acc.numpy())
    np.testing.assert_array_equal(
        np.asarray(jtraining.mixed_accuracies(jp, jstack_clients(
            jbuild_network("M//MM", num_devices=5, samples_per_device=30,
                           seed=0)))), np.asarray(jacc))
