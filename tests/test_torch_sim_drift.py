"""Feature drift on the port against ``repro.sim``: the ``feature-drift``
and ``feature-drift-async`` scenarios against live reference runs (the
reference's initial parameters and in-tick draws injected, as in
``test_torch_sim_async.py``), ``engine.drift_features`` against the
reference engine's on the same devices, the per-tick refresh budget,
content-addressed re-measurement, and the dirty-pair tracking staying
inert without feature drift.

Tolerances: those of ``test_torch_sim_engine.py`` for the runs; the
drifted device data (numpy on both sides) exactly."""
import numpy as np
import pytest

from test_torch_sim_async import check_scenario
from test_torch_sim_engine import SMALL
from repro.sim.engine import SimConfig as JSimConfig
from repro.sim.engine import SimulationEngine as JSimulationEngine
from repro_torch.data.digits import DOMAINS
from repro_torch.sim import SimConfig, SimulationEngine

DRIFT = dict(feature_drift_p=0.9, feature_drift_step=0.4, rounds=4)


@pytest.mark.parametrize("scenario,engine", [
    ("feature-drift", "sync"), ("feature-drift-async", "async-gossip")])
def test_feature_drift_matches_reference(scenario, engine):
    rows = check_scenario(scenario, engine=engine, **DRIFT)
    assert any(r["n_drifted"] > 0 for r in rows)
    assert any(r["n_reestimated"] > 0 for r in rows[1:])


def test_feature_drift_budget_matches_reference_and_holds():
    """A budget of 2 pairs a tick: the backlog carries over, stalest
    first, on both sides."""
    rows = check_scenario("feature-drift", div_budget=2, **DRIFT)
    assert all(r["n_reestimated"] <= 2 for r in rows)
    assert any(r["n_dirty_pairs"] > 2 for r in rows[1:])


def test_content_key_mode_matches_reference():
    """``div_key_mode='content'``: the bootstrap too is
    content-addressed (the reference's keys and init injected)."""
    check_scenario("feature-drift", div_key_mode="content", **DRIFT)


# ------------------------------------------------ engine mutation API
def _engines(**kw):
    cfg = dict(scenario="static", devices=5, rounds=1,
               samples_per_device=20, **kw)
    return (SimulationEngine(SimConfig(**cfg), device="cpu"),
            JSimulationEngine(JSimConfig(**cfg)))


def test_drift_features_caches_dirties_and_is_absolute():
    ours, theirs = _engines()
    base = ours.state.pool[2].images.copy()
    doms = [e.drift_features(2, 0.5) for e in (ours, theirs)]
    assert doms[0] == doms[1] and doms[0] in DOMAINS
    np.testing.assert_array_equal(ours.state.pool[2].images,
                                  theirs.state.pool[2].images)
    st = ours.state
    assert st.div_dirty[2, :].sum() == st.pool_size - 1   # row dirtied
    assert st.div_dirty[:, 2].sum() == st.pool_size - 1
    assert not st.div_dirty[2, 2] and ours._restack
    np.testing.assert_array_equal(st.div_dirty, theirs.state.div_dirty)
    drifted = st.pool[2].images.copy()
    assert not np.array_equal(drifted, base)
    # absolute mix: re-blending at the same mix reproduces, not compounds
    ours.drift_features(2, 0.5)
    np.testing.assert_array_equal(st.pool[2].images, drifted)
    # mix 0 restores the pristine original exactly
    ours.drift_features(2, 0.0)
    np.testing.assert_array_equal(st.pool[2].images, base)
    # the alt domain is cached on first call; later hints are ignored
    assert ours.drift_features(2, 0.3, domain="M") == doms[0]
    np.testing.assert_array_equal(ours._drift_alt[2], theirs._drift_alt[2])


def test_drift_features_preserves_labels_revealed_after_first_drift():
    """A label reveal BETWEEN two drift steps survives the second
    re-blend, as in the reference."""
    out = []
    for eng in _engines():
        st = eng.state
        eng.drift_features(2, 0.3)
        before = st.pool[2].n_labeled
        eng.reveal_labels(2, 1.0, np.random.default_rng(0))
        revealed = st.pool[2].n_labeled
        assert revealed > before
        eng.drift_features(2, 0.6)
        assert st.pool[2].n_labeled == revealed
        np.testing.assert_array_equal(
            st.pool[2].labels,
            np.where(st.pool[2].labeled_mask, st.pool[2].true_labels, -1))
        out.append(st.pool[2])
    for f in ("images", "labels", "labeled_mask", "true_labels"):
        np.testing.assert_array_equal(getattr(out[0], f),
                                      getattr(out[1], f))


# ----------------------------------------- content-addressed measurement
def test_content_keys_make_remeasurement_idempotent():
    """Re-measuring an UNCHANGED pair reproduces its value exactly, and
    the value does not depend on the batch the scheduler put it in
    (the drift refresh path, the port's own seeds)."""
    eng = SimulationEngine(SimConfig(scenario="static", devices=6, rounds=1,
                                     samples_per_device=20, div_T=4, batch=5,
                                     div_key_mode="content"), device="cpu")
    ex, st = eng.executor, eng.state
    pairs = np.array([[0, 3], [1, 4], [2, 5]], np.int32)
    kw = lambda p: ex._content_kwargs(p)                  # noqa: E731
    a = eng.pool.refresh_divergences(np.zeros((6, 6)), st.clients, None,
                                     pairs, **kw(pairs))
    b = eng.pool.refresh_divergences(np.zeros((6, 6)), st.clients, None,
                                     pairs, **kw(pairs))
    np.testing.assert_array_equal(a, b)
    solo = pairs[1:2]
    c = eng.pool.refresh_divergences(np.zeros((6, 6)), st.clients, None,
                                     solo, **kw(solo))
    assert c[1, 4] == a[1, 4]
    np.testing.assert_array_equal(
        ex._pair_content_keys(np.array([[4, 1]])),
        ex._pair_content_keys(np.array([[1, 4]])))
    # ema=1 keeps the old values
    old = np.full((6, 6), 0.5)
    np.fill_diagonal(old, 0.0)
    np.testing.assert_array_equal(
        eng.pool.refresh_divergences(old, st.clients, None, pairs, ema=1.0,
                                     **kw(pairs)), old)


def test_tracking_is_inert_without_feature_drift():
    eng = SimulationEngine(SimConfig(scenario="channel-drift",
                                     **dict(SMALL, rounds=2, train_iters=8)),
                           device="cpu")
    rows = eng.run()
    assert all(r["n_drifted"] == 0 and r["n_dirty_pairs"] == 0
               and r["n_reestimated"] == 0 for r in rows)
    assert not eng.state.div_dirty.any() and not eng._drift_base
