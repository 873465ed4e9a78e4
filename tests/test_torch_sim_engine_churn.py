"""The simulator's membership scenarios (``device-churn``: leaves, spare
joins and the rejoin re-seed; ``label-arrival``: label reveals and the
restack) and the exhaustive divergence refresh (``div_refresh='all'``)
on the port against a live ``repro.sim`` run of the same SimConfig; the
parity harness and its tolerances are ``test_torch_sim_engine.py``'s."""
import pytest

from test_torch_sim_engine import check_scenario


def test_device_churn_matches_reference():
    rows = check_scenario("device-churn")
    assert any(e["event"] == "join" for r in rows for e in r["events"])
    assert "membership" in [r["resolve_reason"] for r in rows]


def test_label_arrival_matches_reference():
    rows = check_scenario("label-arrival")
    assert any(e["event"] == "labels" for r in rows for e in r["events"])


def test_div_refresh_all_matches_reference():
    """Every active pair re-measured each round after the bootstrap, on
    the reference's content-addressed keys and init (injected)."""
    from test_torch_sim_engine import SMALL
    rows = check_scenario("static", div_refresh="all")
    n = SMALL["devices"]
    assert [r["n_reestimated"] for r in rows] == \
        [0] + [n * (n - 1) // 2] * (SMALL["rounds"] - 1)


@pytest.mark.parametrize("scenario", ["device-churn", "label-arrival"])
def test_port_seeds_are_deterministic(scenario):
    """Without injected draws the port draws from its own seeds: two runs
    of one config give the same rows, wall clocks aside."""
    from repro_torch.sim import SimConfig, SimulationEngine
    from repro_torch.sim.metrics import strip_nondeterministic
    from test_torch_sim_engine import SMALL
    cfg = dict(SMALL, rounds=2, train_iters=8)
    a, b = (SimulationEngine(SimConfig(scenario=scenario, **cfg),
                             device="cpu").run() for _ in range(2))
    sa, sb = strip_nondeterministic(a), strip_nondeterministic(b)
    assert str(sa) == str(sb)                       # NaN-aware via repr


def test_div_refresh_all_remeasures_every_active_pair():
    """``div_refresh='all'`` (the reference's naive refresh) re-measures
    every active pair each round after the bootstrap, on the port's
    content-addressed seeds, and the estimates stay symmetric."""
    import numpy as np
    from repro_torch.sim import SimConfig, SimulationEngine
    from test_torch_sim_engine import SMALL
    eng = SimulationEngine(SimConfig(scenario="static", div_refresh="all",
                                     **dict(SMALL, rounds=2, train_iters=8)),
                           device="cpu")
    rows = eng.run()
    n = SMALL["devices"]
    assert [r["n_reestimated"] for r in rows] == [0, n * (n - 1) // 2]
    div = eng.state.div_hat
    np.testing.assert_array_equal(div, div.T)
    assert (eng.state.div_tick[np.triu_indices(n, 1)] == 1).all()
