"""The simulator's async-gossip executor on the port against live
``repro.sim`` runs of the same SimConfig, with the reference engine's
initial parameters and its in-tick draws injected (the training rows of
``split(fold_in(key, t), P)``, the gossip pairs' Algorithm-1 draws of
``fold_in(fold_in(key, t), 1)``; ``JaxSimDraws``).  The numpy streams
(clocks, gossip pairs, the ring, scenario events) are drawn by the port
itself from the same seeds and must give the same events.

Covered: ``async-gossip`` under the uniform, ring and k-regular
topologies, the compact (``train_gather``) and masked training routes,
``stragglers``, and the staleness rung; and unit parity for
``_select_pairs``, ``_bucket``, ``_gather_pair_rows`` and the
reference's ``subset_network_step`` (``network_step`` on gathered lanes
in the port).  Tolerances are those of
``test_torch_sim_engine.py``: decision fields equal, floats within rtol
1e-6 / atol 1e-7 (NaN equal to NaN), final parameters within rtol/atol
1e-5."""
import types

import jax
import numpy as np
import pytest
import torch

from test_torch_draws import JaxSimDraws, jax_train_draws
from test_torch_sim_engine import SMALL, assert_rows_match
from repro.data import build_network as jbuild_network
from repro.fl.client import init_client_params as jinit_client_params
from repro.fl.client import stack_clients as jstack_clients
from repro.sim import executors as jexecutors
from repro.sim import training as jtraining
from repro.sim.engine import SimConfig as JSimConfig
from repro.sim.engine import SimulationEngine as JSimulationEngine
from repro.sim.shard import pool as jpool
from repro_torch import convert
from repro_torch.sim import executors, training
from repro_torch.sim.engine import SimConfig, SimulationEngine
from repro_torch.sim.shard import pool

ASYNC = dict(engine="async-gossip", rounds=5)


def run_both(scenario: str, **kw):
    """(reference rows, port rows, reference engine, port engine) of one
    SimConfig: ``SMALL`` updated with ``kw``."""
    jcfg = JSimConfig(scenario=scenario, **{**SMALL, **kw})
    ref = JSimulationEngine(jcfg)
    p0 = jax.tree_util.tree_map(np.asarray, ref.state.params)
    ref_rows = ref.run()
    cfg = SimConfig(**{f: getattr(jcfg, f) for f in
                       jcfg.__dataclass_fields__})
    eng = SimulationEngine(cfg, device="cpu", params0=p0,
                           draws=JaxSimDraws(cfg))
    return ref_rows, eng.run(), ref, eng


def check_scenario(scenario: str, **kw):
    """Every row field, the final parameters (rtol/atol 1e-5), psi and
    the divergence estimates of the two runs."""
    ref_rows, rows, ref, eng = run_both(scenario, **kw)
    assert_rows_match(ref_rows, rows)
    assert any(r["n_targets"] > 0 for r in rows), "no tick had targets"
    for k, v in eng.state.params.items():
        np.testing.assert_allclose(v.numpy(), np.asarray(ref.state.params[k]),
                                   rtol=1e-5, atol=1e-5, err_msg=k)
    np.testing.assert_array_equal(eng.state.psi, ref.state.psi)
    np.testing.assert_allclose(eng.state.div_hat, ref.state.div_hat,
                               atol=1e-6)
    np.testing.assert_array_equal(eng.state.div_known, ref.state.div_known)
    if ref.state.clocks is not None:
        for f in ("period", "phase", "last_train"):
            np.testing.assert_array_equal(getattr(eng.state.clocks, f),
                                          getattr(ref.state.clocks, f))
    return rows


@pytest.mark.parametrize("topology,gather", [
    ("uniform", True), ("ring", True), ("k-regular", True),
    ("uniform", False)])
def test_async_gossip_matches_reference(topology, gather):
    rows = check_scenario("async-gossip", gossip_topology=topology,
                          train_gather=gather, gossip_degree=4, **ASYNC)
    assert all(r["engine"] == "async-gossip" for r in rows)
    assert any(r["gossip"] for r in rows)
    # not every device trains on every tick under the (1, 2, 4) clocks
    assert any(0 < r["n_trained"] < r["n_active"] for r in rows[1:])


def test_stragglers_match_reference():
    rows = check_scenario("stragglers", straggler_p_swap=0.5, **ASYNC)
    assert rows[0]["max_staleness"] >= 0


def test_staleness_rung_matches_reference():
    """A drift threshold no measurement reaches leaves the staleness
    rung to fire the re-solves."""
    rows = check_scenario("async-gossip", resolve_patience=2,
                          resolve_threshold=1e9, **ASYNC)
    reasons = [r["resolve_reason"] for r in rows]
    assert reasons[0] == "cold" and "staleness" in reasons, reasons
    assert all(r["solve_age"] < 2 or r["resolve_reason"] == "staleness"
               for r in rows[1:])


# ------------------------------------------------------------------ units
def _stub(mod_cfg, pool_size):
    return types.SimpleNamespace(
        cfg=mod_cfg, state=types.SimpleNamespace(pool_size=pool_size,
                                                 clocks=None))


@pytest.mark.parametrize("topology", ["uniform", "ring", "k-regular"])
def test_select_pairs_match_reference(topology):
    kw = dict(devices=9, seed=3, gossip_topology=topology, gossip_degree=4,
              gossip_pairs=-1)
    ours = executors.AsyncGossipExecutor(_stub(SimConfig(**kw), 12))
    theirs = jexecutors.AsyncGossipExecutor(_stub(JSimConfig(**kw), 12))
    for ex in (ours, theirs):
        ex.setup()
    rng = np.random.default_rng(0)
    for t in range(25):
        active = np.flatnonzero(rng.random(12) < 0.7)
        a, b = ours._select_pairs(active), theirs._select_pairs(active)
        assert a == b, (t, a, b)
        flat = [d for p in a for d in p]
        assert len(flat) == len(set(flat)) and set(flat) <= set(active)
    np.testing.assert_array_equal(ours.engine.state.clocks.period,
                                  theirs.engine.state.clocks.period)
    assert ours.state_dict() == theirs.state_dict()


def test_bucket_matches_reference():
    for n in range(0, 40):
        for cap in (1, 5, 8, 33):
            for floor in (1, 4, 16):
                assert pool._bucket(n, cap, floor) == \
                    jpool._bucket(n, cap, floor), (n, cap, floor)


def test_gather_pair_rows_matches_reference():
    devs = jbuild_network("M//MM", num_devices=7, samples_per_device=12,
                          seed=2)
    jc = jstack_clients(devs)
    c = convert.clients_from_numpy(jc, "cpu")
    pi, pj = np.array([5, 1, 5]), np.array([2, 6, 1])
    width = lambda r: jpool._bucket(r, 7)                 # noqa: E731
    sub, ri, rj = pool._gather_pair_rows(c, pi, pj, width)
    jsub, jri, jrj = jpool._gather_pair_rows(jc, pi, pj, width)
    np.testing.assert_array_equal(ri, jri)
    np.testing.assert_array_equal(rj, jrj)
    for f in ("x", "y", "labeled", "valid", "true_y", "counts"):
        np.testing.assert_array_equal(getattr(sub, f).numpy(),
                                      np.asarray(getattr(jsub, f)), f)
    assert sub.n_devices == 4                  # 4 unique rows, bucket 4
    with pytest.raises(ValueError, match="width"):
        pool._gather_pair_rows(c, pi, pj, lambda r: 2)


def test_subset_network_step_matches_reference_and_masked_step():
    """The reference's compact step on gathered lanes against the port's
    (``network_step`` on the same lanes, each with its rows of the full
    pool's draws), and against the port's masked full-pool step."""
    n, iters, batch = 6, 5, 8
    devs = jbuild_network("M//MM", num_devices=n, samples_per_device=30,
                          seed=0)
    jc = jstack_clients(devs)
    p0 = jinit_client_params(n, jax.random.PRNGKey(1))
    key = jax.random.PRNGKey(5)
    keys = jax.random.split(key, n)
    active = np.array([True, True, False, True, True, True])
    g = np.array([0, 3, 4, 0])                 # padded to 4 with g[0]
    gj = jax.numpy.asarray(g)
    jp, jeps, jacc = jtraining.subset_network_step(
        jax.tree_util.tree_map(lambda a: a[gj], p0),
        jax.tree_util.tree_map(lambda a: a[gj], jc), keys[gj],
        jax.numpy.asarray(active)[gj], iters=iters, batch=batch, lr=0.01)
    c = convert.clients_from_numpy(jc, "cpu")
    params = convert.params_from_jax(
        jax.tree_util.tree_map(np.asarray, p0), "cpu")
    draws = jax_train_draws(c, keys, iters=iters, batch=batch)
    gt = torch.as_tensor(g)
    p, eps, acc = training.network_step(
        {k: v[gt] for k, v in params.items()}, pool.take_clients(c, gt),
        None, torch.as_tensor(active)[gt], iters=iters, batch=batch,
        lr=0.01, draws=draws[gt])
    for k in jp:
        np.testing.assert_allclose(p[k].numpy(), np.asarray(jp[k]),
                                   rtol=1e-5, atol=1e-5, err_msg=k)
    np.testing.assert_array_equal(eps.numpy(), np.asarray(jeps))
    np.testing.assert_array_equal(acc.numpy(), np.asarray(jacc))
    # the masked full-pool step gives the eligible lanes the same result
    elig = np.zeros(n, bool)
    elig[g] = True
    mp, meps, macc = training.network_step(
        params, c, None, torch.as_tensor(active), torch.as_tensor(elig),
        iters=iters, batch=batch, lr=0.01, draws=draws)
    for k in mp:
        np.testing.assert_allclose(mp[k].numpy()[g[:3]], p[k].numpy()[:3],
                                   rtol=1e-6, atol=1e-7, err_msg=k)
        np.testing.assert_array_equal(mp[k].numpy()[~elig],
                                      params[k].numpy()[~elig])
    np.testing.assert_array_equal(meps.numpy()[g[:3]], eps.numpy()[:3])
    np.testing.assert_array_equal(macc.numpy()[g[:3]], acc.numpy()[:3])
