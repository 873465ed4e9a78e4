"""The port's Algorithm-1 estimator against ``repro.fl.divergence``,
given the reference's own row draws: pair values, chunk-width
invariance, the EMA merge of ``update_divergences`` and
``budget_pairs``."""
import jax
import numpy as np
import pytest

from test_torch_draws import jax_pair_draws
from repro.data import build_network
from repro.fl import cnn as jcnn
from repro.fl import divergence as jdiv
from repro.fl.client import stack_clients as jstack_clients
from repro_torch import convert
from repro_torch.fl import divergence
from repro_torch.fl.client import stack_clients

BATCH, LR = 10, 0.05


@pytest.fixture(scope="module")
def net():
    devs = build_network("M//MM", num_devices=4, samples_per_device=14,
                         seed=1)
    jc = jstack_clients(devs)
    h0 = jax.tree_util.tree_map(
        np.asarray, jcnn.cnn_init(jax.random.PRNGKey(7), num_classes=2))
    return jc, stack_clients(devs, device="cpu"), h0


def _ref_draws(jc, pi, pj, keys, steps):
    return jax_pair_draws(np.asarray(jc.counts), pi, pj, keys,
                          steps=steps, batch=BATCH)


@pytest.mark.parametrize("tau,T", [(1, 3), (2, 2)])
def test_pair_values_match_given_reference_draws(net, tau, T):
    jc, tc, h0 = net
    pi, pj = np.array([0, 1, 0]), np.array([1, 2, 3])
    keys = jax.random.split(jax.random.PRNGKey(tau), 3)
    ref = np.asarray(jdiv.pairwise_divergence_values(
        h0, jc, pi, pj, keys, tau=tau, T=T, batch=BATCH, lr=LR))
    out = divergence.pairwise_divergence_values(
        convert.params_from_jax(h0, "cpu"), tc, pi, pj, tau=tau, T=T,
        batch=BATCH, lr=LR, draws=_ref_draws(jc, pi, pj, keys, tau * T))
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5)


def test_chunk_width_never_changes_a_value(net):
    _, tc, h0 = net
    th0 = convert.params_from_jax(h0, "cpu")
    pi, pj = np.triu_indices(4, k=1)
    keys = divergence.pair_keys(11, len(pi))

    def call(ci, cj, ck):
        return divergence.pairwise_divergence_values(
            th0, tc, ci, cj, ck, tau=1, T=2, batch=BATCH, lr=LR)

    full = divergence.chunked_pair_lanes(pi, pj, keys, len(pi), call)
    for width in (1, 4):             # width 4 pads the last chunk of 2
        np.testing.assert_array_equal(
            divergence.chunked_pair_lanes(pi, pj, keys, width, call), full)


def test_pair_keys_schedule():
    assert np.array_equal(divergence.pair_keys(3, 5),
                          divergence.pair_keys(3, 5, pair_chunk=8))
    a = divergence.pair_keys(3, 10, pair_chunk=4)
    assert len(a) == 10 and len(np.unique(a)) == 10
    # chunk c's lanes depend on c alone: a longer schedule extends it
    assert np.array_equal(divergence.pair_keys(3, 12, pair_chunk=4)[:10], a)


def test_update_divergences_ema_merge_matches_reference(net):
    jc, tc, h0 = net
    pairs = np.array([[2, 0], [1, 3]])
    keys = jax.random.split(jax.random.PRNGKey(9), 2)
    rng = np.random.default_rng(0)
    div = rng.uniform(0, 1, (4, 4))
    div = div + div.T
    np.fill_diagonal(div, 0.0)
    kw = dict(tau=1, T=2, batch=BATCH, lr=LR)
    draws = _ref_draws(jc, np.array([0, 1]), np.array([2, 3]), keys, 2)
    for ema in (0.0, 0.25, np.array([0.5, 0.1])):
        ref = jdiv.update_divergences(div, jc, None, pairs, ema=ema,
                                      keys=keys, h0=h0, **kw)
        out = divergence.update_divergences(
            div, tc, None, pairs, ema=ema, draws=draws,
            h0=convert.params_from_jax(h0, "cpu"), **kw)
        np.testing.assert_allclose(out, ref, atol=1e-6)
        untouched = np.ones((4, 4), bool)
        untouched[[2, 0, 1, 3], [0, 2, 3, 1]] = False
        np.testing.assert_array_equal(out[untouched], div[untouched])


def test_estimate_divergences_symmetric_and_seeded(net):
    _, tc, _ = net
    a = divergence.estimate_divergences(tc, 4, tau=1, T=2, batch=BATCH)
    b = divergence.estimate_divergences(tc, 4, tau=1, T=2, batch=BATCH)
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(a, a.T)
    assert np.all(np.diag(a) == 0) and np.all((a >= 0) & (a <= 2))


def test_budget_pairs_matches_reference():
    rng = np.random.default_rng(2)
    tick = rng.integers(-1, 5, (6, 6))
    pairs = np.array([[0, 1], [2, 5], [1, 4], [3, 4], [0, 5]])
    for budget in (0, 2, 10):
        np.testing.assert_array_equal(
            divergence.budget_pairs(pairs, tick, budget),
            jdiv.budget_pairs(pairs, tick, budget))
    assert divergence.budget_pairs(np.zeros((0, 2)), tick, 3).shape == (0, 2)
