"""The FADA baseline and the paper's comparison matrix on the port
against ``repro.fl.baselines`` / ``repro.fl.round.run_all_baselines`` on
the same network, with the reference's row draws injected."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_draws import jax_pair_draws
from repro.core.bounds import BoundTerms as JBoundTerms
from repro.data import build_network
from repro.fl import baselines as jbl
from repro.fl import cnn as jcnn
from repro.fl import round as jround
from repro_torch import convert
from repro_torch.core.bounds import BoundTerms
from repro_torch.core.energy import EnergyModel
from repro_torch.fl import baselines as bl, round as tround

SOLVER = dict(max_outer=4, inner_steps=300)
FADA = dict(iters=40, batch=16, lr=0.05)      # fada_alpha's defaults


@pytest.fixture(scope="module")
def states():
    """The reference's prepared round (the ``test_torch_slice`` network:
    two sources, two targets) and the port's RoundState on the same
    clients, parameters and measurements."""
    devs = build_network("M//MM", num_devices=4, samples_per_device=40,
                         seed=2, label_subset=[0, 1, 2, 3])
    ref = jround.prepare_round(devs, jax.random.PRNGKey(0), train_iters=10,
                               div_tau=1, div_T=3)
    c = convert.clients_from_numpy(ref.clients, "cpu")
    params = convert.params_from_jax(
        jax.tree_util.tree_map(np.asarray, ref.params), "cpu")
    energy = EnergyModel(K=ref.energy.K, eps_e=ref.energy.eps_e)
    out = tround.RoundState(
        clients=c, params=params, eps_hat=ref.eps_hat, div_hat=ref.div_hat,
        energy=energy, bounds=tround.make_bounds(c, ref.eps_hat,
                                                 ref.div_hat))
    assert isinstance(ref.bounds, JBoundTerms)
    assert isinstance(out.bounds, BoundTerms)
    return ref, out


def _fada_pairs(psi):
    ss, tt = np.meshgrid(np.flatnonzero(psi == 0.0),
                         np.flatnonzero(psi == 1.0), indexing="ij")
    return ss.ravel(), tt.ravel()


def _jax_fada_draws(clients, psi, key):
    """The rows ``repro.fl.baselines._domain_gap`` draws for fada_alpha's
    pairs: lane p from ``split(key, P)[p]``, per step a split into the
    source's and the target's key."""
    si, ti = _fada_pairs(psi)
    keys = jax.random.split(key, len(si))
    return jax_pair_draws(np.asarray(clients.counts), si, ti, keys,
                          steps=FADA["iters"], batch=FADA["batch"])


@functools.partial(jax.jit, static_argnames=("iters", "batch", "lr"))
def _jax_discriminator(fp, flat_x, n_max, s, t, counts, key, *, iters,
                       batch, lr):
    """The (w, b) that ``_domain_gap``'s scan trains for one pair, with
    its own step written out (the reference returns only the gap)."""
    def loss(wb, f, y):
        logits = f @ wb[0] + wb[1]
        logz = jax.nn.logsumexp(logits, axis=-1)
        return jnp.mean(logz - jnp.take_along_axis(logits, y[:, None],
                                                   axis=-1)[:, 0])

    def step(wb, kt):
        ks, ktt = jax.random.split(kt)
        ri = jax.random.randint(ks, (batch,), 0, counts[s])
        rj = jax.random.randint(ktt, (batch,), 0, counts[t])
        f = jcnn.cnn_features(fp, jnp.concatenate(
            [flat_x[s * n_max + ri], flat_x[t * n_max + rj]]))
        y = jnp.concatenate([jnp.zeros(batch, jnp.int32),
                             jnp.ones(batch, jnp.int32)])
        g = jax.grad(loss)(wb, f, y)
        return (wb[0] - lr * g[0], wb[1] - lr * g[1]), None

    wb0 = (jnp.zeros((jcnn.FC_HIDDEN, 2)), jnp.zeros((2,)))
    wb, _ = jax.lax.scan(step, wb0, jax.random.split(key, iters))
    return wb


def test_domain_gap_matches_reference(states):
    ref, out = states
    psi = np.array([0.0, 0.0, 1.0, 1.0])
    si, ti = _fada_pairs(psi)
    key = jax.random.PRNGKey(5)
    gaps_ref = np.asarray(jbl._domain_gap(
        ref.params, ref.clients, jnp.asarray(si), jnp.asarray(ti), key,
        **FADA))
    draws = _jax_fada_draws(ref.clients, psi, key)
    gaps, w, b = bl._domain_gap(out.params, out.clients, si, ti, draws=draws,
                                **FADA)
    np.testing.assert_array_equal(gaps.numpy(), gaps_ref)
    n_dev, n_max = ref.clients.x.shape[:2]
    flat_x = jnp.reshape(ref.clients.x, (n_dev * n_max,)
                         + ref.clients.x.shape[2:])
    for p, k in enumerate(jax.random.split(key, len(si))):
        fp = jax.tree_util.tree_map(lambda a: a[si[p]], ref.params)
        wj, bj = _jax_discriminator(fp, flat_x, n_max, int(si[p]),
                                    int(ti[p]), ref.clients.counts, k,
                                    **FADA)
        np.testing.assert_allclose(w[p].numpy(), np.asarray(wj), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(b[p].numpy(), np.asarray(bj), rtol=1e-5,
                                   atol=1e-5)
    assert np.all((gaps_ref >= 0) & (gaps_ref <= 2))


@pytest.mark.parametrize("psi", [[0, 0, 1, 1], [0, 1, 1, 1], [1, 1, 1, 1]])
def test_fada_alpha_matches_reference(states, psi):
    ref, out = states
    psi = np.asarray(psi, float)
    key = jax.random.PRNGKey(7)
    a_ref = jbl.fada_alpha(psi, ref.params, ref.clients, key)
    a = bl.fada_alpha(psi, out.params, out.clients,
                      draws=_jax_fada_draws(ref.clients, psi, key))
    np.testing.assert_allclose(a, a_ref, atol=1e-6)
    tg = psi == 1.0
    if (psi == 0.0).any():
        np.testing.assert_allclose(a[:, tg].sum(0), 1.0)


def test_fada_alpha_from_a_seed(states):
    _, out = states
    psi = np.array([0.0, 0.0, 1.0, 1.0])
    a = bl.fada_alpha(psi, out.params, out.clients, 3)
    np.testing.assert_array_equal(
        a, bl.fada_alpha(psi, out.params, out.clients, 3))
    np.testing.assert_allclose(a[:, 2:].sum(0), 1.0)
    assert not a[:, :2].any() and not a[2:].any()
    with pytest.raises(ValueError, match="draws"):
        bl._domain_gap(out.params, out.clients, [0], [2],
                       draws=torch.zeros((1, 3, 2, 16), dtype=torch.int64),
                       **FADA)


@pytest.fixture(scope="module")
def matrices(states):
    ref, out = states
    b = jround.run_stlf(ref, **SOLVER)
    a = tround.run_stlf(out, **SOLVER)
    np.testing.assert_array_equal(a.psi, b.psi)
    key = jax.random.PRNGKey(1)
    k1, k2 = jax.random.split(key)
    hpsi = jbl.heuristic_psi(ref.clients)
    draws = (_jax_fada_draws(ref.clients, b.psi, k1),
             _jax_fada_draws(ref.clients, hpsi, k2))
    return (jround.run_all_baselines(ref, b, key, seed=0),
            tround.run_all_baselines(out, a, 1, seed=0, fada_draws=draws))


NUMPY_METHODS = ["Rnd-alpha", "FedAvg", "AvgD", "Rnd-psi", "psi-FedAvg",
                 "SM"]


@pytest.mark.parametrize("name", NUMPY_METHODS + ["FADA", "psi-FADA"])
def test_run_all_baselines_matches_reference(matrices, name):
    ref, out = matrices
    assert list(out) == list(ref)
    a, b = out[name], ref[name]
    assert a.name == b.name == name
    np.testing.assert_array_equal(a.psi, b.psi)
    np.testing.assert_array_equal(a.per_device_acc, b.per_device_acc)
    if name in NUMPY_METHODS:
        np.testing.assert_array_equal(a.alpha, b.alpha)
    else:
        np.testing.assert_allclose(a.alpha, b.alpha, atol=1e-3)
    assert a.transmissions == b.transmissions
    np.testing.assert_allclose(a.energy, b.energy, rtol=1e-3)
    np.testing.assert_equal(a.target_acc, b.target_acc)


def test_the_matrix_exercises_fada(matrices):
    _, out = matrices
    for name in ("FADA", "psi-FADA"):
        r = out[name]
        assert 0 < r.psi.sum() < len(r.psi), name   # sources and targets
        assert r.transmissions > 0, name
