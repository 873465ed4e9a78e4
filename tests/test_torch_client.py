"""The port's local training and per-device scoring against
``repro.fl.client``, given the reference's own minibatch draws.
Tolerance 1e-5 on trained weights: float32 SGD in both, with another
summation order in each step."""
import jax
import numpy as np
import pytest
import torch

from test_torch_draws import jax_train_draws
from repro.data import build_network
from repro.core.bounds import hypothesis_disagreement
from repro.fl import client as jclient
from repro_torch import convert
from repro_torch.fl import client


@pytest.fixture(scope="module")
def net():
    devs = build_network("M//MM", num_devices=3, samples_per_device=16,
                         seed=0)
    return devs, jclient.stack_clients(devs), \
        client.stack_clients(devs, device="cpu")


def test_train_sources_matches_given_reference_draws(net):
    _, jc, tc = net
    iters, batch = 5, 10
    p0 = jclient.init_client_params(3, jax.random.PRNGKey(2))
    keys = jax.random.split(jax.random.PRNGKey(3), 3)
    ref = jclient.train_sources(p0, jc, keys, iters=iters, batch=batch,
                                lr=0.05)
    draws = jax_train_draws(jc, keys, iters=iters, batch=batch)
    out = client.train_sources(
        convert.params_from_jax(jax.tree_util.tree_map(np.asarray, p0),
                                "cpu"), tc,
        iters=iters, batch=batch, lr=0.05, draws=draws)
    moved = 0.0
    for k in out:
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]),
                                   rtol=1e-5, atol=1e-5, err_msg=k)
        moved += float(np.abs(np.asarray(ref[k]) - np.asarray(p0[k])).max())
    assert moved > 1e-3          # the steps did something
    tp = convert.params_from_jax(jax.tree_util.tree_map(np.asarray, ref),
                                 "cpu")
    np.testing.assert_array_equal(
        client.empirical_errors(tp, tc).numpy(),
        np.asarray(jclient.empirical_errors(ref, jc)))
    np.testing.assert_array_equal(
        client.true_accuracies(tp, tc).numpy(),
        np.asarray(jclient.true_accuracies(ref, jc)))


def test_own_draws_stay_on_labeled_rows(net):
    _, _, tc = net
    draws = client.sample_train_indices(
        tc, torch.Generator().manual_seed(0), iters=40, batch=10)
    assert draws.shape == (3, 40, 10)
    for i in range(3):
        rows = draws[i].flatten()
        sel = tc.labeled[i] if tc.labeled[i].any() else tc.valid[i]
        assert bool(sel[rows].all())
        assert len(torch.unique(rows)) > 1


def test_init_client_params_shared_and_not():
    gen = torch.Generator().manual_seed(0)
    p = client.init_client_params(4, gen, device="cpu")
    assert torch.equal(p["conv1"][0], p["conv1"][3])
    q = client.init_client_params(2, gen, shared_init=False, device="cpu")
    assert not torch.equal(q["conv1"][0], q["conv1"][1])


def test_pairwise_disagreement_is_eq4_for_every_pair(net):
    devs, _, tc = net
    p = client.init_client_params(3, torch.Generator().manual_seed(5),
                                  shared_init=False, device="cpu")
    d = client.pairwise_disagreement(p, tc).numpy()
    x = torch.as_tensor(np.concatenate([dv.images for dv in devs]))
    from repro_torch.fl import cnn
    preds = [torch.argmax(cnn.cnn_forward({k: v[i] for k, v in p.items()},
                                          x), -1).numpy() for i in range(3)]
    for i in range(3):
        for j in range(3):
            assert d[i, j] == pytest.approx(
                hypothesis_disagreement(preds[i], preds[j]), abs=1e-7)
