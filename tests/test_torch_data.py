"""The port's numpy copies (data, bounds, energy, problem) against the
JAX package's originals: exactly equal for the same seeds."""
import numpy as np
import pytest

from repro.core.bounds import BoundTerms as JBoundTerms
from repro.core.energy import EnergyModel as JEnergyModel
from repro.core.problem import STLFProblem as JSTLFProblem
from repro.data import digits as jdigits
from repro.data import partition as jpartition
from repro_torch.core.bounds import BoundTerms
from repro_torch.core.energy import EnergyModel
from repro_torch.core.problem import STLFProblem
from repro_torch.data import digits, partition


def _assert_devices_equal(a, b):
    assert len(a) == len(b)
    for da, db in zip(a, b):
        for f in ("images", "labels", "labeled_mask", "domain_ids",
                  "true_labels"):
            np.testing.assert_array_equal(getattr(da, f), getattr(db, f),
                                          err_msg=f)


@pytest.mark.parametrize("domain", ["M", "U", "MM"])
def test_render_images_equal(domain):
    labels = np.array([0, 3, 7, 9, 1])
    np.testing.assert_array_equal(
        digits.render_images(labels, domain, seed=5),
        jdigits.render_images(labels, domain, seed=5))


@pytest.mark.parametrize("setting", ["M//MM", "M+MM", "U"])
def test_build_network_equal(setting):
    kw = dict(num_devices=4, samples_per_device=12, seed=3)
    _assert_devices_equal(partition.build_network(setting, **kw),
                          jpartition.build_network(setting, **kw))


@pytest.mark.parametrize("setting", ["M//U", "M+MM", "MM"])
def test_make_device_equal(setting):
    kw = dict(samples_per_device=10, seed=7, labeled_ratio=0.4)
    _assert_devices_equal(
        [partition.make_device(setting, **kw,
                               rng=np.random.default_rng(1))],
        [jpartition.make_device(setting, **kw,
                                rng=np.random.default_rng(1))])


def test_interpolate_features_equal():
    dev = partition.build_network("M", num_devices=2, samples_per_device=8,
                                  seed=0)[0]
    alt = digits.render_images(dev.true_labels, "MM", seed=11)
    _assert_devices_equal([partition.interpolate_features(dev, alt, 0.3)],
                          [jpartition.interpolate_features(dev, alt, 0.3)])


def _inputs(n=5, seed=0):
    rng = np.random.default_rng(seed)
    eps = rng.uniform(0.05, 1.0, n)
    div = rng.uniform(0.0, 1.5, (n, n))
    div = 0.5 * (div + div.T)
    np.fill_diagonal(div, 0.0)
    return eps, rng.integers(20, 400, n), div


def test_energy_sample_equal():
    a = EnergyModel.sample(6, np.random.default_rng(4))
    b = JEnergyModel.sample(6, np.random.default_rng(4))
    np.testing.assert_array_equal(a.K, b.K)
    alpha = np.random.default_rng(0).uniform(0, 1, (6, 6))
    assert a.energy(alpha) == b.energy(alpha)
    assert a.transmissions(alpha) == b.transmissions(alpha)


def test_bound_terms_equal():
    eps, n_data, div = _inputs()
    a, b = BoundTerms(eps, n_data, div), JBoundTerms(eps, n_data, div)
    np.testing.assert_array_equal(a.S(), b.S())
    np.testing.assert_array_equal(a.T(), b.T())


def test_problem_equal():
    eps, n_data, div = _inputs(seed=2)
    energy = EnergyModel.sample(5, np.random.default_rng(9))
    a = STLFProblem(BoundTerms(eps, n_data, div), energy, phi_e=3.0)
    b = JSTLFProblem(JBoundTerms(eps, n_data, div), JEnergyModel(energy.K),
                     phi_e=3.0)
    np.testing.assert_array_equal(a.feasible_start(), b.feasible_start())
    rng = np.random.default_rng(1)
    psi = (rng.random(5) < 0.5).astype(float)
    alpha = rng.uniform(0, 1, (5, 5))
    assert a.objective(psi, alpha) == b.objective(psi, alpha)
    np.testing.assert_array_equal(a.start_from(psi, alpha),
                                  b.start_from(psi, alpha))


def test_numpy_baselines_equal():
    from repro.fl import baselines as jbl
    from repro_torch.fl import baselines as bl
    rng = np.random.default_rng(3)
    div = rng.uniform(0, 1, (6, 6))
    stlf_alpha = rng.uniform(0, 1, (6, 6))
    for seed in range(3):
        a, b = np.random.default_rng(seed), np.random.default_rng(seed)
        psi = bl.random_psi(6, a)
        np.testing.assert_array_equal(psi, jbl.random_psi(6, b))
        np.testing.assert_array_equal(bl.rnd_alpha(psi, a),
                                      jbl.rnd_alpha(psi, b))
        np.testing.assert_array_equal(
            bl.avg_degree_alpha(psi, stlf_alpha, a),
            jbl.avg_degree_alpha(psi, stlf_alpha, b))
        np.testing.assert_array_equal(bl.single_matching_alpha(psi, div),
                                      jbl.single_matching_alpha(psi, div))


def test_heuristic_psi_and_fedavg_equal():
    from repro.fl import baselines as jbl
    from repro.fl.client import stack_clients as jstack
    from repro_torch.fl import baselines as bl
    from repro_torch.fl.client import stack_clients
    devs = partition.build_network("M//MM", num_devices=5,
                                   samples_per_device=10, seed=4)
    jc, tc = jstack(devs), stack_clients(devs, device="cpu")
    psi = bl.heuristic_psi(tc)
    np.testing.assert_array_equal(psi, jbl.heuristic_psi(jc))
    psi[0] = 1.0 - psi[0]
    np.testing.assert_array_equal(bl.fedavg_alpha(psi, tc),
                                  jbl.fedavg_alpha(psi, jc))
