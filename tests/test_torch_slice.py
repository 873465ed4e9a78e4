"""The whole slice — prepare_round -> run_stlf -> evaluate_assignment —
on the port against ``repro.fl.round`` on the same network, with the
reference's initialization and row draws injected; plus the port's
import boundary and its refusal to fall back to the CPU."""
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from test_torch_draws import jax_round_inputs
from repro.data import build_network
from repro.fl import round as jround
from repro.fl.client import stack_clients as jstack_clients
from repro_torch import convert
from repro_torch.fl import baselines, round as tround

SOLVER = dict(max_outer=4, inner_steps=300)


@pytest.fixture(scope="module")
def states():
    n, iters, tau, T = 4, 10, 1, 3
    # quickstart's label subset; this seed gives two sources, two targets
    devs = build_network("M//MM", num_devices=n, samples_per_device=40,
                         seed=2, label_subset=[0, 1, 2, 3])
    key = jax.random.PRNGKey(0)
    ref = jround.prepare_round(devs, key, train_iters=iters, div_tau=tau,
                               div_T=T)
    p0, train, h0, div = jax_round_inputs(
        n, jstack_clients(devs), key, train_iters=iters, batch=10,
        tau=tau, T=T)
    out = tround.prepare_round(
        devs, 0, train_iters=iters, div_tau=tau, div_T=T, device="cpu",
        params0=convert.params_from_jax(p0, "cpu"), train_draws=train,
        div_h0=convert.params_from_jax(h0, "cpu"), div_draws=div)
    return ref, out


def test_prepare_round_matches(states):
    ref, out = states
    for k in ref.params:
        np.testing.assert_allclose(out.params[k].numpy(),
                                   np.asarray(ref.params[k]),
                                   rtol=1e-5, atol=1e-5, err_msg=k)
    np.testing.assert_array_equal(out.eps_hat, ref.eps_hat)
    np.testing.assert_allclose(out.div_hat, ref.div_hat, atol=1e-5)
    np.testing.assert_array_equal(out.energy.K, ref.energy.K)
    np.testing.assert_array_equal(out.bounds.T(), ref.bounds.T())


def test_run_stlf_and_transfer_match(states):
    ref, out = states
    a = tround.run_stlf(out, **SOLVER)
    b = jround.run_stlf(ref, **SOLVER)
    np.testing.assert_array_equal(a.psi, b.psi)
    np.testing.assert_allclose(a.alpha, b.alpha, atol=1e-3)
    np.testing.assert_array_equal(a.per_device_acc, b.per_device_acc)
    assert a.transmissions == b.transmissions
    assert 0.0 < a.psi.sum() < len(a.psi)      # the transfer was exercised
    # a baseline assignment goes through the same transfer
    from repro.fl import baselines as jbl
    fa = tround.evaluate_assignment(
        out, "FedAvg", a.psi, baselines.fedavg_alpha(a.psi, out.clients))
    fb = jround.evaluate_assignment(
        ref, "FedAvg", b.psi, jbl.fedavg_alpha(b.psi, ref.clients))
    np.testing.assert_array_equal(fa.alpha, fb.alpha)
    np.testing.assert_array_equal(fa.per_device_acc, fb.per_device_acc)


def test_port_imports_neither_jax_nor_repro():
    code = (
        "import pkgutil, sys, importlib, repro_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages("
        "repro_torch.__path__, 'repro_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "assert len(mods) > 20, mods\n"
        "need = {'repro_torch.sim.run', 'repro_torch.sim.engine', "
        "'repro_torch.sim.executors', 'repro_torch.sim.shard.pool', "
        "'repro_torch.sim.trace.events', 'repro_torch.stlf_federated'}\n"
        "assert need <= set(mods), need - set(mods)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro')]\n"
        "print(len(mods), bad)\n"
        "sys.exit(1 if bad else 0)\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_entry_points_refuse_silent_cpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    devs = build_network("M//MM", num_devices=2, samples_per_device=4,
                         seed=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tround.prepare_round(devs, 0, train_iters=1)
    from repro_torch import quickstart, stlf_federated
    with pytest.raises(RuntimeError, match="no CUDA device"):
        quickstart.main([])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        stlf_federated.main([])
    from repro_torch.sim import SimConfig, SimulationEngine, run
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SimulationEngine(SimConfig(devices=2, samples_per_device=4))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run.main(["--rounds", "0", "--quiet", "--out", os.devnull])
