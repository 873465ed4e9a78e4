"""ST-LF over LM clients: ``repro_torch.stlf_lm_clients`` against
``examples/stlf_lm_clients.py`` (imported as a module, not edited), piece
by piece with JAX's draws injected: local training, the error proxy, one
Algorithm-1 pair, the solve on the bounds JAX's own run produced, and
the transfer.  Then one whole port run on its own draws, held to the
decisions JAX's run also shows.  The fp32 cases swap both modules' LM for
its fp32 variant through ``monkeypatch``."""
import dataclasses
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import (BoundTerms as JBounds, EnergyModel as JEnergy,
                        STLFProblem as JProblem)
from repro.core.solver import solve_stlf as jsolve
from repro.fl.transfer import apply_transfer as japply
from repro.models.api import build_model as jbuild_model
from repro_torch import convert
from repro_torch import stlf_lm_clients as tex
from repro_torch.core import (BoundTerms, EnergyModel, STLFProblem,
                              solve_stlf)
from repro_torch.fl.transfer import apply_transfer
from repro_torch.models.api import build_model
from repro_torch.nn.param import tree_leaves

torch.set_num_threads(2)          # six test workers share the box

_spec = importlib.util.spec_from_file_location(
    "jax_stlf_lm_clients",
    Path(__file__).resolve().parents[1] / "examples" / "stlf_lm_clients.py")
jex = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(jex)

# JAX's run of examples/stlf_lm_clients.py on the CPU (jax 0.9.0): the
# bounds it handed to solve_stlf and what it decided
JAX_EPS_HAT = [0.6626461681903597, 0.6664579122080985, 0.6547581798515911,
               0.658961087601166, 0.7846429068595907, 0.784815844808084]
JAX_DIV = [[0.0, 0.0, 1.0, 1.5, 0.0, 1.5], [0.0, 0.0, 1.5, 1.0, 0.0, 1.0],
           [1.0, 1.5, 0.0, 0.5, 2.0, 0.5], [1.5, 1.0, 0.5, 0.0, 2.0, 0.5],
           [0.0, 0.0, 2.0, 2.0, 0.0, 0.5], [1.5, 1.0, 0.5, 0.5, 0.5, 0.0]]
JAX_PSI = [0, 0, 0, 0, 1, 0]


@pytest.fixture
def fp32(monkeypatch):
    """Both modules' LM in fp32 compute."""
    jcfg = dataclasses.replace(jex.cfg, dtype="float32")
    tcfg = dataclasses.replace(tex.cfg, dtype="float32")
    monkeypatch.setattr(jex, "cfg", jcfg)
    monkeypatch.setattr(jex, "model", jbuild_model(jcfg))
    monkeypatch.setattr(tex, "cfg", tcfg)
    monkeypatch.setattr(tex, "model", build_model(tcfg))


def _carry(tree):
    return convert.lm_params_from_jax(
        jax.tree_util.tree_map(np.asarray, tree), "cpu")


def _assert_tree_close(port, ref, **tol):
    for a, b in zip(tree_leaves(port), jax.tree_util.tree_leaves(ref)):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), **tol)


def test_config_and_constants_match_jax():
    assert dataclasses.asdict(tex.cfg) == dict(
        dataclasses.asdict(jex.cfg), attention_impl="dot")
    for k in ("N_DEV", "DOMAIN", "RICH", "SEQ", "BATCH", "TRAIN_ITERS"):
        assert getattr(tex, k) == getattr(jex, k)
    n = sum(x.size for x in jax.tree_util.tree_leaves(
        jex.model.init(jax.random.PRNGKey(0))))
    assert n == 590_464                      # S = T = 6 clients of this P
    for d in range(6):
        for seed in (1, 777, 9001):
            t, l = tex.batches(d, seed)
            jt, jl = jex.batches(d, seed)
            np.testing.assert_array_equal(t.numpy(), jt)
            np.testing.assert_array_equal(l.numpy(), jl)


def test_local_train_matches_jax(fp32):
    init = jex.model.init(jax.random.PRNGKey(0))
    jp, jl = jex.local_train(init, 1, 3)
    tp, tl = tex.local_train(_carry(init), 1, 3)
    assert abs(tl - jl) <= 1e-4
    # the parameters' change in a relative norm (as the train step's
    # test holds it): Adam turns a near-zero gradient whose sign differs
    # with summation order into a full step of the learning rate
    for a, b, c in zip(tree_leaves(tp), jax.tree_util.tree_leaves(jp),
                       jax.tree_util.tree_leaves(init)):
        dj = np.asarray(b, np.float64) - np.asarray(c, np.float64)
        dt = a.double().numpy() - np.asarray(c, np.float64)
        assert np.linalg.norm(dt - dj) <= 1e-3 * np.linalg.norm(dj)


@pytest.mark.parametrize("precision,tol", [("fp32", 1e-5), ("bf16", 2e-3)])
def test_eval_error_matches_jax(request, precision, tol):
    if precision == "fp32":
        request.getfixturevalue("fp32")
    p = jex.model.init(jax.random.PRNGKey(3))
    for d in (0, 5):
        assert abs(tex.eval_error(_carry(p), d) - jex.eval_error(p, d)) \
            <= tol


def _jax_head(params, i, j):
    """JAX's 15 head steps of examples/stlf_lm_clients.algorithm1_lm for
    pair (i, j), whose head the example does not return."""
    def feats(toks):
        return jnp.tanh(jex.model.prefill(params, {"tokens": toks})[:, 0,
                                                                     :64])

    def loss_fn(hd, fi, fj):
        lg = jnp.concatenate([fi @ hd["w"] + hd["b"], fj @ hd["w"] + hd["b"]])
        y = jnp.concatenate([jnp.zeros(4, jnp.int32), jnp.ones(4, jnp.int32)])
        logz = jax.nn.logsumexp(lg, axis=-1)
        return jnp.mean(logz - jnp.take_along_axis(lg, y[:, None], -1)[:, 0])

    head = {"w": jnp.zeros((64, 2)), "b": jnp.zeros((2,))}
    for it in range(15):
        fi = feats(jnp.asarray(jex.batches(i, 1000 + it)[0]))
        fj = feats(jnp.asarray(jex.batches(j, 2000 + it)[0]))
        g = jax.grad(loss_fn)(head, fi, fj)
        head = {k: head[k] - 0.5 * g[k] for k in head}
    return head


def test_algorithm1_pair_matches_jax(fp32, monkeypatch):
    """One pair at its full 15 steps: JAX's algorithm1_lm over a 2-device
    network runs exactly pair (0, 1), on fold_in(PRNGKey(1), 1)."""
    monkeypatch.setattr(jex, "N_DEV", 2)
    jdiv = jex.algorithm1_lm(jax.random.PRNGKey(1))
    params = jex.model.init(jax.random.fold_in(jax.random.PRNGKey(1), 1))
    head, d = tex.classifier_pair(_carry(params), 0, 1)
    assert d == jdiv[0, 1]
    jhead = _jax_head(params, 0, 1)
    for k in ("w", "b"):
        np.testing.assert_allclose(head[k].numpy(), np.asarray(jhead[k]),
                                   atol=1e-5, rtol=1e-4)


def test_solve_on_jax_bounds_matches_jax():
    """The solve of JAX's run, on the bounds that run produced: psi
    equal, alpha within 1e-3."""
    n_data = np.where(jex.RICH, 4000, 100)
    eps, div = np.array(JAX_EPS_HAT), np.array(JAX_DIV)
    jres = jsolve(JProblem(JBounds(eps, n_data, div), JEnergy.for_tpu_links(
        6, model_bytes=4e6, link_bw=50e9)), max_outer=5, inner_steps=500)
    tres = solve_stlf(STLFProblem(BoundTerms(eps, n_data, div),
                                  EnergyModel.for_tpu_links(
                                      6, model_bytes=4e6, link_bw=50e9)),
                      max_outer=5, inner_steps=500, device="cpu")
    np.testing.assert_array_equal(jres.psi, JAX_PSI)
    np.testing.assert_array_equal(tres.psi, jres.psi)
    np.testing.assert_allclose(tres.alpha, jres.alpha, atol=1e-3)


def test_apply_transfer_matches_jax():
    keys = jax.random.split(jax.random.PRNGKey(4), 6)
    trees = [jex.model.init(k) for k in keys]
    stacked = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *trees)
    alpha = np.zeros((6, 6))
    alpha[0, 4], alpha[[1, 2], 5] = 1.0, [0.25, 0.75]
    psi = np.array([0, 0, 0, 0, 1, 1], float)
    ref = japply(stacked, jnp.asarray(alpha), jnp.asarray(psi))
    out = apply_transfer(_carry(stacked), alpha, psi)
    _assert_tree_close(out, ref, atol=1e-6, rtol=0)


def test_port_run_on_its_own_draws_decides_as_jax_does(capsys):
    """The whole pipeline on the port's own generator: decisions, not
    bits.  JAX's run shows one target (device 4, from a same-domain
    source) whose error falls after the transfer; this asserts at least
    one target, unit alpha columns there and each target's error
    falling (not that every poor device becomes a target: JAX's run
    keeps poor device 5 a source)."""
    r = tex.main(["--device", "cpu"])
    psi, alpha = r["psi"], r["alpha"]
    tgt = np.flatnonzero(psi == 1.0)
    assert len(tgt) >= 1
    np.testing.assert_allclose(alpha[:, tgt].sum(0), 1.0, atol=1e-6)
    assert sorted(r["targets"]) == tgt.tolist()
    for d, t in r["targets"].items():
        assert t["after"] < t["before"]
    assert all(np.isfinite(r["eps_hat"]))
    assert set(np.unique(r["div"])) <= {0.0, 0.5, 1.0, 1.5, 2.0}
    assert set(r["walls"]) == {"local_train_s", "algorithm1_s", "solve_s",
                               "transfer_s"}
    out = capsys.readouterr().out
    assert "psi:" in out and "target device" in out
    if not torch.cuda.is_available():          # no silent CPU run
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tex.main([])
