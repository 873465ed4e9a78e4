"""The port's structured SCA solver against ``repro.core.solver``:
packed arrays equal, the structured loss pointwise (rtol 1e-5, float32
with another summation order), whole solves with identical psi and alpha
within 1e-3 (the bar of ``tests/test_solver_packing.py``), and the
numpy polish exact."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import solver as jsolver
from repro.core.bounds import BoundTerms as JBoundTerms
from repro.core.energy import EnergyModel as JEnergyModel
from repro.core.problem import STLFProblem as JSTLFProblem
from repro_torch.core import solver
from repro_torch.core.bounds import BoundTerms
from repro_torch.core.energy import EnergyModel
from repro_torch.core.problem import STLFProblem

torch.set_num_threads(2)          # six test workers share the box


def _problems(n, seed=0, **kw):
    rng = np.random.default_rng(seed)
    eps = rng.uniform(0.05, 1.0, n)
    div = rng.uniform(0.1, 1.5, (n, n))
    div = 0.5 * (div + div.T)
    np.fill_diagonal(div, 0.0)
    energy = EnergyModel.sample(n, rng)
    nd = np.full(n, 5000)
    return (STLFProblem(BoundTerms(eps, nd, div), energy, **kw),
            JSTLFProblem(JBoundTerms(eps, nd, div), JEnergyModel(energy.K),
                         **kw))


@pytest.mark.parametrize("kw", [{}, dict(phi_e=0.0)])
def test_build_structured_arrays_equal(kw):
    tp, jp = _problems(5, seed=1, **kw)
    a = solver.build_structured(tp, device="cpu")
    b = jsolver.build_structured(jp)
    for name, x, y in zip(a._fields, a, b):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y),
                                      err_msg=name)


def test_structured_loss_pointwise():
    tp, jp = _problems(6, seed=2)
    sp_t = solver.build_structured(tp, device="cpu")
    sp_j = jsolver.build_structured(jp)
    rng = np.random.default_rng(0)
    z0 = np.log(tp.feasible_start()).astype(np.float32)
    aff_t = solver._structured_affine(sp_t, torch.as_tensor(z0))
    aff_j = jsolver._structured_affine(sp_j, jnp.asarray(z0))
    for _ in range(4):
        z = (z0 + rng.normal(0, 0.3, z0.shape)).astype(np.float32)
        zt, zj = torch.as_tensor(z), jnp.asarray(z)
        for r in (1.0, 50.0):
            vj = jsolver._structured_violations(sp_j, aff_j, zj)
            ref = float(jsolver._structured_objective(sp_j, aff_j, zj)
                        + sum(r * jnp.sum(jnp.square(v))
                              + 10.0 * r * jnp.sum(v) for v in vj))
            out = float(solver._structured_loss(sp_t, aff_t, zt, r))
            assert out == pytest.approx(ref, rel=1e-5)
        for vt, vj_ in zip(solver._structured_violations(sp_t, aff_t, zt),
                           vj):
            np.testing.assert_allclose(vt.numpy(), np.asarray(vj_),
                                       rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("seed", [0, 3])
def test_solve_stlf_same_decisions(seed):
    tp, jp = _problems(6, seed=seed)
    kw = dict(max_outer=3, inner_steps=200)
    a = solver.solve_stlf(tp, device="cpu", **kw)
    b = jsolver.solve_stlf(jp, **kw)
    np.testing.assert_array_equal(a.psi, b.psi)
    np.testing.assert_allclose(a.alpha, b.alpha, atol=1e-3)
    np.testing.assert_allclose(a.psi_relaxed, b.psi_relaxed, atol=1e-3)
    assert a.outer_iters == b.outer_iters
    assert a.pack_time_s >= 0.0 and a.solve_time_s > 0.0
    assert a.inner_steps == a.outer_iters * kw["inner_steps"]  # no tol


@pytest.mark.parametrize("inner_tol", [0.0, 1e-4])
def test_adam_loop_schedule_and_early_stop(inner_tol):
    """The same Adam/penalty schedule as the reference's scanned loop,
    and the inner_tol stop taken after the same chunk."""
    import jax
    # targets beyond the box: z ends clamped, so the moves stop
    target = np.array([2, -5, 2, -5, 2, 0.1, -4], np.float32)
    lo, hi = np.full(7, -3.0, np.float32), np.full(7, 0.5, np.float32)
    calls = []

    def loss_t(z, r):
        calls.append(r)
        return torch.sum((z - torch.as_tensor(target)) ** 2
                         * (1.0 + 1e-3 * r))

    def loss_j(z, r):
        return jnp.sum((z - target) ** 2 * (1.0 + 1e-3 * r))

    z0 = np.zeros(7, np.float32)
    steps, chunk = 1280, 64
    out, ran = solver._adam_loop(loss_t, torch.as_tensor(z0), steps,
                                 torch.as_tensor(lo), torch.as_tensor(hi),
                                 2.0, inner_tol, chunk)
    ref = jax.jit(lambda z: jsolver._adam_loop(
        loss_j, z, steps, jnp.asarray(lo), jnp.asarray(hi), 2.0,
        inner_tol, chunk))(jnp.asarray(z0))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)
    assert len(calls) % chunk == 0 and ran == len(calls)
    assert (len(calls) < steps) == (inner_tol > 0.0)


def test_warm_start_resumes():
    tp, _ = _problems(5, seed=5)
    kw = dict(max_outer=3, inner_steps=150, device="cpu")
    cold = solver.solve_stlf(tp, **kw)
    warm = solver.solve_stlf(tp, warm_start=cold, **kw)
    assert warm.outer_iters <= cold.outer_iters
    np.testing.assert_array_equal(warm.psi, cold.psi)


def test_polish_assignment_exact():
    tp, jp = _problems(7, seed=6)
    rng = np.random.default_rng(1)
    psi = (rng.random(7) < 0.5).astype(float)
    psi[0] = 0.0
    rel = rng.uniform(0, 1, (7, 7))
    for ar in (rel, None):
        a = solver.polish_assignment(tp, psi, ar)
        b = jsolver.polish_assignment(jp, psi, ar)
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])


@pytest.mark.parametrize("steps", [1500, 800, 97, 1])
def test_chunk_for_equal(steps):
    assert solver._chunk_for(steps) == jsolver._chunk_for(steps)
