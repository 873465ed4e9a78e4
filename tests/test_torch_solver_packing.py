"""The solver's packed reference path on the port against
``repro.core.solver`` and ``repro.core.gp``: the numpy ``gp`` copy equal
to the original; ``build_program`` and ``build_program_reference`` equal
to each other and to the reference's ``build_program``, array by array;
the packed loss equal to the structured loss pointwise (rtol 1e-5, as
the reference's own test holds them, float32 with another summation
order) and to the reference's packed loss; ``solve_stlf(inner_impl=
"packed")`` with the reference's packed solve's psi and alpha within
1e-3 (the bar of ``tests/test_solver_packing.py``); and
``polish_assignment_reference`` against the vectorized
``polish_assignment``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_solver import _problems
from repro.core import gp as jgp
from repro.core import solver as jsolver
from repro_torch.core import gp, solver

torch.set_num_threads(2)          # six test workers share the box


def _terms_equal(a, b, where):
    for x, y, name in zip(a, b, ("logc", "vidx", "vexp")):
        x, y = np.asarray(x), np.asarray(y)
        assert x.shape == y.shape, f"{where}.{name}: {x.shape} != {y.shape}"
        assert x.dtype == y.dtype, f"{where}.{name}: {x.dtype} != {y.dtype}"
        np.testing.assert_array_equal(x, y, err_msg=f"{where}.{name}")


def _programs_equal(a, b):
    assert len(a.families) == len(b.families) == 4
    for fi, (fa, fb) in enumerate(zip(a.families, b.families)):
        for part in ("num", "den", "ex"):
            _terms_equal(getattr(fa, part), getattr(fb, part),
                         f"fam{fi}.{part}")
    _terms_equal(a.o_num, b.o_num, "o_num")
    _terms_equal(a.o_den, b.o_den, "o_den")


# ----------------------------------------------------------------- gp.py
def test_gp_matches_the_original():
    rng = np.random.default_rng(0)
    z = rng.normal(size=6)
    polys = []
    for lib in (gp, jgp):
        p = (lib.Posynomial.var(1, power=2.0, coeff=0.3)
             + lib.Posynomial.const(1.7)
             + lib.Posynomial([lib.Monomial(0.2, {0: 1.0, 4: -1.5})]))
        polys.append(p.scale(2.5))
    a, b = polys
    assert a.value(z) == b.value(z)
    ma, mb = a.agm_monomial(z), b.agm_monomial(z)
    assert ma.log_c == mb.log_c and ma.exps == mb.exps
    assert ma.log_value(z) == mb.log_value(z)
    for x, y in zip(gp.pack_posynomial(a, 6), jgp.pack_posynomial(b, 6)):
        np.testing.assert_array_equal(x, y)
    for x, y in zip(gp.pack_monomial(ma, 6), jgp.pack_monomial(mb, 6)):
        np.testing.assert_array_equal(x, y)


# ------------------------------------------------------------ the packers
@pytest.mark.parametrize("n,kw", [
    (3, {}), (8, {}), (5, dict(phi_s=0.0)), (5, dict(phi_t=0.0)),
    (5, dict(phi_e=0.0)), (5, dict(phi_s=0.0, phi_e=0.0))])
def test_packers_match_each_other_and_the_reference(n, kw):
    tp, jp = _problems(n, seed=n, **kw)
    ours = solver.build_program(tp)
    _programs_equal(ours, solver.build_program_reference(tp))
    _programs_equal(ours, jsolver.build_program(jp))


# ------------------------------------------------------- the packed loss
def test_packed_loss_matches_structured_and_reference():
    tp, jp = _problems(8, seed=11)
    prog = solver._packed_on(solver.build_program(tp), torch.device("cpu"))
    jprog = jsolver.build_program(jp)
    sp = solver.build_structured(tp, device="cpu")
    z0 = np.log(np.maximum(tp.feasible_start(), 1e-12)).astype(np.float32)
    zt0 = torch.as_tensor(z0)
    affs = tuple(solver._agm_affine(f.den, zt0) for f in prog.families)
    aff_o = solver._agm_affine(prog.o_den, zt0)
    jaffs = tuple(jsolver._agm_affine(f.den, jnp.asarray(z0))
                  for f in jprog.families)
    jaff_o = jsolver._agm_affine(jprog.o_den, jnp.asarray(z0))
    aff_s = solver._structured_affine(sp, zt0)
    rng = np.random.default_rng(0)
    for _ in range(3):
        z = (z0 + rng.uniform(-0.3, 0.3, z0.shape)).astype(np.float32)
        zt, zj = torch.as_tensor(z), jnp.asarray(z)
        op = float(solver._objective(prog, aff_o, zt))
        np.testing.assert_allclose(
            op, float(solver._structured_objective(sp, aff_s, zt)),
            rtol=1e-5)
        np.testing.assert_allclose(
            op, float(jsolver._objective(jprog, jaff_o, zj)), rtol=1e-5)
        vp = solver._violations(prog, affs, zt)
        vs = sum(float(torch.sum(v))
                 for v in solver._structured_violations(sp, aff_s, zt))
        np.testing.assert_allclose(sum(float(torch.sum(v)) for v in vp),
                                   vs, rtol=1e-4, atol=1e-5)
        for v, jv in zip(vp, jsolver._violations(jprog, jaffs, zj)):
            np.testing.assert_allclose(v.numpy(), np.asarray(jv),
                                       rtol=1e-5, atol=1e-5)
        for r in (1.0, 50.0):
            ref = float(jsolver._objective(jprog, jaff_o, zj)
                        + sum(r * jnp.sum(jnp.square(v)) + 10.0 * r
                              * jnp.sum(v) for v in
                              jsolver._violations(jprog, jaffs, zj)))
            out = float(solver._packed_loss(prog, affs, aff_o, zt, r))
            assert out == pytest.approx(ref, rel=1e-5)


# ------------------------------------------------------------- the solve
@pytest.mark.parametrize("seed", [0, 3])
def test_packed_solve_matches_reference(seed):
    tp, jp = _problems(6, seed=seed)
    kw = dict(max_outer=3, inner_steps=200, inner_impl="packed")
    a = solver.solve_stlf(tp, device="cpu", **kw)
    b = jsolver.solve_stlf(jp, **kw)
    np.testing.assert_array_equal(a.psi, b.psi)
    np.testing.assert_allclose(a.alpha, b.alpha, atol=1e-3)
    np.testing.assert_allclose(a.psi_relaxed, b.psi_relaxed, atol=1e-3)
    assert a.outer_iters == b.outer_iters
    assert a.inner_steps > 0 and a.pack_time_s > 0.0
    # the structured route decides the same
    c = solver.solve_stlf(tp, device="cpu", max_outer=3, inner_steps=200)
    np.testing.assert_array_equal(a.psi, c.psi)
    np.testing.assert_allclose(a.alpha, c.alpha, atol=1e-3)


def test_unknown_inner_impl_raises():
    tp, _ = _problems(4)
    with pytest.raises(ValueError, match="inner_impl"):
        solver.solve_stlf(tp, device="cpu", inner_impl="dense")


# ------------------------------------------------------------ the polish
@pytest.mark.parametrize("n,seed", [(6, 0), (8, 1), (12, 2)])
def test_polish_reference_matches_vectorized(n, seed):
    tp, jp = _problems(n, seed=seed)
    rng = np.random.default_rng(seed + 100)
    psi0 = (rng.random(n) < 0.5).astype(float)
    if psi0.min() == 1.0:
        psi0[0] = 0.0
    relaxed = rng.uniform(0.0, 1.0, (n, n))
    for start, rel in ((psi0, relaxed), (psi0, None), (np.ones(n), None)):
        pv, av = solver.polish_assignment(tp, start, rel)
        pr, ar = solver.polish_assignment_reference(tp, start, rel)
        np.testing.assert_array_equal(pv, pr)
        np.testing.assert_allclose(av, ar, atol=1e-12)
        jr, jar = jsolver.polish_assignment_reference(jp, start, rel)
        np.testing.assert_array_equal(pr, jr)
        np.testing.assert_array_equal(ar, jar)
