"""``repro_torch.optim`` against ``repro.optim``: the schedules, ``sgd``,
``adamw`` (fp32 and bf16 moments, decay masks), ``global_norm``,
``clip_by_global_norm`` and ``apply_updates`` on the same parameters and
gradients (JAX's carried across by ``convert.lm_params_from_jax``), and
JAX's own ``tests/test_optim.py`` cases on the port."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as jopt
from repro_torch import convert
from repro_torch import optim as topt
from repro_torch.nn.param import tree_map

torch.set_num_threads(2)          # six test workers share the box

# fp32 state: the same arithmetic in the same order; XLA and torch may
# round pow/sqrt/div one ulp apart
F32 = dict(rtol=1e-6, atol=1e-7)
STEPS = np.arange(301)
SCHEDULES = {
    "cosine": lambda m: m.linear_warmup_cosine(3e-4, 20, 300, floor=1e-5),
    "linear": lambda m: m.linear_warmup_linear_decay(1.0, 10, 110, 0.1),
    "constant": lambda m: m.constant(0.3),
}


def _tree(seed):
    """A nested tree with matrices, vectors and a 3-d leaf."""
    r = np.random.default_rng(seed)
    return {"a": {"w": r.normal(size=(8, 16)).astype(np.float32),
                  "b": r.normal(size=(16,)).astype(np.float32)},
            "c": r.normal(size=(4, 3, 5)).astype(np.float32),
            "ln": (1 + 0.1 * r.normal(size=(16,))).astype(np.float32)}


def _jx(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _pt(tree):
    return convert.lm_params_from_jax(_np(tree), "cpu")


def _close(port, ref, **tol):
    ref = _np(ref)
    port = convert.lm_params_to_numpy(port)
    assert jax.tree_util.tree_structure(port) == \
        jax.tree_util.tree_structure(ref)
    for a, b in zip(jax.tree_util.tree_leaves(port),
                    jax.tree_util.tree_leaves(ref)):
        np.testing.assert_allclose(a, np.asarray(b, np.float32), **tol)


# ---------------------------------------------------------------- schedules
@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedules_match_jax(name):
    js, ts = SCHEDULES[name](jopt), SCHEDULES[name](topt)
    j = np.array([np.float32(js(s)) for s in STEPS])
    t = np.array([ts(int(s)).item() for s in STEPS], np.float32)
    assert t.dtype == np.float32
    # the int32 step tensor the optimizers pass gives the same values
    t2 = np.array([ts(torch.tensor(int(s), dtype=torch.int32)).item()
                   for s in STEPS], np.float32)
    np.testing.assert_array_equal(t2, t)
    if name == "cosine":
        # exact through the warmup; past it, XLA's and torch's cos may
        # round 2 ulps apart, and 1 + cos cancels near frac = 1: the bar
        # is 2 ulps of the cosine, scaled by (peak - floor) / 2, plus one
        # ulp of the value
        np.testing.assert_array_equal(t[:20], j[:20])
        frac = np.clip((STEPS - 20) / 280, 0, 1).astype(np.float32)
        jc = np.asarray(jnp.cos(jnp.pi * jnp.asarray(frac)))
        tc = torch.cos(np.pi * torch.as_tensor(frac)).numpy()
        assert np.all(np.abs(tc - jc) <= 2 * np.spacing(np.float32(1)))
        bar = 2 * np.spacing(np.float32(1)) * (3e-4 - 1e-5) / 2 \
            + np.spacing(np.abs(j))
        assert np.all(np.abs(t - j) <= bar)
    else:
        np.testing.assert_array_equal(t, j)


def test_schedule_values():            # JAX's test_schedules, on the port
    s = topt.linear_warmup_cosine(1.0, warmup=10, total=110, floor=0.1)
    assert float(s(0)) == pytest.approx(0.0)
    assert float(s(10)) == pytest.approx(1.0)
    assert float(s(110)) == pytest.approx(0.1)
    s2 = topt.linear_warmup_linear_decay(1.0, warmup=10, total=110)
    assert float(s2(60)) == pytest.approx(0.5, abs=0.02)
    assert float(topt.constant(0.3)(1000)) == pytest.approx(0.3)


# ---------------------------------------------------------------- optimizers
def _custom_mask(params):
    """Decay the 'a' subtree only (JAX's mask returns a tree of bools)."""
    return {"a": {"w": True, "b": True}, "c": False, "ln": False}


OPTS = {
    "sgd": lambda m, **kw: m.sgd(0.05),
    "sgd-momentum": lambda m, **kw: m.sgd(0.05, momentum=0.9),
    "sgd-nesterov": lambda m, **kw: m.sgd(
        SCHEDULES["cosine"](m), momentum=0.9, nesterov=True),
    "adamw": lambda m, **kw: m.adamw(1e-2, **kw),
    "adamw-wd": lambda m, **kw: m.adamw(
        SCHEDULES["cosine"](m), weight_decay=0.1, **kw),
    "adamw-wd-mask": lambda m, **kw: m.adamw(
        3e-3, weight_decay=0.1, mask=_custom_mask, **kw),
}


def _run(name, steps, state_dtype=None):
    kw = {}
    if state_dtype is not None:
        kw = dict(state_dtype=state_dtype[0])
    jo = OPTS[name](jopt, **kw)
    if state_dtype is not None:
        kw = dict(state_dtype=state_dtype[1])
    to = OPTS[name](topt, **kw)
    jp = _jx(_tree(0))
    js = jo.init(jp)
    tp = _pt(jp)
    ts = convert.lm_params_from_jax(_np(js), "cpu")
    for i in range(steps):
        g = _tree(100 + i)
        ju, js = jo.update(_jx(g), js, jp)
        tu, ts = to.update(_pt(g), ts, tp)
        jp = jopt.apply_updates(jp, ju)
        tp = topt.apply_updates(tp, tu)
    return jp, js, tp, ts


@pytest.mark.parametrize("steps", [1, 5])
@pytest.mark.parametrize("name", sorted(OPTS))
def test_fp32_state_matches_jax(name, steps):
    jp, js, tp, ts = _run(name, steps)
    _close(tp, jp, **F32)
    assert int(ts["step"]) == int(js["step"]) == steps
    assert ts["step"].dtype == torch.int32
    for k in ("m", "v", "mu"):
        if k in js:
            if js[k] is None:
                assert ts[k] is None
            else:
                _close(ts[k], js[k], **F32)


def _bf16_ulp_apart(port, ref):
    """Equal, or one bf16 ulp apart (the fp32 sums before the rounding
    differ in their last bits)."""
    a = torch.as_tensor(convert.lm_params_to_numpy(port))
    b = torch.as_tensor(np.asarray(ref, np.float32))
    ia = a.to(torch.bfloat16).view(torch.int16).int()
    ib = b.to(torch.bfloat16).view(torch.int16).int()
    assert torch.equal(a.to(torch.bfloat16).float(), a)
    assert int((ia - ib).abs().max()) <= 1


@pytest.mark.parametrize("steps", [1, 5])
@pytest.mark.parametrize("name", ["adamw", "adamw-wd", "adamw-wd-mask"])
def test_bf16_state_matches_jax(name, steps):
    jp, js, tp, ts = _run(name, steps, (jnp.bfloat16, torch.bfloat16))
    for k in ("m", "v"):
        for a, b in zip(jax.tree_util.tree_leaves(ts[k]),
                        jax.tree_util.tree_leaves(js[k])):
            assert a.dtype == torch.bfloat16
            _bf16_ulp_apart(a, b)
    # parameters from moments one ulp apart: within that ulp's effect
    _close(tp, jp, rtol=1e-4, atol=1e-5)


def test_default_mask_decays_matrices_only():
    # lr 1, zero gradients: the update is -(wd * p) on the ndim >= 2 leaves
    params = _pt(_tree(3))
    opt = topt.adamw(1.0, weight_decay=0.1)
    zeros = tree_map(torch.zeros_like, params)
    upd, _ = opt.update(zeros, opt.init(params), params)
    for k, p in (("w", params["a"]["w"]), ("c", params["c"])):
        u = upd["a"]["w"] if k == "w" else upd["c"]
        torch.testing.assert_close(u, -0.1 * p)
    assert torch.equal(upd["a"]["b"], torch.zeros(16))
    assert torch.equal(upd["ln"], torch.zeros(16))


# ------------------------------------------------------ norms and updates
def test_global_norm_and_clip_match_jax():
    g = _tree(5)
    for max_norm in (1.0, 1e3):
        jc, jn = jopt.clip_by_global_norm(_jx(g), max_norm)
        tc, tn = topt.clip_by_global_norm(_pt(g), max_norm)
        np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
        _close(tc, jc, **F32)
    np.testing.assert_allclose(float(topt.global_norm(_pt(g))),
                               float(jopt.global_norm(_jx(g))), rtol=1e-6)


def test_apply_updates_matches_jax_with_a_bf16_leaf():
    p = _tree(6)
    p["h"] = np.asarray(jnp.asarray(_tree(7)["a"]["w"], jnp.bfloat16))
    u = jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32) * 1e-2,
                               _tree(8) | {"h": _tree(9)["a"]["w"]})
    jr = jopt.apply_updates(_jx(p), _jx(u))
    tr = topt.apply_updates(convert.lm_params_from_jax(p, "cpu"),
                            convert.lm_params_from_jax(u, "cpu"))
    assert tr["h"].dtype == torch.bfloat16 and tr["c"].dtype == torch.float32
    for a, b in zip(jax.tree_util.tree_leaves(convert.lm_params_to_numpy(tr)),
                    jax.tree_util.tree_leaves(_np(jr))):
        np.testing.assert_array_equal(a, np.asarray(b, np.float32))


# ------------------------------------------- JAX's tests/test_optim.py cases
def _quadratic_loss(opt, steps=200):
    """min 0.5*(x-3)^2 through the port's optimizer; the final loss."""
    params = {"x": torch.zeros(())}
    state = opt.init(params)
    for _ in range(steps):
        g = {"x": params["x"] - 3.0}
        upd, state = opt.update(g, state, params)
        params = topt.apply_updates(params, upd)
    return float(0.5 * (params["x"] - 3.0) ** 2)


@pytest.mark.parametrize("opt,steps,bar", [
    (lambda: topt.sgd(0.1), 200, 1e-6),
    (lambda: topt.sgd(0.05, momentum=0.9), 200, 1e-6),
    (lambda: topt.adamw(0.1, weight_decay=0.0), 400, 1e-4)])
def test_converges_on_quadratic(opt, steps, bar):
    assert _quadratic_loss(opt(), steps) < bar


def test_adamw_bf16_state_dtype():
    opt = topt.adamw(0.1, state_dtype=torch.bfloat16)
    params = {"w": torch.ones(4, 4)}
    state = opt.init(params)
    assert state["m"]["w"].dtype == torch.bfloat16
    upd, state = opt.update({"w": torch.ones(4, 4)}, state, params)
    assert state["v"]["w"].dtype == torch.bfloat16
    assert bool(torch.isfinite(upd["w"]).all())


def test_weight_decay_with_zero_lr_is_no_update():
    opt = topt.adamw(0.0, weight_decay=0.1)
    params = {"w": torch.ones(2, 2), "b": torch.ones(2)}
    upd, _ = opt.update(tree_map(torch.zeros_like, params),
                        opt.init(params), params)
    assert torch.equal(upd["w"].abs(), torch.zeros(2, 2))


def test_global_norm_and_clip_values():
    tree = {"a": torch.ones(3) * 2.0, "b": torch.ones(1) * 2.0}
    assert float(topt.global_norm(tree)) == pytest.approx(4.0)
    clipped, norm = topt.clip_by_global_norm(tree, 1.0)
    assert float(norm) == pytest.approx(4.0)
    assert float(topt.global_norm(clipped)) == pytest.approx(1.0, rel=1e-5)
