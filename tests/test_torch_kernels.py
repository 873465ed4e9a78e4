"""The port's kernel wrappers on the CPU (their plain versions) against
the JAX package's Pallas kernels, run in interpret mode as
``tests/test_kernels.py`` runs them, and against their ``ref.py``
oracles, at ragged shapes.  The CUDA kernels themselves are held against
the plain versions on the card (``test_torch_kernels_cuda.py`` and
``chip_smoke.py``)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.alpha_combine import ops as jac
from repro.kernels.alpha_combine.ref import alpha_combine_ref
from repro.kernels.disagreement import ops as jdg
from repro.kernels.disagreement.ref import disagreement_ref
from repro_torch.kernels.alpha_combine import ops as ac
from repro_torch.kernels.disagreement import ops as dg

torch.set_num_threads(2)          # six test workers share the box

RNG = np.random.default_rng(0)


def _ac_inputs(s, t, p):
    theta = RNG.normal(size=(s, p)).astype(np.float32)
    alpha = RNG.uniform(size=(s, t)).astype(np.float32)
    return theta, alpha / alpha.sum(0, keepdims=True)


@pytest.mark.parametrize("s,t,p", [(7, 5, 1001), (3, 4, 2049),
                                   (10, 10, 4100)])
def test_alpha_combine_matches_pallas_and_ref(s, t, p):
    theta, alpha = _ac_inputs(s, t, p)
    out = ac.alpha_combine(torch.as_tensor(theta), torch.as_tensor(alpha))
    assert out.shape == (t, p) and out.dtype == torch.float32
    pallas = np.asarray(jac.alpha_combine(jnp.asarray(theta),
                                          jnp.asarray(alpha)))
    ref = np.asarray(alpha_combine_ref(jnp.asarray(theta),
                                       jnp.asarray(alpha)))
    np.testing.assert_allclose(out.numpy(), pallas, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)


def test_alpha_combine_tree_matches_pallas():
    import jax
    from repro.fl import cnn as jcnn
    keys = jax.random.split(jax.random.PRNGKey(0), 4)
    stack = jax.tree_util.tree_map(
        np.asarray, jax.vmap(lambda k: jcnn.cnn_init(k, 10))(keys))
    _, alpha = _ac_inputs(4, 4, 1)
    out = ac.alpha_combine_tree(
        {k: torch.tensor(v) for k, v in stack.items()},
        torch.as_tensor(alpha))
    ref = jac.alpha_combine_tree(stack, jnp.asarray(alpha))
    for k in stack:
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]),
                                   rtol=1e-5, atol=1e-6)


def _preds(n, m, classes=4):
    return RNG.integers(0, classes, (n, m)).astype(np.int32)


@pytest.mark.parametrize("n,m", [(13, 777), (5, 100), (1, 9)])
def test_disagreement_matches_pallas_and_ref(n, m):
    preds = _preds(n, m)
    valid = RNG.random(m) < 0.7
    out = dg.disagreement(torch.as_tensor(preds), torch.as_tensor(valid))
    pallas = np.asarray(jdg.disagreement(jnp.asarray(preds),
                                         jnp.asarray(valid)))
    ref = np.asarray(disagreement_ref(jnp.asarray(preds),
                                      jnp.asarray(valid)))
    # 0/1 weights are counted exactly in float32: equal, not close
    np.testing.assert_array_equal(out.numpy(), pallas)
    np.testing.assert_array_equal(out.numpy(), ref)


def test_disagreement_counts_raw_and_no_mask():
    preds = _preds(6, 50)
    counts = dg.disagreement_counts(torch.as_tensor(preds),
                                    torch.ones(50))
    np.testing.assert_array_equal(
        counts.numpy(), (preds[:, None] != preds[None]).sum(-1))
    out = dg.disagreement(torch.as_tensor(preds)).numpy()
    # the wrapper divides counts by M exactly as the Pallas wrapper does;
    # ref.py takes a mean, which may round the last bit otherwise
    np.testing.assert_array_equal(
        out, np.asarray(jdg.disagreement(jnp.asarray(preds))))
    np.testing.assert_allclose(
        out, np.asarray(disagreement_ref(jnp.asarray(preds))), rtol=1e-6)


def test_wrappers_reject_bad_shapes():
    with pytest.raises(ValueError):
        ac.alpha_combine(torch.zeros(3, 8), torch.zeros(4, 2))
    with pytest.raises(ValueError):
        dg.disagreement_counts(torch.zeros(3, 8, dtype=torch.int32),
                               torch.zeros(7))


def test_build_fails_loudly_without_nvcc(monkeypatch, tmp_path):
    from repro_torch.kernels import _build
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build._nvcc()
