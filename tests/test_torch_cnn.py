"""The port's CNN, parameter layout and weight conversion against
``repro.fl.cnn`` / ``repro.nn.param`` on the same numpy-seeded inputs.
Tolerance 1e-5: both are float32, with another summation order."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import build_network as jbuild_network
from repro.fl import cnn as jcnn
from repro.fl.client import stack_clients as jstack_clients
from repro.nn.param import flatten_to_vector as jflatten
from repro_torch import convert
from repro_torch.fl import cnn
from repro_torch.fl.client import stack_clients
from repro_torch.nn.param import flatten_to_vector, unflatten_from_vector

torch.set_num_threads(2)          # six test workers share the box

TOL = dict(rtol=1e-5, atol=1e-5)


def _jax_params(seed, num_classes=10):
    return jax.tree_util.tree_map(
        np.asarray, jcnn.cnn_init(jax.random.PRNGKey(seed), num_classes))


def _x(b, seed=0):
    return np.random.default_rng(seed).uniform(
        0, 1, (b, 28, 28, 3)).astype(np.float32)


@pytest.mark.parametrize("num_classes", [10, 2])
def test_forward_features_loss_accuracy_match(num_classes):
    jp = _jax_params(1, num_classes)
    # non-zero biases, so their layout is exercised too
    rng = np.random.default_rng(3)
    for k in ("b1", "b2", "fcb1", "fcb2"):
        jp[k] = rng.normal(0, 0.1, jp[k].shape).astype(np.float32)
    tp = convert.params_from_jax(jp, "cpu")
    x = _x(6)
    y = np.random.default_rng(2).integers(0, num_classes, 6)
    tx, ty = torch.as_tensor(x), torch.as_tensor(y)
    np.testing.assert_allclose(cnn.cnn_forward(tp, tx).numpy(),
                               np.asarray(jcnn.cnn_forward(jp, x)), **TOL)
    np.testing.assert_allclose(cnn.cnn_features(tp, tx).numpy(),
                               np.asarray(jcnn.cnn_features(jp, x)), **TOL)
    np.testing.assert_allclose(
        float(cnn.xent_loss(tp, tx, ty)),
        float(jcnn.xent_loss(jp, x, jnp.asarray(y, jnp.int32))), **TOL)
    mask = np.array([1, 0, 1, 1, 0, 1], bool)
    assert float(cnn.accuracy(tp, tx, ty, torch.as_tensor(mask))) == \
        float(jcnn.accuracy(jp, x, jnp.asarray(y), jnp.asarray(mask)))
    assert float(cnn.accuracy(tp, tx, ty)) == \
        float(jcnn.accuracy(jp, x, jnp.asarray(y)))


def test_stacked_forward_is_each_model():
    jps = [_jax_params(s) for s in (0, 1, 2)]
    stacked = convert.params_from_jax(
        {k: np.stack([p[k] for p in jps]) for k in jps[0]}, "cpu")
    x = np.stack([_x(4, s) for s in range(3)])
    out = cnn.forward_stacked(stacked, torch.as_tensor(x)).numpy()
    for m, jp in enumerate(jps):
        np.testing.assert_allclose(out[m], np.asarray(
            jcnn.cnn_forward(jp, x[m])), **TOL)


def test_flatten_matches_jax_tree_order():
    jp = _jax_params(4)
    tp = convert.params_from_jax(jp, "cpu")
    vec = flatten_to_vector(tp)
    assert vec.shape == (48158,)
    np.testing.assert_array_equal(vec.numpy(), np.asarray(jflatten(jp)))
    back = unflatten_from_vector(vec, tp)
    for k in tp:
        assert torch.equal(back[k], tp[k])
    stacked = {k: torch.stack([v, 2 * v]) for k, v in tp.items()}
    flat = flatten_to_vector(stacked, lead=1)
    np.testing.assert_array_equal(flat[1].numpy(), 2 * vec.numpy())
    back = unflatten_from_vector(flat, stacked, lead=1)
    for k in stacked:
        assert torch.equal(back[k], stacked[k])


def test_convert_round_trip():
    jp = _jax_params(5)
    back = convert.params_to_numpy(convert.params_from_jax(jp, "cpu"))
    assert sorted(back) == sorted(jp)
    for k in jp:
        np.testing.assert_array_equal(back[k], jp[k])
    devs = jbuild_network("M//MM", num_devices=3, samples_per_device=9,
                          seed=1)
    a = convert.clients_from_numpy(jstack_clients(devs), "cpu")
    b = stack_clients(devs, device="cpu")
    for f in ("x", "y", "labeled", "valid", "true_y", "counts"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f


def test_init_shapes_and_scale():
    p = cnn.cnn_init(torch.Generator().manual_seed(0), device="cpu")
    specs = cnn.cnn_specs()
    for k, s in specs.items():
        assert tuple(p[k].shape) == s.shape
    assert torch.count_nonzero(p["b1"]) == 0
    # lecun normal: std = 1 / sqrt(fan_in), fan_in = 320 for fc1
    assert abs(float(p["fc1"].std()) * np.sqrt(320) - 1.0) < 0.05
