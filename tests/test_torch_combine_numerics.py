"""The numerics the two ST-LF kernels' designs rest on, on the CPU.

``alpha_combine`` runs on the tensor cores in TF32 with the 3xTF32 split
(x = x_hi + x_lo, both TF32; th_lo a_hi + th_hi a_lo + th_hi a_hi summed
in fp32).  TF32 rounding is emulated here on the fp32 bits (round to
nearest, ties away from zero, as ``cvt.rna.tf32.f32`` rounds): the split
stays within the kernel's 1e-5 bar, one TF32 product does not.

``disagreement`` normalizes inside its one launch and picks its tile and
cluster sizes with ``tile_edge`` and ``cluster_size``; the first is held
here against the JAX package (its Pallas kernel in interpret mode), the
second against its contract.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.disagreement import ops as jdg
from repro_torch.kernels.alpha_combine import ops as ac
from repro_torch.kernels.disagreement import ops as dg

torch.set_num_threads(2)          # six test workers share the box

RNG = np.random.default_rng(0)
BAR = dict(rtol=1e-5, atol=1e-5)  # alpha_combine's bar in chip_smoke.py


def tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 -> the nearest TF32 value (10 mantissa bits), ties away from
    zero, as an fp32 tensor."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _combine_inputs(s, t, p):
    theta = torch.as_tensor(RNG.normal(size=(s, p)), dtype=torch.float32)
    alpha = torch.as_tensor(RNG.uniform(size=(s, t)), dtype=torch.float32)
    return theta, alpha / alpha.sum(0, keepdim=True)


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0, 1.0 + 2.0 ** -10, 1.0 + 2.0 ** -11,
                      1.0 + 3 * 2.0 ** -12, -(1.0 + 2.0 ** -11), 3.0e-5])
    r = tf32(x)
    assert r[0] == 1.0 and r[1] == 1.0 + 2.0 ** -10
    assert r[2] == 1.0 + 2.0 ** -10          # a tie rounds away from zero
    assert r[3] == 1.0 + 2.0 ** -10          # 0.75 ulp rounds up
    assert r[4] == -(1.0 + 2.0 ** -10)
    assert ((r - x).abs() <= x.abs() * 2.0 ** -11).all()
    assert torch.equal(tf32(r), r)


def test_3xtf32_split_meets_the_bar_and_one_tf32_product_does_not():
    theta, alpha = _combine_inputs(256, 256, 4096)
    exact = alpha.double().T @ theta.double()
    th_hi, a_hi = tf32(theta), tf32(alpha)
    th_lo, a_lo = tf32(theta - th_hi), tf32(alpha - a_hi)
    # TF32 x TF32 products are exact in fp32; the sums are fp32
    split = (a_hi.T @ th_lo + a_lo.T @ th_hi) + a_hi.T @ th_hi
    one = a_hi.T @ th_hi
    err_split = float((split.double() - exact).abs().max())
    torch.testing.assert_close(split.double(), exact, **BAR)
    assert err_split < 1e-6
    beyond = int(((one.double() - exact).abs()
                  > BAR["atol"] + BAR["rtol"] * exact.abs()).sum())
    assert beyond > 0, "one TF32 product would pass the bar too"


def test_3xtf32_split_on_the_transfer_shape():
    # S = T = 10, the main path's transfer: the split is within the bar
    # of the fp32 plain version as well as of the float64 product
    theta, alpha = _combine_inputs(10, 10, 48158)
    th_hi, a_hi = tf32(theta), tf32(alpha)
    th_lo, a_lo = tf32(theta - th_hi), tf32(alpha - a_hi)
    split = (a_hi.T @ th_lo + a_lo.T @ th_hi) + a_hi.T @ th_hi
    torch.testing.assert_close(split, alpha.T @ theta, **BAR)


@pytest.mark.parametrize("masked", [False, True])
def test_disagreement_matches_jax_bit_for_bit(masked):
    preds = RNG.integers(0, 10, (40, 3000)).astype(np.int32)
    mask = RNG.random(3000) < 0.7 if masked else None
    out = dg.disagreement(torch.as_tensor(preds),
                          None if mask is None else torch.as_tensor(mask))
    ref = jdg.disagreement(jnp.asarray(preds),
                           None if mask is None else jnp.asarray(mask))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


# an H100's capacity for clusters of c blocks of the 32-tile kernel (two
# blocks an SM, clusters within one of 8 GPCs): 8 * (33 // c)
H100_CAPS = tuple(8 * (33 // c) for c in range(1, 9))


@pytest.mark.parametrize("n,m,expect", [
    (10, 2500, (16, 8)),      # the main path: one tile, 8 blocks
    (256, 64000, (32, 6)),    # 36 tiles: 6 fit 40 clusters in one wave,
                              # 7 and 8 fit 32 and need two
    (130, 777, (32, 8)),      # 15 tiles, m has 13 chunks
    (16, 100, (16, 1)),       # one chunk of m: no split
    (17, 200, (32, 4)),       # past 16 rows: tiles of 32
])
def test_disagreement_cluster_cases(n, m, expect):
    bn = dg.tile_edge(n)
    assert (bn, dg.cluster_size(n, m, 132, H100_CAPS)) == expect


@pytest.mark.parametrize("n,m", [(10, 2500), (256, 64000), (1000, 9)])
def test_disagreement_cluster_contract(n, m):
    # 1..8 blocks and no more than m's chunks; with room for one cluster
    # at a time every tile is a wave of its own, so the largest wins
    chunk = 128 if dg.tile_edge(n) == 16 else 64
    top = min(8, math.ceil(m / chunk))
    for caps in (H100_CAPS, (10 ** 6,) * 8):
        assert 1 <= dg.cluster_size(n, m, 132, caps) <= top
    assert dg.cluster_size(n, m, 132, (1,) * 8) == top
