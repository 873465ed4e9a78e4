"""The port's roofline arithmetic (``repro_torch.launch.roofline``) against
the JAX package's (``repro.launch.roofline``): parameter counts and model
FLOPs exactly equal for every config and input shape; the terms equal
once each side's peaks are multiplied back (the port's are the H100's,
JAX's a TPU v5e's)."""
import math

import pytest

from repro.configs import INPUT_SHAPES as J_SHAPES
from repro.configs import all_configs as j_all_configs
from repro.launch import roofline as jrl
from repro.launch.mesh import HW as J_HW
from repro_torch.configs import INPUT_SHAPES, all_configs
from repro_torch.launch import roofline as rl
from repro_torch.launch.mesh import HW

ARCHS = sorted(all_configs())


def test_every_jax_config_is_here():
    assert ARCHS == sorted(j_all_configs())


@pytest.mark.parametrize("arch", ARCHS)
def test_count_params_from_cfg_matches_jax(arch):
    assert rl.count_params_from_cfg(all_configs()[arch]) == \
        jrl.count_params_from_cfg(j_all_configs()[arch])


@pytest.mark.parametrize("shape", sorted(INPUT_SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_matches_jax(arch, shape):
    assert rl.model_flops(all_configs()[arch], INPUT_SHAPES[shape]) == \
        jrl.model_flops(j_all_configs()[arch], J_SHAPES[shape])


@pytest.mark.parametrize("chips,coll", [(1, 0.0), (256, 3.5e9),
                                        (512, 7.0e10)])
@pytest.mark.parametrize("arch", ["llama3.2-1b", "grok-1-314b",
                                  "rwkv6-1.6b"])
def test_derive_roofline_terms_match_jax_s_counts(arch, chips, coll):
    flops, nbytes = 4.7e13, 2.6e12
    mine = rl.derive_roofline(
        all_configs()[arch], INPUT_SHAPES["train_4k"], chips=chips,
        hlo_flops_per_device=flops, hlo_bytes_per_device=nbytes,
        collective_bytes_per_device=coll)
    jax_s = jrl.derive_roofline(
        j_all_configs()[arch], J_SHAPES["train_4k"], chips=chips,
        hlo_flops_per_device=flops, hlo_bytes_per_device=nbytes,
        collective_bytes_per_device=coll)
    assert mine.compute_s * HW["peak_flops_bf16"] == \
        pytest.approx(jax_s.compute_s * J_HW["peak_flops_bf16"], rel=1e-12)
    assert mine.memory_s * HW["hbm_bw"] == \
        pytest.approx(jax_s.memory_s * J_HW["hbm_bw"], rel=1e-12)
    assert mine.collective_s * HW["nvlink_bw"] == pytest.approx(
        jax_s.collective_s * J_HW["ici_bw"] * 4.0, rel=1e-12)
    assert (mine.model_flops, mine.hlo_flops_total, mine.usefulness) == \
        (jax_s.model_flops, jax_s.hlo_flops_total, jax_s.usefulness)
    terms = {"compute": mine.compute_s, "memory": mine.memory_s,
             "collective": mine.collective_s}
    assert mine.dominant == max(terms, key=terms.get)


def test_collective_term_none_when_not_counted():
    r = rl.derive_roofline(
        all_configs()["llama3.2-1b"], INPUT_SHAPES["prefill_32k"],
        chips=256, hlo_flops_per_device=1e12, hlo_bytes_per_device=1e13,
        collective_bytes_per_device=None)
    assert r.collective_s is None and r.dominant == "memory"
    assert r.as_dict()["collective_s"] is None


def test_h100_peaks_and_mfu():
    assert (HW["peak_flops_bf16"], HW["peak_flops_tf32"],
            HW["peak_flops_fp32"], HW["hbm_bw"], HW["hbm_bytes"],
            HW["nvlink_bw"]) == (989e12, 495e12, 67e12, 3.35e12, 80e9,
                                 450e9)
    cfg, shape = all_configs()["repro-100m"], INPUT_SHAPES["train_4k"]
    mf = rl.model_flops(cfg, shape)
    assert rl.mfu(cfg, shape, 2.0, chips=4) == mf / (2.0 * 4 * 989e12)
    # a step that reaches the bf16 peak exactly has mfu 1
    assert math.isclose(rl.mfu(cfg, shape, mf / 989e12), 1.0)
