"""rwkv6 and zamba2 (reduced(), fp32) on ('data', 'model') meshes of four
``gloo`` ranks on the CPU: the prefill, decode and train steps through
their bundles on DTensor against one process and against JAX's jitted
(2, 2) bundles; the ``ssm_scan`` op's sharding rule, and the local
shapes rank 0's op calls see on the models' prefills (the heads split
on 'model', mamba's q = C and k = B still stride-0 views over heads).
Weights are JAX's, carried across by ``convert.lm_params_from_jax``."""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
import _torch_mesh_families as fam  # noqa: E402

torch.set_num_threads(2)

NAMES = ["rwkv6-1.6b", "zamba2-7b"]
RUNS = [((2, 2), "default"), ((1, 4), "default")]
CASES = [(n, r) for n in NAMES for r in RUNS]


@pytest.fixture(scope="module")
def trees():
    return {n: fam.jax_tree(n, i) for i, n in enumerate(NAMES)}


@pytest.fixture(scope="module")
def inputs():
    return {n: fam.family_inputs(n, 10 + i) for i, n in enumerate(NAMES)}


@pytest.fixture(scope="module")
def single(trees, inputs):
    return {n: fam.single(n, trees[n], inputs[n]) for n in NAMES}


@pytest.fixture(scope="module")
def runs(single, trees, inputs, tmp_path_factory):
    return fam.run_worlds(RUNS, NAMES, trees, inputs,
                          tmp_path_factory.mktemp("mesh_ssm"))


def _case_id(case):
    return f"{case[0]}-{fam.mesh_id(case[1])}"


# ------------------------------------- rank 0's count vs a fake group's
@pytest.mark.parametrize("kind", ["prefill", "decode", "train"])
@pytest.mark.parametrize("case", [c for c in CASES
                                  if c[1][0] in fam.COUNTED_MESHES],
                         ids=_case_id)
def test_rank0_count_equals_the_fake_groups(runs, case, kind):
    """Rank 0's count of each step's first call in the live world
    (``launch.hlo.StepCounter`` around ``bundle.fn``) equals the count of
    the same step on a ``"fake"`` process group of four ranks over
    ``meta`` shards (``launch.dryrun.rank0_count``), exactly: FLOPs,
    bytes, each collective's count and bytes.  Both take the same route:
    the ``gla_chunked`` op (its CPU implementation in the world, its
    fake on ``meta``) and flash on the prefill and the decode, each
    counted by its formula at the local shapes its sharding rule gives;
    the plain scan and attention on the train step, whose inputs require
    grad."""
    got = runs[0][(case[0], *case[1])]
    assert got["fake_counts"][kind] == got["counts"][kind]
    assert got["counts"][kind]["per_collective"], "no collective counted"


# ------------------------------------------------------- each mesh vs one
@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_prefill_on_mesh_matches_one_process(runs, single, case):
    name, run = case
    got = runs[0][(name, *run)]
    assert got["mesh"] == dict(zip(("data", "model"), run[0]))
    assert got["shard_shapes_ok"]
    np.testing.assert_allclose(got["prefill"].numpy(),
                               single[name]["prefill"].numpy(), **fam.F32)
    assert got["prefill_placements"] == fam.logits_placements(run[0])


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_decode_on_mesh_matches_one_process(runs, single, case):
    """Decode steps through the bundle; the three-part rwkv state and
    zamba2's conv and SSD states and KV ring buffer are written in place,
    each rank its own shard."""
    name, run = case
    got, ref = runs[0][(name, *run)], single[name]
    np.testing.assert_allclose(got["decode"].numpy(),
                               ref["decode"].numpy(), **fam.F32)
    assert torch.equal(got["decode"].argmax(-1), ref["decode"].argmax(-1))
    assert got["cache_in_place"] and got["cache_shapes_ok"]
    for a, b in zip(fam.leaves(got["cache"]), fam.leaves(ref["cache"])):
        np.testing.assert_allclose(a, b, **fam.F32)


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_train_on_mesh_matches_one_process(runs, single, case):
    name, run = case
    got, ref = runs[0][(name, *run)], single[name]
    np.testing.assert_allclose(got["loss"], ref["loss"],
                               rtol=fam.LOSS_RTOL)
    fam.assert_grads_close(got["grads"], ref["grads"], name)
    np.testing.assert_allclose(got["train_losses"], ref["train_losses"],
                               rtol=fam.LOSS_RTOL)


# ------------------------------------------------- the gla_chunked rule
@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_prefill_scans_run_on_each_ranks_heads(runs, single, case):
    """Rank 0's calls at the ``ssm_scan`` op, one a layer: the batch split
    on 'data', the heads on 'model' (rwkv6 4 / m heads of 64, zamba2 16 /
    m of 32 at reduced()); mamba's q and k stay stride-0 views over
    heads."""
    from repro_torch.configs import get_config
    name, ((d, m), _) = case
    cfg = get_config(name).reduced()
    calls = runs[0][(name, (d, m), "default")]["gla_calls"]
    assert len(calls) == cfg.num_layers
    heads = cfg.num_heads if name == "rwkv6-1.6b" else \
        cfg.ssm.expand * cfg.d_model // cfg.ssm.head_dim
    for call in calls:
        (q_shape, q_stride), (k_shape, k_stride) = call[0], call[1]
        assert q_shape == (fam.B // d, fam.S, heads // m, q_shape[3])
        assert k_shape == q_shape
        if name == "zamba2-7b":
            assert q_stride[2] == 0 and k_stride[2] == 0


@pytest.mark.parametrize("run", RUNS, ids=fam.mesh_id)
@pytest.mark.parametrize("variant", ["rwkv", "mamba"])
def test_gla_rule_gives_the_unsharded_op(runs, run, variant):
    """q, k, v, log_w split on batch ('data') and heads ('model'), bonus
    on heads, the initial state on both: y and the final state equal the
    unsharded op's and keep those splits."""
    got = runs[0][("rwkv6-1.6b", *run)]["gla"][variant]
    assert got["y_err"] <= 1e-5 and got["state_err"] <= 1e-5, got
    assert got["placements"] == [["Shard(dim=0)", "Shard(dim=2)"],
                                 ["Shard(dim=0)", "Shard(dim=1)"]]


# ------------------------------------------------- (2, 2) against JAX's
@pytest.mark.parametrize("name", NAMES)
def test_prefill_and_decode_match_jax_mesh_bundles(runs, name):
    port, jx = runs
    assert jx["mesh"] == {"data": 2, "model": 2}
    got = port[(name, (2, 2), "default")]
    np.testing.assert_allclose(got["prefill"].numpy(), jx[name]["prefill"],
                               **fam.JAX_LM)
    np.testing.assert_allclose(got["decode"].numpy(), jx[name]["decode"],
                               **fam.JAX_LM)


@pytest.mark.parametrize("name", NAMES)
def test_train_steps_match_jax_mesh_bundle(runs, name):
    port, jx = runs
    np.testing.assert_allclose(port[(name, (2, 2), "default")]
                               ["train_losses"], jx[name]["train_losses"],
                               rtol=fam.LOSS_RTOL)


# ------------------------------------------------- entry points
@pytest.mark.parametrize("name", NAMES)
def test_serve_cli_on_a_data_mesh(capfd, name):
    from repro_torch.launch import serve as tserve
    toks = tserve.main(["--arch", name, "--smoke", "--batch", "4",
                        "--prompt-len", "6", "--gen", "3", "--devices", "2",
                        "--device", "cpu"])
    assert toks.shape == (4, 3) and ((toks >= 0) & (toks < 1024)).all()
    assert "mesh {'data': 2, 'model': 1}" in capfd.readouterr().out


def test_train_cli_on_a_mesh(capfd):
    """``launch.train --devices 2 --model-axis 2`` trains zamba2 (its
    scans' heads split on 'model') to the loss one device gives (bf16
    compute, the ranks' split sums rounding elsewhere)."""
    from repro_torch.launch import train as ttrain
    argv = ["--arch", "zamba2-7b", "--smoke", "--batch", "2", "--seq", "32",
            "--steps", "2", "--log-every", "1", "--device", "cpu"]
    one = ttrain.main(argv + ["--devices", "1"])
    two = ttrain.main(argv + ["--devices", "2", "--model-axis", "2"])
    assert "mesh {'data': 1, 'model': 2}" in capfd.readouterr().out
    assert two["losses"][1] == pytest.approx(one["losses"][1], abs=1e-4)
    assert two["losses"][2] == pytest.approx(one["losses"][2], abs=2e-3)
