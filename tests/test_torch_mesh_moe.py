"""grok-1 (MoE) and seamless-m4t (encoder-decoder), reduced() in fp32, on
('data', 'model') meshes of four ``gloo`` ranks on the CPU: the
prefill, decode and train steps through their bundles on DTensor under
the default rules on (2, 2) and (1, 4), and grok-1 under
``EXPERT_PARALLEL_RULES`` on (4, 1) (its experts split on 'data'),
against one process and against JAX's jitted (2, 2) bundles.  MoE: the
mesh routes every token as one process does, a prefill pinned to that
routing agrees, and the load-balance loss equals one process's.
Weights are JAX's, carried across by ``convert.lm_params_from_jax``."""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
import _torch_mesh_families as fam  # noqa: E402

torch.set_num_threads(2)

MOE, ENCDEC = "grok-1-314b", "seamless-m4t-large-v2"
NAMES = [MOE, ENCDEC]
RUNS = [((2, 2), "default"), ((1, 4), "default"),
        ((4, 1), "expert_parallel")]
SKIP = [(ENCDEC, (4, 1), "expert_parallel")]      # no experts to split
CASES = [(n, r) for n in NAMES for r in RUNS if (n, *r) not in SKIP]


@pytest.fixture(scope="module")
def trees():
    return {n: fam.jax_tree(n, 2 + i) for i, n in enumerate(NAMES)}


@pytest.fixture(scope="module")
def inputs():
    return {n: fam.family_inputs(n, 20 + i) for i, n in enumerate(NAMES)}


@pytest.fixture(scope="module")
def single(trees, inputs):
    return {n: fam.single(n, trees[n], inputs[n]) for n in NAMES}


@pytest.fixture(scope="module")
def runs(single, trees, inputs, tmp_path_factory):
    return fam.run_worlds(RUNS, NAMES, trees, inputs,
                          tmp_path_factory.mktemp("mesh_moe"), skip=SKIP)


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
    grok-1's flash op (its CPU implementation in the world, its fake on
    ``meta``) on the prefill and the decode, counted by its formula at
    the local shapes its sharding rule gives, and the plain attention on
    the train step, whose inputs require grad; seamless-m4t runs no
    kernel op, as JAX."""
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
    """Decode steps through the bundle, the self-attention cache written
    in place rank by rank; seamless's cross cache built on the mesh and
    laid out on ('layers', 'batch', None, 'kv_heads', 'qkv')."""
    name, run = case
    got, ref = runs[0][(name, *run)], single[name]
    np.testing.assert_allclose(got["decode"].numpy(),
                               ref["decode"].numpy(), **fam.F32)
    assert torch.equal(got["decode"].argmax(-1), ref["decode"].argmax(-1))
    assert got["cache_in_place"] and got["cache_shapes_ok"]
    for a, b in zip(fam.leaves(got["cache"]), fam.leaves(ref["cache"])):
        np.testing.assert_allclose(a, b, **fam.F32)
    if name == ENCDEC:
        (d, m), _ = run
        assert got["cross_placements"] == [
            "Shard(dim=1)" if d > 1 else "Replicate()",
            "Shard(dim=3)" if m > 1 else "Replicate()"]


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_train_on_mesh_matches_one_process(runs, single, case):
    """The loss (with grok-1's summed load-balance loss) and every
    gradient leaf, then two train steps' losses and aux terms."""
    name, run = case
    got, ref = runs[0][(name, *run)], single[name]
    np.testing.assert_allclose(got["loss"], ref["loss"],
                               rtol=fam.LOSS_RTOL)
    fam.assert_grads_close(got["grads"], ref["grads"], name)
    np.testing.assert_allclose(got["train_losses"], ref["train_losses"],
                               rtol=fam.LOSS_RTOL)
    if name == MOE:
        assert all(aux > 0 for _, aux in got["train_losses"])


# ------------------------------------------------------- MoE routing
@pytest.mark.parametrize("run", RUNS, ids=fam.mesh_id)
def test_moe_routes_as_one_process_and_pins_hold(runs, single, run):
    """In fp32 the mesh picks every token's experts as one process does
    (a near tie could flip under the mesh's summation order; these
    inputs have none), and a prefill with that routing pinned through
    ``batch["expert_ids"]`` agrees with one process's pinned prefill."""
    got, ref = runs[0][(MOE, *run)], single[MOE]
    assert torch.equal(got["routing"], ref["routing"])
    np.testing.assert_allclose(got["prefill_pinned"].numpy(),
                               ref["prefill_pinned"].numpy(), **fam.F32)


# ------------------------------------------------- (2, 2) against JAX's
@pytest.mark.parametrize("name", NAMES)
def test_prefill_and_decode_match_jax_mesh_bundles(runs, single, name):
    port, jx = runs
    assert jx["mesh"] == {"data": 2, "model": 2}
    got = port[(name, (2, 2), "default")]
    if name == MOE:
        assert torch.equal(got["routing"], single[name]["routing"])
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
    """``launch.train --devices 2`` trains grok-1 (its load-balance loss
    in the logged loss) to the loss one device gives, within the bf16
    bar of tests/test_torch_mesh.py's train CLI test from the first
    step: the routing itself rounds in bf16 compute (observed 5.7e-4 at
    step 1)."""
    from repro_torch.launch import train as ttrain
    argv = ["--arch", MOE, "--smoke", "--batch", "2", "--seq", "32",
            "--steps", "2", "--log-every", "1", "--device", "cpu"]
    one = ttrain.main(argv + ["--devices", "1"])
    two = ttrain.main(argv + ["--devices", "2"])
    assert "mesh {'data': 2, 'model': 1}" in capfd.readouterr().out
    for step in (1, 2):
        assert two["losses"][step] == pytest.approx(one["losses"][step],
                                                    abs=2e-3)
