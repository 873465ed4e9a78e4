"""The partitioned dry run (``repro_torch.launch.dryrun``): rank 0 of a
step run as a DTensor program over a ``"fake"`` process group, on
``meta`` shards, counted by ``launch.hlo.StepCounter``.  Held (b) against
JAX's per-device count of its (2, 2) bundles compiled for four forced
host devices, (c) on one card against the whole step's count, and (d) on
a small DTensor program whose collectives are known, over a fake group
of 256 ranks.  Each count that needs a process group runs in a child
process, so that no group outlives it in the test's process.  The fake
count against a live world's rank 0 (a) is in ``tests/test_torch_mesh*.py``.
"""
import pickle
import sys
from fractions import Fraction
from pathlib import Path

import pytest
import torch.distributed as dist

from repro_torch.configs import INPUT_SHAPES, get_config
from repro_torch.configs.base import InputShape
from repro_torch.launch import dryrun, steps
from repro_torch.launch.hlo import analyze_step
from repro_torch.nn.sharding import RULE_SETS
from test_torch_dryrun import ONE, _reduced_overrides
from test_torch_hlo import PARITY

sys.path.insert(0, str(Path(__file__).resolve().parent))
import _torch_mesh_families as fam  # noqa: E402

B, S = 4, 64

# rank 0's FLOPs over JAX's per-device FLOPs at reduced(), (4, 64), on
# (2, 2), both on their plain routes; no step agrees exactly.  Over 1:
# rank 0 computes more than its share (its decode attention on rows or
# heads that JAX splits, zamba2's mamba in_proj; ROADMAP's open work on
# the ported modules, items i and j).
# Under 1: JAX's partitioned prefill computes more than a quarter of its
# whole step, where rank 0's prefill is a quarter exactly (but zamba2's).
RANK0_OVER_JAX = {
    ("llama3.2-1b", "prefill"): Fraction(529, 545),
    ("llama3.2-1b", "decode"): Fraction(42, 37),
    ("gemma-7b", "prefill"): Fraction(529, 545),
    ("gemma-7b", "decode"): Fraction(42, 37),
    ("zamba2-7b", "prefill"): Fraction(13, 11),
    ("zamba2-7b", "decode"): Fraction(342, 269),
    ("grok-1-314b", "prefill"): Fraction(67, 68),
    ("grok-1-314b", "decode"): Fraction(3650, 3489),
    ("internvl2-2b", "prefill"): Fraction(529, 545),
    ("internvl2-2b", "decode"): Fraction(42, 37),
    ("seamless-m4t-large-v2", "prefill"): Fraction(701, 717),
    ("seamless-m4t-large-v2", "decode"): Fraction(84, 67),
    ("rwkv6-1.6b", "prefill"): Fraction(3913, 4234),
    ("rwkv6-1.6b", "decode"): Fraction(4354, 4353),
}

JAX_SCRIPT = r"""
import os, pickle, sys
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=4")
import jax
from repro.configs import get_config
from repro.configs.base import InputShape
from repro.launch import steps
from repro.launch.hlo import analyze_hlo
from repro.launch.mesh import make_local_mesh
from repro.nn.sharding import RULE_SETS

inp = pickle.load(open(sys.argv[1], "rb"))
mesh, out = make_local_mesh(2), {}
with mesh:
    for arch in inp["archs"]:
        for kind in ("prefill", "decode"):
            bd = steps.make_bundle(get_config(arch).reduced(),
                                   InputShape("t", inp["s"], inp["b"], kind),
                                   mesh, RULE_SETS["default"])
            text = jax.jit(bd.fn, in_shardings=bd.in_shardings,
                           out_shardings=bd.out_shardings,
                           donate_argnums=bd.donate_argnums,
                           keep_unused=True).lower(
                               *bd.abstract_args).compile().as_text()
            h = analyze_hlo(text)
            out[(arch, kind)] = dict(
                flops=h.flops, collective_bytes=h.collective_bytes,
                per_collective={k: tuple(v)
                                for k, v in h.per_collective.items()})
pickle.dump(out, open(sys.argv[2], "wb"))
"""

PORT_SCRIPT = r"""
import pickle, sys
import torch
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor.debug import CommDebugMode
from repro_torch.configs import get_config
from repro_torch.configs.base import InputShape
from repro_torch.launch import dryrun, steps
from repro_torch.launch.hlo import StepCounter
from repro_torch.nn.sharding import RULE_SETS

inp = pickle.load(open(sys.argv[1], "rb"))
out = {"parity": {}}
with dryrun.fake_world(4):
    dm = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    for arch in inp["archs"]:
        for kind in ("prefill", "decode"):
            bd = steps.make_bundle(get_config(arch).reduced(),
                                   InputShape("t", inp["s"], inp["b"], kind),
                                   dm, RULE_SETS["default"])
            out["parity"][(arch, kind)] = dryrun.rank0_count(bd, dm)[1] \
                .as_dict()
with dryrun.fake_world(256):
    dm = init_device_mesh("cpu", (16, 16), mesh_dim_names=("data", "model"))

    def shard(local, placements):
        return DTensor.from_local(
            torch.empty(local, device="meta"), dm, placements,
            run_check=False, shape=torch.Size((32, 32)), stride=(32, 1))

    x, w = shard((2, 32), [Shard(0), Replicate()]), \
        shard((32, 2), [Replicate(), Shard(1)])
    a, b = shard((32, 2), [Replicate(), Shard(1)]), \
        shard((2, 32), [Replicate(), Shard(0)])
    with StepCounter() as c, CommDebugMode() as comm:
        y = torch.softmax(x @ w, -1) + 0
        z = torch.softmax(a @ b, -1)
    out["program"] = dict(
        c.analysis().as_dict(),
        comm={str(k): v for k, v in comm.get_comm_counts().items()},
        placements=[[repr(p) for p in t.placements] for t in (y, z)],
        local=[tuple(t.to_local().shape) for t in (y, z)])
out["group_left"] = torch.distributed.is_initialized()
pickle.dump(out, open(sys.argv[2], "wb"))
"""


@pytest.fixture(scope="module", autouse=True)
def children(tmp_path_factory):
    """JAX's per-device counts and the port's fake counts, each in a child
    process, started with the module so that they count beside its
    in-process tests: (directory, {name: child})."""
    tmp = tmp_path_factory.mktemp("partitioned")
    with open(tmp / "in.pkl", "wb") as f:
        pickle.dump(dict(archs=PARITY, b=B, s=S), f)
    started = {name: fam.start_child(["-c", script, str(tmp / "in.pkl"),
                                      str(tmp / f"{name}.pkl")], tmp, name)
               for name, script in (("jax", JAX_SCRIPT),
                                    ("port", PORT_SCRIPT))}
    yield tmp, started
    for proc, _ in started.values():
        proc.kill()


@pytest.fixture(scope="module")
def counts(children):
    """The children's results: (port, JAX)."""
    tmp, started = children
    return tuple(fam.finish_child(started[name], tmp, name)
                 for name in ("port", "jax"))


# ------------------------------------------- (c) one card: the whole step
@pytest.mark.parametrize("arch,kind", [
    ("llama3.2-1b", "train"), ("llama3.2-1b", "prefill"),
    ("llama3.2-1b", "decode"), ("grok-1-314b", "train"),
    ("grok-1-314b", "decode"), ("rwkv6-1.6b", "prefill"),
    ("zamba2-7b", "decode"), ("seamless-m4t-large-v2", "prefill")])
def test_one_card_record_is_the_whole_step_count(arch, kind, monkeypatch):
    """``1x1`` runs with no process group and counts the plain step on
    ``meta``: its record's FLOPs and bytes are the whole step's count,
    exactly, and its collectives none."""
    name = f"test_{kind}"
    monkeypatch.setitem(INPUT_SHAPES, name, InputShape(name, 64, 2, kind))
    rec = dryrun.dryrun_one(arch, name, mesh="1x1",
                            overrides=_reduced_overrides(arch),
                            verbose=False)
    bundle = steps.make_bundle(get_config(arch).reduced(), INPUT_SHAPES[name],
                               ONE, RULE_SETS["default"])
    whole = analyze_step(bundle.fn, *bundle.abstract_args)
    assert rec["status"] == "ok" and rec["per_device"] == "rank0"
    assert rec["hlo_flops_per_device"] == whole.flops
    assert rec["hlo_bytes_per_device"] == whole.hbm_bytes
    assert rec["collective_bytes_per_device"] == 0.0
    assert rec["collectives"] == {}
    assert not dist.is_initialized()


def test_one_hot_counts_as_on_meta():
    """ATen decomposes ``F.one_hot`` by device (a bounds check, zeros and a
    scatter on the CPU; a comparison and a cast on ``meta``): the counter
    counts it as on ``meta`` everywhere, so that a live rank's count
    equals the dry run's (the MoE dispatch one-hots its expert ids)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.launch.hlo import StepCounter

    counts = []
    for device in ("cpu", "meta"):
        ids = torch.zeros(3, 5, dtype=torch.long, device=device)
        with StepCounter() as c:
            F.one_hot(ids, 4).float().sum()
        counts.append(c.analysis().as_dict())
    assert counts[0] == counts[1] and counts[0]["hbm_bytes"] > 0


def test_the_count_refuses_a_live_process_group(tmp_path):
    """A process that holds a process group that is not fake gives no
    partitioned count (the dry run would otherwise count over it)."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                            world_size=1, rank=0)
    try:
        with pytest.raises(RuntimeError, match="fake process group"):
            dryrun.dryrun_one("llama3.2-1b", "decode_32k", verbose=False)
        assert dist.get_backend() == "gloo"
    finally:
        dist.destroy_process_group()


# --------------------------------------- (b) against JAX's per device
@pytest.mark.parametrize("kind", ["prefill", "decode"])
@pytest.mark.parametrize("arch", PARITY)
def test_rank0_flops_against_jax_s_per_device(counts, arch, kind):
    """Rank 0's FLOPs over ``analyze_hlo``'s FLOPs of JAX's compiled (2, 2)
    module, exactly (``RANK0_OVER_JAX``).  The collective bytes are
    printed, not held: DTensor and XLA's partitioner choose different
    collectives (and the CPU's DTensor moves a shard between dims by an
    all-gather where a card's runs an all-to-all)."""
    port, jx = counts
    got, want = port["parity"][(arch, kind)], jx[(arch, kind)]
    print(f"{arch} {kind} on (2, 2): FLOPs rank 0 {got['flops']:.0f}, JAX "
          f"{want['flops']:.0f}; collective bytes rank 0 "
          f"{got['collective_bytes']:.0f} {got['per_collective']}, JAX "
          f"{want['collective_bytes']:.0f} {want['per_collective']}")
    assert Fraction(int(got["flops"]), int(want["flops"])) == \
        RANK0_OVER_JAX[(arch, kind)]
    assert got["collective_bytes"] > 0


# ------------------------------------- (d) known collectives on 256 ranks
def test_known_collectives_on_a_fake_group_of_256(counts):
    """x (32, 32) split on 'data' times w split on 'model' gives rank 0 a
    (2, 2) block; the softmax over the row gathers the row over the 16
    ranks of 'model' (an all-gather of (32, 2) fp32: 256 bytes).  a split
    on its columns times b split on its rows gives each rank a partial
    (32, 32) sum; the softmax needs the sum (an all-reduce of 4,096 bytes,
    counted twice: 8,192).  FLOPs: rank 0's two local products, 2 x 2 x
    32 x 2 and 2 x 32 x 2 x 32.  DTensor's own ``CommDebugMode`` sees the
    same two collectives."""
    port, _ = counts
    got = port["program"]
    assert got["flops"] == 2 * 2 * 32 * 2 + 2 * 32 * 2 * 32
    assert got["per_collective"] == {"all-gather": {"count": 1, "bytes": 256},
                                     "all-reduce": {"count": 1, "bytes": 8192}}
    assert got["collective_bytes"] == 256 + 8192
    assert sorted(got["comm"].values()) == [1, 1] and all(
        op in " ".join(got["comm"]) for op in ("all_gather_into_tensor",
                                               "all_reduce"))
    assert got["placements"] == [["Shard(dim=0)", "Replicate()"],
                                 ["Replicate()", "Replicate()"]]
    assert got["local"] == [(2, 32), (32, 32)]
    assert not port["group_left"]
