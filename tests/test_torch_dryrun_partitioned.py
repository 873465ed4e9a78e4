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
from repro_torch.kernels.ssm_scan import ops as ss_ops
from repro_torch.launch.hlo import analyze_step
from repro_torch.nn.sharding import RULE_SETS
from test_torch_dryrun import ONE, _reduced_overrides
from test_torch_hlo import PARITY

sys.path.insert(0, str(Path(__file__).resolve().parent))
import _torch_mesh_families as fam  # noqa: E402

B, S = 4, 64

# rank 0's FLOPs over JAX's per-device FLOPs at reduced(), (4, 64), on
# (2, 2), both on their plain routes.  Every decode step computes JAX's
# share (1) or under it, but grok-1's, whose router product runs on each
# 'model' rank's whole rows (4,096 FLOPs a layer), and zamba2's, whose
# mamba in_proj contracts the residual's half of d_model for every
# output column on each rank (its prefill too; ROADMAP item j).  Under
# 1: JAX's partitioned prefill computes more than a quarter of its whole
# step, where rank 0's prefill is a quarter exactly; so is rwkv6's
# decode.
RANK0_OVER_JAX = {
    ("llama3.2-1b", "prefill"): Fraction(529, 545),
    ("llama3.2-1b", "decode"): Fraction(1),
    ("gemma-7b", "prefill"): Fraction(529, 545),
    ("gemma-7b", "decode"): Fraction(1),
    ("zamba2-7b", "prefill"): Fraction(13, 11),
    ("zamba2-7b", "decode"): Fraction(338, 269),
    ("grok-1-314b", "prefill"): Fraction(67, 68),
    ("grok-1-314b", "decode"): Fraction(3490, 3489),
    ("internvl2-2b", "prefill"): Fraction(529, 545),
    ("internvl2-2b", "decode"): Fraction(1),
    ("seamless-m4t-large-v2", "prefill"): Fraction(701, 717),
    ("seamless-m4t-large-v2", "decode"): Fraction(1),
    ("rwkv6-1.6b", "prefill"): Fraction(3913, 4234),
    ("rwkv6-1.6b", "decode"): Fraction(4289, 4353),
}

# llama3.2-1b's decode_32k on 16x16: rank 0's FLOPs over an even share of
# the one-card step's at most this.  Its 8 kv heads do not divide the
# model axis of 16, so JAX's rule replicates them and the k/v projection
# runs on every 'model' rank (~1.15); every other product splits.
DECODE_32K_OVER_SHARE = 1.2

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

from repro_torch.configs import INPUT_SHAPES
from repro_torch.kernels.ssm_scan import ops as ss
from repro_torch.nn import attention, linear_attn

inp = pickle.load(open(sys.argv[1], "rb"))
out = {"parity": {}, "decode_local": {}}
seen = {}


def noting(name, fn):
    # the local shapes of rank 0's operands where it runs the products
    def run(*a, **kw):
        seen[name].append(tuple(tuple(t.shape) for t in a[:3]))
        return fn(*a, **kw)
    return run


attention._dot_blocks = noting("attention", attention._dot_blocks)
linear_attn._gla_decode = noting("gla", linear_attn._gla_decode)
with dryrun.fake_world(4):
    dm = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    for arch in inp["archs"]:
        for kind in ("prefill", "decode"):
            bd = steps.make_bundle(get_config(arch).reduced(),
                                   InputShape("t", inp["s"], inp["b"], kind),
                                   dm, RULE_SETS["default"])
            seen.update(attention=[], gla=[])
            out["parity"][(arch, kind)] = dryrun.rank0_count(bd, dm)[1] \
                .as_dict()
            if kind == "decode":
                out["decode_local"][arch] = {k: list(v)
                                             for k, v in seen.items()}
with dryrun.fake_world(256):
    for mesh in ("16x16", "1x1"):
        out[mesh] = dryrun.count_step(get_config("llama3.2-1b"),
                                      INPUT_SHAPES["decode_32k"], mesh,
                                      "default")[2].flops
    dm = init_device_mesh("cpu", (16, 16), mesh_dim_names=("data", "model"))

    def shard(local, placements):
        return DTensor.from_local(
            torch.empty(local, device="meta"), dm, placements,
            run_check=False, shape=torch.Size((32, 32)), stride=(32, 1))

    # the scan op at 32 heads on 'model', batch on 'data'
    q = DTensor.from_local(torch.empty(1, 8, 2, 16, device="meta"), dm,
                           [Shard(0), Shard(2)], run_check=False,
                           shape=torch.Size((16, 8, 32, 16)),
                           stride=(4096, 512, 16, 1))
    with StepCounter() as c:
        y, _ = ss.gla_chunked(q, q, q, q, chunk=8, variant="mamba")
    out["scan"] = dict(flops=c.flops, local=tuple(y.to_local().shape),
                       placements=[repr(p) for p in y.placements])

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


@pytest.mark.parametrize("arch", PARITY)
def test_decode_runs_on_rank0_s_rows_and_heads(counts, arch):
    """On (2, 2) rank 0's decode products read its own rows and heads
    only: each attention's q (B/2, 1, H/2, hd) and K, V (B/2, S, H/2, hd),
    self and cross, from a cache whose kv heads are split or replicated;
    each state readout's q, k (B/2, H/2, dk) (rwkv6's time mix, zamba2's
    mamba layers).  No operand holds every head or every row."""
    port, _ = counts
    cfg = get_config(arch).reduced()
    local = port["decode_local"][arch]
    assert local["attention"] or local["gla"]
    h, hd = cfg.num_heads, cfg.resolved_head_dim()
    for q, k, v in local["attention"]:
        assert q == (B // 2, 1, h // 2, hd)
        assert k[0] == v[0] == B // 2 and k[1] == v[1] > 1
        assert k[2:] == v[2:] == (h // 2, hd)
    for q, k, _ in local["gla"]:
        heads = h if arch == "rwkv6-1.6b" \
            else cfg.ssm.expand * cfg.d_model // cfg.ssm.head_dim
        assert q[:2] == k[:2] == (B // 2, heads // 2)


def test_decode_32k_on_16x16_near_an_even_share(counts):
    """llama3.2-1b's decode_32k on 16x16: rank 0's FLOPs x 256 over the
    one-card step's at most ``DECODE_32K_OVER_SHARE`` (each rank's own
    batch rows and query heads in its attention)."""
    port, _ = counts
    ratio = port["16x16"] * 256 / port["1x1"]
    print(f"llama3.2-1b decode_32k on 16x16: rank 0 over an even share "
          f"{ratio:.4f}")
    assert 1.0 <= ratio <= DECODE_32K_OVER_SHARE


def test_scan_keeps_a_heads_split_on_one_axis_of_16x16(counts):
    """The ``ssm_scan`` op at 32 heads, laid out batch on 'data' and
    heads on 'model' of a 16x16 mesh, runs on rank 0's (1, L, 2, D)
    shard: its sharding rule offers the heads split where 32 heads do
    not divide the 256 ranks, as only 'model' splits them."""
    port, _ = counts
    got = port["scan"]
    assert got["local"] == (1, 8, 2, 16)
    assert got["placements"] == ["Shard(dim=0)", "Shard(dim=2)"]
    assert got["flops"] == ss_ops.gla_flops(16, 8, 32, 16, 16, 8,
                                            "mamba") / 256


@pytest.mark.parametrize("heads,sizes,even", [
    (32, (16, 16), True), (112, (16, 16), True), (4, (2, 2), True),
    (48, (4, 16), True), (6, (2, 2), False), (96, (4, 16), False),
    (40, (16, 16), False), (8, (1, 4), True)])
def test_heads_split_even(heads, sizes, even):
    """Every set of mesh dims splits the heads evenly (its size divides
    them) or is refused by DTensor (more shards than heads)."""
    assert ss_ops.heads_split_even(heads, sizes) is even


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
