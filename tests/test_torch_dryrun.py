"""The step bundles (``repro_torch.launch.steps``) and the dry run
(``repro_torch.launch.dryrun``) on ``meta``, held against the JAX
package: a reduced config's per-device argument and aliased bytes at
mesh (1, 1) equal ``compiled.memory_analysis()``'s on the CPU exactly,
and its output bytes but for XLA's tuple index table (8 bytes a leaf);
full-size residency at the production meshes equals what JAX's rules
(``repro.nn.sharding.spec_for``) give, leaf by leaf, beside rank 0's
partitioned count (made in a child process; more of it in
``tests/test_torch_dryrun_partitioned.py``)."""
import dataclasses
import json
import math
import subprocess
import sys

import pytest
import torch

from repro.configs import all_configs as j_all_configs
from repro.models.api import build_model as j_build_model
from repro.nn import sharding as jshd
from repro_torch.configs import INPUT_SHAPES, all_configs, get_config
from repro_torch.configs.base import InputShape
from repro_torch.launch import dryrun, steps
from repro_torch.launch.mesh import abstract_mesh
from repro_torch.nn.param import tree_leaves
from repro_torch.nn.sharding import RULE_SETS, NamedSharding
from test_torch_hlo import jax_compiled

ONE = abstract_mesh((1, 1), ("data", "model"))


def _reduced_overrides(arch):
    """``reduced()``'s fields as ``dryrun_one``'s ``overrides``."""
    full, red = get_config(arch), get_config(arch).reduced()
    return {f.name: getattr(red, f.name) for f in dataclasses.fields(red)
            if getattr(red, f.name) != getattr(full, f.name)}


def _leaf_count(tree):
    if isinstance(tree, dict):
        return sum(_leaf_count(v) for v in tree.values())
    if isinstance(tree, (tuple, list)):
        return sum(_leaf_count(v) for v in tree)
    return 1


@pytest.mark.parametrize("kind,donate", [("train", (0, 1)),
                                         ("prefill", ()),
                                         ("decode", (1,))])
def test_bundle_structure(kind, donate):
    cfg = get_config("llama3.2-1b").reduced()
    b = steps.make_bundle(cfg, InputShape("t", 64, 2, kind), ONE,
                          RULE_SETS["default"])
    assert b.donate_argnums == donate
    assert len(b.abstract_args) == len(b.in_shardings) == \
        (3 if kind == "train" else 2 if kind == "prefill" else 3)
    pairs = [p for a, s in zip(b.abstract_args, b.in_shardings)
             for p in dryrun._pairs(a, s)]
    assert pairs and all(t.device.type == "meta"
                         and isinstance(s, NamedSharding) for t, s in pairs)
    with torch.no_grad() if kind != "train" else torch.enable_grad():
        out = b.fn(*b.abstract_args)
    outs = list(dryrun._pairs(out, b.out_shardings))
    assert all(t.device.type == "meta" for t, _ in outs)
    if kind == "train":
        params, opt, loss, metrics = out
        assert sorted(opt) == ["m", "step", "v"]
        assert opt["m"]["embedding"].dtype == torch.bfloat16
        assert loss.shape == () and sorted(metrics) == ["aux", "ce"]
        assert [t.shape for t in tree_leaves(params)] == \
            [t.shape for t in tree_leaves(b.abstract_args[0])]
    else:
        logits = out if kind == "prefill" else out[0]
        assert logits.shape == (2, 1, cfg.vocab_size)


ARCHS = ["repro-100m", "llama3.2-1b", "rwkv6-1.6b", "zamba2-7b",
         "grok-1-314b", "seamless-m4t-large-v2", "internvl2-2b"]


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", ARCHS)
def test_one_card_bytes_equal_jax_s_memory_analysis(arch, kind,
                                                    monkeypatch):
    """Exact for the arguments and the aliased (donated) bytes.  JAX's
    ``jit`` drops arguments a step does not read unless told to keep them
    (seamless' encoder in decode, rwkv6's ``pos``): the port holds them,
    so JAX's side keeps them too.  XLA's outputs add an 8-byte index
    entry for each leaf of a flattened output tuple (none for a single
    array)."""
    name = f"test_{kind}"
    monkeypatch.setitem(INPUT_SHAPES, name, InputShape(name, 64, 2, kind))
    rec = dryrun.dryrun_one(arch, name, mesh="1x1",
                            overrides=_reduced_overrides(arch),
                            verbose=False)
    assert rec["status"] == "ok" and rec["counted_on"] == "meta"
    mem = jax_compiled(arch, kind).memory_analysis()
    got = rec["memory_analysis"]
    assert got["argument_size_in_bytes"] == mem.argument_size_in_bytes
    assert got["alias_size_in_bytes"] == mem.alias_size_in_bytes
    bundle = steps.make_bundle(get_config(arch).reduced(),
                               INPUT_SHAPES[name], ONE, RULE_SETS["default"])
    n_out = _leaf_count(bundle.out_shardings)
    assert mem.output_size_in_bytes - got["output_size_in_bytes"] == \
        (8 * n_out if n_out > 1 else 0)
    assert got["temp_size_in_bytes"] is None
    assert rec["hbm_resident_bytes"] == (
        got["argument_size_in_bytes"] + got["output_size_in_bytes"]
        - got["alias_size_in_bytes"])
    assert rec["chips"] == 1 and rec["collective_bytes_per_device"] == 0.0
    assert rec["roofline"]["collective_s"] == 0.0


def _jax_shard_bytes(jtree, mesh_shape):
    """Per-device bytes of a JAX spec tree under JAX's rules."""
    class FakeMesh:
        shape = mesh_shape
    total = 0
    for s in _spec_leaves(jtree):
        spec = jshd.spec_for(s.shape, s.axes, FakeMesh,
                             jshd.DEFAULT_RULES)
        dims = list(s.shape)
        for i, entry in enumerate(spec):
            for ax in (entry if isinstance(entry, tuple) else (entry,)):
                if ax is not None:
                    dims[i] //= mesh_shape[ax]
        dtype = getattr(torch, s.dtype)
        total += math.prod(dims) * torch.empty((), dtype=dtype).element_size()
    return total


def _spec_leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _spec_leaves(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _spec_leaves(v)
    else:
        yield tree


FULL_SIZE = ["llama3.2-1b", "zamba2-7b", "rwkv6-1.6b"]
FULL_SIZE_SCRIPT = """
import sys
from repro_torch.launch import dryrun
for meshes in ("--both-meshes", "--one-card"):
    dryrun.main(["--arch", sys.argv[2], "--shape", "decode_32k", meshes,
                 "--out", sys.argv[1]])
"""


@pytest.fixture(scope="module", autouse=True)
def full_size_children(tmp_path_factory):
    """``production_records``' children, started with the module so that
    they count beside its other tests: a child process an arch runs
    ``dryrun.main`` for decode_32k on both production meshes and on one
    card (the partitioned count's fake process group lives and dies
    there).  (the records' directory, the children)."""
    out = tmp_path_factory.mktemp("dryrun")
    procs = [subprocess.Popen([sys.executable, "-c", FULL_SIZE_SCRIPT,
                               str(out), arch],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for arch in FULL_SIZE]
    yield out, procs
    for p in procs:
        p.kill()


@pytest.fixture(scope="module")
def production_records(full_size_children):
    """The children's records: {(arch, mesh): record}."""
    out, procs = full_size_children
    logs = [p.communicate(timeout=600)[0] for p in procs]
    assert all(p.returncode == 0 for p in procs), \
        "\n".join(log[-3000:] for log in logs)
    recs = [json.loads(p.read_text()) for p in out.glob("*.json")]
    return {(r["arch"], r["mesh"]): r for r in recs}


@pytest.mark.parametrize("mesh", ["16x16", "2x16x16"])
@pytest.mark.parametrize("arch", FULL_SIZE)
def test_full_size_decode_residency_follows_jax_s_rules(production_records,
                                                        arch, mesh):
    """The parameters and the decode cache at full size, on the
    production meshes: each leaf's per-device bytes as JAX's rules shard
    it (the port's own rules are held to JAX's in test_torch_sharding).
    The count is rank 0's (``"per_device": "rank0"``), its collectives
    counted, and at least the whole step's FLOPs over the chips."""
    rec = production_records[(arch, mesh)]
    assert rec["status"] == "ok"
    assert rec["per_device"] == "rank0"
    assert rec["collective_bytes_per_device"] > 0 and rec["collectives"]
    assert rec["collective_bytes_per_device"] == sum(
        c["bytes"] for c in rec["collectives"].values())
    assert rec["roofline"]["collective_s"] > 0
    shape, names = dryrun.MESHES[mesh]
    mesh_shape = dict(zip(names, shape))
    jm = j_build_model(j_all_configs()[arch])
    jshape = INPUT_SHAPES["decode_32k"]
    params = _jax_shard_bytes(jm.param_specs(), mesh_shape)
    cache = _jax_shard_bytes(
        jm.cache_specs(jshape.global_batch, jshape.seq_len), mesh_shape)
    batch = 2 * 4 * jshape.global_batch // math.prod(
        mesh_shape[a] for a in ("pod", "data") if a in mesh_shape)
    assert rec["memory_analysis"]["argument_size_in_bytes"] == \
        params + cache + batch
    assert rec["memory_analysis"]["alias_size_in_bytes"] == cache
    assert rec["hlo_flops_per_device"] * rec["chips"] >= \
        production_records[(arch, "1x1")]["hlo_flops_per_device"]


def test_skip_reason_is_jax_s():
    for name, cfg in all_configs().items():
        for sname, shape in INPUT_SHAPES.items():
            reason = dryrun.skip_reason(cfg, shape)
            assert (reason is not None) == (
                sname == "long_500k" and not cfg.supports_long_context)
    rec = dryrun.dryrun_one("seamless-m4t-large-v2", "long_500k",
                            verbose=False)
    assert rec["status"] == "skipped" and "cross-attention" in rec["reason"]


def test_cli_writes_one_record_per_combination(tmp_path, capsys):
    recs = dryrun.main(["--arch", "llama3.2-1b", "--shape", "long_500k",
                        "--one-card", "--out", str(tmp_path)])
    assert [r["status"] for r in recs] == ["ok"]
    path = tmp_path / "llama3.2-1b__long_500k__1x1__default.json"
    rec = json.loads(path.read_text())
    assert rec["mesh"] == "1x1" and rec["chips"] == 1
    assert rec["counted_on"] == "meta" and rec["fits_hbm"]
    # the ring-buffer cache of 8192 slots, not 524,288
    cfg = get_config("llama3.2-1b")
    cache = 2 * cfg.num_layers * 8192 * cfg.num_kv_heads \
        * cfg.resolved_head_dim() * 2
    assert rec["memory_analysis"]["alias_size_in_bytes"] == cache
    assert dryrun.main(["--arch", "llama3.2-1b", "--shape", "long_500k",
                        "--one-card", "--out", str(tmp_path),
                        "--skip-existing"]) == []
    assert "1 ok, 0 skipped, 0 errors" in capsys.readouterr().out
