"""The port's sharding rules (``repro_torch.nn.sharding``) against the JAX
package's (``repro.nn.sharding``), exactly: every parameter and decode
cache leaf of every registered config at full size, under all four rule
sets and five mesh shapes (specs only, nothing is allocated), and JAX's
own activation-spec cases."""
import pytest
from jax.sharding import PartitionSpec as JP

from repro.configs import INPUT_SHAPES as J_SHAPES
from repro.configs import all_configs as j_all_configs
from repro.models.api import build_model as j_build_model
from repro.nn import param as j_param
from repro.nn import sharding as jshd
from repro_torch.configs import INPUT_SHAPES, all_configs
from repro_torch.launch.mesh import abstract_mesh
from repro_torch.models.api import build_model
from repro_torch.nn import sharding as shd
from repro_torch.nn.param import ParamSpec


class FakeMesh:
    """Duck-typed mesh exposing .shape (``tests/test_sharding.py``'s)."""
    def __init__(self, shape):
        self.shape = shape


MESHES = {
    "16x16": {"data": 16, "model": 16},
    "2x16x16": {"pod": 2, "data": 16, "model": 16},
    "1x1": {"data": 1, "model": 1},
    "2x4": {"data": 2, "model": 4},
    "1x8": {"data": 1, "model": 8},
}


def _leaves(tree, path=()):
    """(path, spec) of every ParamSpec leaf of nested dicts and tuples."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tree


def _spec_trees(name):
    """(JAX's, the port's) spec trees of a config: its parameters and the
    decode cache of each decode input shape."""
    jm, tm = j_build_model(j_all_configs()[name]), \
        build_model(all_configs()[name])
    out = [("params", jm.param_specs(), tm.param_specs())]
    for sname, shape in INPUT_SHAPES.items():
        if shape.kind != "decode":
            continue
        jshape = J_SHAPES[sname]
        out.append((f"cache {sname}",
                    jm.cache_specs(jshape.global_batch,
                                   jm.decode_cache_len(jshape)),
                    tm.cache_specs(shape.global_batch,
                                   tm.decode_cache_len(shape))))
    return out


def test_rule_sets_are_jax_s():
    assert shd.RULE_SETS == jshd.RULE_SETS


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("rules", sorted(jshd.RULE_SETS))
def test_spec_for_matches_jax_on_every_leaf(rules, mesh):
    fake = FakeMesh(MESHES[mesh])
    n = 0
    for name in sorted(all_configs()):
        for what, jtree, ttree in _spec_trees(name):
            jl, tl = list(_leaves(jtree)), list(_leaves(ttree))
            assert [p for p, _ in jl] == [p for p, _ in tl], (name, what)
            for (path, js), (_, ts) in zip(jl, tl):
                assert (ts.shape, ts.axes) == (js.shape, js.axes)
                want = jshd.spec_for(js.shape, js.axes, fake,
                                     jshd.RULE_SETS[rules])
                got = shd.spec_for(ts.shape, ts.axes, fake,
                                   shd.RULE_SETS[rules])
                assert tuple(got) == tuple(want), (name, what, path)
                n += 1
    assert n >= 200          # 11 configs, their stacked leaves and caches


@pytest.mark.parametrize("axes,dims,mesh", [
    (("batch", None, "embed_act"), (256, 4096, 2048), "2x16x16"),
    (("batch", None), (8, 128), "2x16x16"),
    (("batch", None, "vocab"), (128, 1, 128256), "16x16"),
    (("batch", None, "vocab"), (1, 1, 65536), "2x16x16"),
    (("batch", "seq", "heads", None), (4, 2048, 32, 64), "2x4"),
    (("batch", None, "embed_act"), None, "2x16x16"),
    (("embed_act", "embed_act"), (32, 32), "1x8"),
    (("clients", "batch"), (16, 64), "16x16"),
])
@pytest.mark.parametrize("rules", sorted(jshd.RULE_SETS))
def test_activation_spec_matches_jax(rules, axes, dims, mesh):
    fake = FakeMesh(MESHES[mesh])
    want = jshd.activation_spec(fake, jshd.RULE_SETS[rules], *axes,
                                dims=dims)
    got = shd.activation_spec(fake, shd.RULE_SETS[rules], *axes, dims=dims)
    assert tuple(got) == tuple(want)


def test_jax_s_own_cases():
    """``tests/test_sharding.py``'s cases, on the port."""
    mesh = FakeMesh(MESHES["16x16"])
    pod = FakeMesh(MESHES["2x16x16"])
    rules = shd.DEFAULT_RULES
    assert shd.spec_for((1024, 8, 64), ("embed", "kv_heads", "qkv"), mesh,
                        rules) == shd.PartitionSpec("data")
    assert shd.spec_for((1024, 32, 64), ("embed", "kv_heads", "qkv"), mesh,
                        rules) == shd.PartitionSpec("data", "model")
    assert list(shd.spec_for((1024, 512), ("vocab", "mlp"), mesh,
                             rules)).count("model") == 1
    ep = shd.RULE_SETS["expert_parallel"]
    assert shd.spec_for((16, 1024, 512), ("experts", "embed", "mlp"), mesh,
                        ep)[0] == "data"
    assert shd.spec_for((16, 1024, 512), ("experts", "embed", "mlp"), mesh,
                        rules)[0] is None
    spec = shd.activation_spec(pod, rules, "batch", None, "embed_act",
                               dims=(256, 4096, 2048))
    assert spec[0] == ("pod", "data") and spec[2] == "model"
    one = abstract_mesh((1, 1), ("data", "model"))
    assert shd.spec_for((128, 256), ("embed", "mlp"), one, rules) == \
        shd.PartitionSpec()
    tree = {"w": ParamSpec((1024, 512), ("embed", "mlp")),
            "b": ParamSpec((512,), ("mlp",))}
    specs = shd.tree_pspecs(tree, mesh, rules)
    assert specs == {"w": shd.PartitionSpec("data", "model"),
                     "b": shd.PartitionSpec("model")}
    jspecs = jshd.tree_pspecs(
        {k: j_param.ParamSpec(v.shape, v.axes) for k, v in tree.items()},
        mesh, jshd.DEFAULT_RULES)
    assert {k: tuple(v) for k, v in specs.items()} == \
        {k: tuple(v) for k, v in jspecs.items()}
    assert jspecs["w"] == JP("data", "model")


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_shard_shape_divides_by_the_named_axes(mesh):
    m = abstract_mesh(tuple(MESHES[mesh].values()), tuple(MESHES[mesh]))
    tree = {"w": ParamSpec((1024, 32, 64), ("embed", "heads", "qkv")),
            "c": ParamSpec((128, 4096, 8, 64),
                           ("batch", "kv_seq", "kv_heads", "qkv"))}
    sh = shd.tree_shardings(tree, m, shd.DEFAULT_RULES)
    for k, s in tree.items():
        got = sh[k].shard_shape(s.shape)
        want = list(s.shape)
        for i, entry in enumerate(sh[k].spec):
            for ax in (entry if isinstance(entry, tuple) else (entry,)):
                if ax is not None:
                    want[i] //= m.shape[ax]
        assert got == tuple(want)
    if mesh == "2x16x16":    # the cache's batch over pod x data: 128 / 32
        assert sh["c"].shard_shape((128, 4096, 8, 64))[0] == 4


def test_shard_shape_refuses_a_dim_the_axes_do_not_divide():
    m = abstract_mesh((2, 4), ("data", "model"))
    with pytest.raises(ValueError):
        shd.NamedSharding(m, shd.PartitionSpec("model")).shard_shape((6,))
