"""Step accounting (``repro_torch.launch.hlo``) against the JAX package's
(``repro.launch.hlo.analyze_hlo`` on the compiled CPU module).

JAX's own cases (``tests/test_hlo.py``) recast as small torch programs;
the plain route's FLOPs of prefill and decode equal JAX's exactly for the
decoder families and the encoder-decoder at ``reduced()``, (2, 64); the
train step equals JAX's but for one term (below); the kernel route on
``meta`` equals the dot route less the attention's products plus the
flash formula; each kernel op is counted once, by its formula."""
import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs import get_config as j_get_config
from repro.configs.base import InputShape as JShape
from repro.launch import steps as jsteps
from repro.launch.hlo import analyze_hlo
from repro.nn.sharding import RULE_SETS as J_RULES
from repro_torch.configs import get_config
from repro_torch.configs.base import InputShape
from repro_torch.kernels.alpha_combine import ops as ac
from repro_torch.kernels.disagreement import ops as dg
from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.kernels.ssm_scan import ops as ss
from repro_torch.launch import steps
from repro_torch.launch.hlo import StepCounter, analyze_step
from repro_torch.launch.mesh import abstract_mesh
from repro_torch.nn.sharding import RULE_SETS

B, S = 2, 64
ONE = abstract_mesh((1, 1), ("data", "model"))


def jax_compiled(arch, kind, b=B, s=S):
    """JAX's step of ``arch.reduced()`` at (b, s), compiled for the CPU on a
    (1, 1) mesh, every argument kept (``keep_unused``)."""
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    bundle = jsteps.make_bundle(j_get_config(arch).reduced(),
                                JShape("t", s, b, kind), mesh,
                                J_RULES["default"])
    with mesh:
        return jax.jit(bundle.fn, in_shardings=bundle.in_shardings,
                       out_shardings=bundle.out_shardings,
                       donate_argnums=bundle.donate_argnums,
                       keep_unused=True).lower(
                           *bundle.abstract_args).compile()


def port_bundle(arch, kind, b=B, s=S, **replace):
    cfg = get_config(arch).reduced()
    if replace:
        import dataclasses
        cfg = dataclasses.replace(cfg, **replace)
    return cfg, steps.make_bundle(cfg, InputShape("t", s, b, kind), ONE,
                                  RULE_SETS["default"])


# --------------------------------------------------- JAX's cases, in torch
def test_matmul_in_a_loop_counts_every_trip():
    x, w = torch.randn(8, 16), torch.randn(16, 16)

    def step(x, w):
        for _ in range(4):
            x = x @ w
        return x
    a = analyze_step(step, x, w)
    assert a.flops == 2 * 8 * 16 * 16 * 4
    # each mm reads x (8x16) and w (16x16) and writes 8x16, in fp32
    assert a.hbm_bytes == 4 * (8 * 16 + 16 * 16 + 8 * 16) * 4
    assert a.collective_bytes == 0 and a.per_collective == {}


def test_bytes_of_an_op_chain():
    x = torch.randn(32, 64)
    a = analyze_step(lambda t: ((t + 1.0) * 2.0).sum(), x)
    n = 32 * 64 * 4
    # add: x in, out; mul: in, out; sum: in, a 4-byte scalar out
    assert a.hbm_bytes == 2 * n + 2 * n + n + 4
    assert a.flops == 0          # elementwise flops are left out, as JAX


def test_views_are_free():
    x = torch.randn(4, 8, 16)
    a = analyze_step(lambda t: t.reshape(32, 16).t().unsqueeze(0)
                     .expand(3, 16, 32).transpose(1, 2)[:, 1:, ::2], x)
    assert a.hbm_bytes == 0 and a.flops == 0


def test_collectives_count_result_bytes_all_reduce_twice(tmp_path):
    import torch.distributed._functional_collectives as funcol
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                            world_size=1, rank=0)
    try:
        x = torch.randn(8, 16)

        def step(x):
            for _ in range(4):
                x = funcol.all_reduce(x, "sum", dist.group.WORLD)
            return funcol.wait_tensor(
                funcol.all_gather_tensor(x, 0, dist.group.WORLD))
        a = analyze_step(step, x)
    finally:
        dist.destroy_process_group()
    ar, ag = a.per_collective["all-reduce"], a.per_collective["all-gather"]
    assert ar == (4, 4 * 2 * 8 * 16 * 4)
    assert ag == (1, 8 * 16 * 4)       # one rank: the gather is x itself
    assert a.collective_bytes == ar[1] + ag[1]


# ------------------------------------------------- parity with JAX's count
PARITY = ["llama3.2-1b", "gemma-7b", "zamba2-7b", "grok-1-314b",
          "internvl2-2b", "seamless-m4t-large-v2", "rwkv6-1.6b"]


@pytest.mark.parametrize("kind", ["prefill", "decode"])
@pytest.mark.parametrize("arch", PARITY)
def test_plain_route_flops_equal_jax_s(arch, kind):
    """Exact.  rwkv6 and zamba2's scans are counted by the ``gla_chunked``
    op's formula, JAX's by the dots of its jnp chunked scan: the formula
    counts those dots (rwkv6's bonus diagonal, 2 B L H Dk a layer, is
    one of them: without it the port read 0.99974 of JAX)."""
    want = analyze_hlo(jax_compiled(arch, kind).as_text()).flops
    _, bundle = port_bundle(arch, kind)
    got = analyze_step(bundle.fn, *bundle.abstract_args).flops
    assert got == want


def test_train_step_flops_equal_jax_s_but_the_xent_recompute():
    """repro-100m's train step: the port counts one product more than
    XLA's compiled module, the fp32 unembedding (2 B S D V) that
    ``chunked_softmax_xent``'s checkpoint recomputes in the backward pass.
    XLA merges that recomputation with the forward's (one ``dot`` feeds
    both passes in the compiled module); PyTorch runs it again.  At
    reduced(), (2, 64): 1.0360 of JAX's."""
    want = analyze_hlo(jax_compiled("repro-100m", "train").as_text()).flops
    cfg, bundle = port_bundle("repro-100m", "train")
    got = analyze_step(bundle.fn, *bundle.abstract_args).flops
    assert got - want == 2 * B * S * cfg.d_model * cfg.vocab_size
    assert got / want == pytest.approx(1.0360, abs=1e-4)


@pytest.mark.parametrize("arch", ["llama3.2-1b", "internvl2-2b"])
def test_kernel_route_is_dot_less_attention_plus_flash_formula(arch):
    cfg, dot = port_bundle(arch, "prefill")
    _, kern = port_bundle(arch, "prefill", attention_impl="kernel")
    f_dot = analyze_step(dot.fn, *dot.abstract_args).flops
    f_kern = analyze_step(kern.fn, *kern.abstract_args).flops
    hd, h, L = cfg.resolved_head_dim(), cfg.num_heads, cfg.num_layers
    s = S                      # internvl2's frontend rows are part of S
    scores_and_pv = 2 * (2 * B * h * s * s * hd)
    flash = 4 * hd * B * h * (s * (s + 1) // 2)
    assert f_kern == f_dot - L * scores_and_pv + L * flash


# ------------------------------------------------------- the kernel ops
def _flash_args(dev):
    g = torch.Generator().manual_seed(0)
    return [torch.randn(2, 48, 4, 16, generator=g).to(dev),
            torch.randn(2, 48, 2, 16, generator=g).to(dev),
            torch.randn(2, 48, 2, 16, generator=g).to(dev)]


def _ssm_args(dev, variant):
    g = torch.Generator().manual_seed(1)
    q, k = (torch.randn(2, 40, 3, 16, generator=g) for _ in range(2))
    v = torch.randn(2, 40, 3, 8, generator=g)
    lw = -torch.rand(2, 40, 3, 16, generator=g)
    bonus = torch.randn(3, 16, generator=g)
    s0 = torch.randn(2, 3, 16, 8, generator=g)
    return [t.to(dev) for t in (q, k, v, lw, bonus, s0)]


OPS = {
    "flash_attention": (
        lambda dev: _flash_args(dev),
        lambda q, k, v: fa.flash_attention(q, k, v, causal=True, window=20),
        lambda q, k, v: fa.flash_attention_plain(q, k, v, causal=True,
                                                 window=20),
        lambda: 4 * 16 * 2 * 4 * fa.live_pairs(48, 48, True, 20)),
    "gla_chunked rwkv": (
        lambda dev: _ssm_args(dev, "rwkv"),
        lambda q, k, v, lw, u, s0: ss.gla_chunked(
            q, k, v, lw, chunk=16, variant="rwkv", bonus=u,
            initial_state=s0),
        lambda q, k, v, lw, u, s0: ss.gla_chunked_plain(
            q, k, v, lw, chunk=16, variant="rwkv", bonus=u,
            initial_state=s0),
        lambda: 2 * 3 * 3 * (2 * 16 * 16 * (16 + 8) + 4 * 16 * 16 * 8
                             + 2 * 16 * 16)),
    "alpha_combine": (
        lambda dev: [torch.randn(6, 1000).to(dev),
                     torch.rand(6, 5).to(dev)],
        ac.alpha_combine, ac.alpha_combine_plain,
        lambda: 2 * 6 * 5 * 1000),
    "disagreement": (
        lambda dev: [torch.randint(0, 4, (9, 300),
                                   generator=torch.Generator().manual_seed(2)
                                   ).to(dev),
                     torch.ones(300).to(dev)],
        dg.disagreement_counts, dg.disagreement_counts_plain,
        lambda: 2 * 9 * 9 * 300),
}


def _outputs(out):
    return out if isinstance(out, tuple) else (out,)


def _bytes(ts):
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


@pytest.mark.parametrize("name", sorted(OPS))
def test_kernel_op_counted_once_by_its_formula(name):
    make, call, plain, formula = OPS[name]
    args = make("cpu")
    with StepCounter() as c:
        out = call(*args)
    a = c.analysis()
    assert a.flops == formula()
    # inputs read once, outputs written once: nothing inside is counted
    assert a.hbm_bytes == _bytes(args) + _bytes(_outputs(out))
    for got, want in zip(_outputs(out), _outputs(plain(*args))):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    # on meta the fake gives the same shapes and dtypes, and the same count
    margs = make("meta")
    with StepCounter() as m:
        mout = call(*margs)
    assert m.analysis().as_dict() == a.as_dict()
    for got, want in zip(_outputs(mout), _outputs(out)):
        assert got.device.type == "meta"
        assert (got.shape, got.dtype, got.stride()) == \
            (want.shape, want.dtype, want.stride())
        assert got.is_contiguous()


def test_disagreement_normalized_is_the_same_op():
    preds = torch.randint(0, 4, (9, 300),
                          generator=torch.Generator().manual_seed(2))
    a = analyze_step(dg.disagreement, preds)
    assert a.flops == 2 * 9 * 9 * 300
    np.testing.assert_array_equal(
        dg.disagreement(preds).numpy(),
        (dg.disagreement_counts_plain(preds, torch.ones(300)) / 300).numpy())


@pytest.mark.parametrize("name", ["flash_attention", "gla_chunked rwkv",
                                  "alpha_combine"])
def test_grad_on_the_cpu_runs_the_plain_version_outside_the_op(name):
    make, call, plain, formula = OPS[name]
    args = make("cpu")
    args[0].requires_grad_(True)
    with StepCounter() as c:
        out = call(*args)
    assert _outputs(out)[0].grad_fn is not None
    # counted as the plain version's ops: no op of the kernel ran
    assert c.analysis().as_dict() == analyze_step(plain, *args).as_dict()
    _outputs(out)[0].sum().backward()
    assert args[0].grad is not None


def test_counter_sees_no_device_number():
    """The count is of shapes: a meta trace allocates nothing."""
    _, bundle = port_bundle("llama3.2-1b", "prefill", b=8, s=4096)
    before = torch.cuda.memory_allocated() if torch.cuda.is_available() \
        else 0
    a = analyze_step(bundle.fn, *bundle.abstract_args)
    assert a.flops > 0 and a.hbm_bytes > 0
    assert all(t.device.type == "meta"
               for t in bundle.abstract_args[1].values())
    if torch.cuda.is_available():
        assert torch.cuda.memory_allocated() == before
