"""The port's CUDA kernels against their plain versions on the card,
and the LM prefills through the flash and ssm_scan kernels.

Needs a CUDA device, ``nvcc`` and nothing of JAX; skips without a GPU.
On the GPU host: ``PYTHONPATH=src python -m pytest -q -m cuda
tests/test_torch_kernels_cuda.py``."""
import numpy as np
import pytest
import torch

from repro_torch.kernels.alpha_combine import ops as ac
from repro_torch.kernels.disagreement import ops as dg

RNG = np.random.default_rng(0)


def _ac_inputs(s, t, p):
    theta = RNG.normal(size=(s, p)).astype(np.float32)
    alpha = RNG.uniform(size=(s, t)).astype(np.float32)
    return theta, alpha / alpha.sum(0, keepdims=True)


def _preds(n, m, classes=4):
    return RNG.integers(0, classes, (n, m)).astype(np.int32)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the CUDA kernels have no CPU "
                    "mode)")
    return torch.device("cuda")


# the transfer's shape, ragged edges, the simulator's scale (256 targets:
# one block's full width), T past one block (300), S no multiple of 8
@pytest.mark.cuda
@pytest.mark.parametrize("s,t,p", [(10, 10, 48158), (7, 5, 1001),
                                   (70, 40, 3001), (256, 256, 48158),
                                   (300, 300, 1001), (13, 9, 48158)])
def test_alpha_combine_kernel_on_card(cuda, s, t, p):
    theta, alpha = _ac_inputs(s, t, p)
    th, al = torch.as_tensor(theta, device=cuda), \
        torch.as_tensor(alpha, device=cuda)
    before = ac.alpha_combine.launches
    out = ac.alpha_combine(th, al)
    torch.cuda.synchronize()
    # one kernel up to 16 targets, then two: alpha's split and the product
    assert ac.alpha_combine.launches == before + (1 if t <= 16 else 2)
    torch.testing.assert_close(out, ac.alpha_combine_plain(th, al),
                               rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError):
        ac.alpha_combine(th, al.cpu())          # one device, no fallback
    with pytest.raises(ValueError):
        ac.alpha_combine(th.double(), al.double())


def _profiled_kernels(fn, calls, windows=3):
    """The device kernels the profiler records over ``calls`` calls of
    ``fn``, in each of ``windows`` windows.  The profiler now and then
    loses a kernel's record (a window counts one short), never adds one:
    a caller holds the largest count to the expected one."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    seen = []
    for _ in range(windows):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        seen.append([e.name for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA])
    return seen


@pytest.mark.cuda
@pytest.mark.parametrize("s,t,kernels", [(10, 10, 1), (64, 300, 2)])
def test_alpha_combine_counts_each_launch(cuda, s, t, kernels):
    # one kernel up to 16 targets; past them the split and the product:
    # the wrapper's count and the profiler's agree
    theta, alpha = _ac_inputs(s, t, 1001)
    th, al = torch.as_tensor(theta, device=cuda), \
        torch.as_tensor(alpha, device=cuda)
    before = ac.alpha_combine.launches
    seen = _profiled_kernels(lambda: ac.alpha_combine(th, al), 3)
    assert ac.alpha_combine.launches == before + 10 * kernels
    assert max(len(names) for names in seen) == 3 * kernels, seen


@pytest.mark.cuda
@pytest.mark.parametrize("n,m", [(10, 2500), (13, 777), (40, 130),
                                 (256, 64000), (130, 777)])
def test_disagreement_kernel_on_card(cuda, n, m):
    preds = torch.as_tensor(_preds(n, m), device=cuda)
    valid = torch.as_tensor(RNG.random(m) < 0.7, device=cuda).float()
    before = dg.disagreement_counts.launches
    out = dg.disagreement_counts(preds, valid)
    torch.cuda.synchronize()
    assert dg.disagreement_counts.launches == before + 1
    assert torch.equal(out, dg.disagreement_counts_plain(preds, valid))
    with pytest.raises(ValueError):
        dg.disagreement_counts(preds.long(), valid)


@pytest.mark.cuda
@pytest.mark.parametrize("n,m", [(10, 2500), (130, 777), (256, 64000)])
def test_disagreement_fractional_weights_are_deterministic(cuda, n, m):
    # the kernel's sum order is fixed by the shapes: the same bits on
    # every launch; torch sums in its own order, so close, not equal
    preds = torch.as_tensor(_preds(n, m), device=cuda)
    valid = torch.as_tensor(RNG.random(m), dtype=torch.float32,
                            device=cuda)
    a = dg.disagreement_counts(preds, valid)
    b = dg.disagreement_counts(preds, valid)
    assert torch.equal(a, b)
    torch.testing.assert_close(
        a, dg.disagreement_counts_plain(preds, valid), rtol=1e-6, atol=0.0)


@pytest.mark.cuda
@pytest.mark.parametrize("n,m,masked", [(10, 2500, False),
                                        (40, 3000, True),
                                        (256, 64000, False)])
def test_disagreement_normalizes_in_its_one_launch(cuda, n, m, masked):
    preds = torch.as_tensor(_preds(n, m), device=cuda)
    mask = torch.as_tensor(RNG.random(m) < 0.7, device=cuda) \
        if masked else None
    valid = torch.ones(m, device=cuda) if mask is None else mask.float()
    counts = dg.disagreement_counts_plain(preds, valid)
    before = dg.disagreement_counts.launches
    out = dg.disagreement(preds, mask)
    torch.cuda.synchronize()
    assert dg.disagreement_counts.launches == before + 1
    assert torch.equal(out, counts / torch.clamp(valid.sum(), min=1.0))


@pytest.mark.cuda
def test_disagreement_is_one_kernel_a_call(cuda):
    # the profiler sees one device kernel per call (no scratch pass, no
    # division or mask launches) for the main path's call
    preds = torch.as_tensor(_preds(10, 2500), device=cuda)
    seen = _profiled_kernels(lambda: dg.disagreement(preds), 5)
    assert max(len(names) for names in seen) == 5, seen
    assert all("disagreement_kernel" in n for names in seen for n in names)


@pytest.mark.cuda
def test_transfer_goes_through_the_kernel(cuda):
    from repro_torch.fl.client import init_client_params
    from repro_torch.fl.transfer import apply_transfer
    p = init_client_params(4, torch.Generator().manual_seed(0),
                           shared_init=False, device=cuda)
    alpha = np.zeros((4, 4))
    alpha[[0, 1], 2] = [0.25, 0.75]
    alpha[0, 3] = 1.0
    psi = np.array([0.0, 0.0, 1.0, 1.0])
    before = ac.alpha_combine.launches
    out = apply_transfer(p, alpha, psi)
    assert ac.alpha_combine.launches == before + 1
    for k, v in p.items():
        torch.testing.assert_close(out[k][2], 0.25 * v[0] + 0.75 * v[1],
                                   rtol=1e-5, atol=1e-6)
        assert torch.equal(out[k][0], v[0])


# the simulator's transfer: a pool of 8 (the default run; one mma.sync
# kernel a round) and of 20 (8 devices + 12 spares; split + wgmma, two)
@pytest.mark.cuda
@pytest.mark.parametrize("spares", [0, 12])
def test_sim_transfer_goes_through_the_kernel(cuda, spares):
    from repro_torch.nn.param import flatten_to_vector
    from repro_torch.sim import SimConfig, SimulationEngine
    eng = SimulationEngine(SimConfig(
        scenario="static", devices=8, spares=spares, rounds=1,
        samples_per_device=40, train_iters=30, div_tau=1, div_T=3,
        solver_max_outer=2, solver_inner_steps=100), device=cuda)
    pool = 8 + spares
    per_round = ac._plan(pool, pool)[0]
    assert per_round == (1 if pool <= 16 else 2)
    before = ac.alpha_combine.launches
    eng.run()
    assert ac.alpha_combine.launches == before + per_round
    st = eng.state
    flat = flatten_to_vector(st.params, lead=1).contiguous()
    # the round's own alpha, and a dense one on the same parameters
    for alpha in (st.alpha, _ac_inputs(pool, pool, 1)[1]):
        a = torch.as_tensor(alpha, dtype=torch.float32, device=cuda)
        torch.testing.assert_close(ac.alpha_combine(flat, a),
                                   ac.alpha_combine_plain(flat, a),
                                   rtol=1e-5, atol=1e-5)
    mixed = eng.pool.transfer(st.params, st.alpha, st.psi)
    assert ac.alpha_combine.launches == before + 4 * per_round
    tg = st.psi == 1.0
    for k, v in mixed.items():
        assert torch.equal(v[~torch.as_tensor(tg)], st.params[k][
            ~torch.as_tensor(tg)])                 # sources keep their own


# one small sync run on the card against the port on the CPU, on the
# port's own seeds: every decision equal (chip_smoke.py's [small] sim)
@pytest.mark.cuda
def test_sim_run_on_card_matches_cpu(cuda):
    from repro_torch.sim import SimConfig, SimulationEngine
    cfg = dict(scenario="channel-drift", devices=5, rounds=3,
               samples_per_device=40, train_iters=30, div_tau=1, div_T=3,
               solver_max_outer=4, solver_inner_steps=300,
               solver_inner_steps_warm=150)
    gpu, cpu = (SimulationEngine(SimConfig(**cfg), device=d).run()
                for d in (cuda, "cpu"))
    assert any(r["n_targets"] for r in cpu)
    for a, b in zip(gpu, cpu):
        for k in ("n_active", "n_sources", "n_targets", "transmissions",
                  "events", "resolved", "warm", "resolve_reason"):
            assert a[k] == b[k], (a["round"], k)
        np.testing.assert_allclose(a["energy"], b["energy"], rtol=1e-3,
                                   atol=1e-6)


# tests/test_kernels.py's flash grid: (b, sq, sk, h, kv, d, causal, window),
# with a GQA case, a fully masked start (sq > sk), fewer queries than a
# tile behind a longer history, and the serve path's long-prompt window;
# then the edges of the bf16 tensor-core kernel's 64 x 64 tiles: D = 16
# (one k-step) and 128, fewer queries than a tile, sq > sk with fully
# masked rows, window edges inside a key tile (24, 40, 100) and on one
# (64: the last row of a query tile starts its window on its own
# diagonal tile; 65: the first row starts on the tile before), and GQA
# ratios 1, 4 and 8
FLASH_GRID = [
    (2, 64, 64, 2, 2, 32, True, None),
    (1, 100, 100, 3, 3, 64, True, None),
    (2, 64, 64, 2, 2, 32, True, 24),
    (1, 32, 160, 2, 2, 16, True, None),
    (1, 96, 96, 1, 1, 128, False, None),
    (2, 130, 130, 8, 2, 64, True, 40),
    (1, 48, 32, 2, 2, 16, True, None),
    (2, 5, 77, 4, 2, 32, True, 40),
    (1, 9216, 9216, 4, 1, 64, True, 8192),
    (2, 200, 200, 8, 1, 16, True, None),
    (1, 17, 17, 4, 4, 128, True, None),
    (1, 300, 190, 4, 1, 64, True, None),
    (1, 256, 256, 4, 1, 64, True, 64),
    (1, 256, 256, 8, 1, 128, True, 65),
    (2, 320, 320, 4, 4, 32, True, 100),
    (1, 77, 200, 8, 2, 128, False, None),
]


@pytest.mark.cuda
# bf16: kernel and plain version sum in fp32 and round once, so they
# differ by at most one bf16 ulp of the value (<= 2^-7 of it)
@pytest.mark.parametrize("dtype,tol", [(torch.float32,
                                        dict(atol=3e-5, rtol=1e-4)),
                                       (torch.bfloat16,
                                        dict(atol=1e-5, rtol=2.0 ** -7))])
@pytest.mark.parametrize("b,sq,sk,h,kv,d,causal,window", FLASH_GRID)
def test_flash_attention_kernel_on_card(cuda, b, sq, sk, h, kv, d, causal,
                                        window, dtype, tol):
    from repro_torch.kernels.flash_attention import ops as fa
    q = torch.as_tensor(RNG.normal(size=(b, sq, h, d)), dtype=dtype,
                        device=cuda)
    k, v = (torch.as_tensor(RNG.normal(size=(b, sk, kv, d)), dtype=dtype,
                            device=cuda) for _ in range(2))
    before = fa.flash_attention.launches
    out = fa.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1
    assert out.dtype == dtype and out.shape == q.shape
    plain = fa.flash_attention_plain(q, k, v, causal=causal, window=window)
    torch.testing.assert_close(out.float(), plain.float(), **tol)
    assert bool(torch.isfinite(out).all())
    if causal and sq > sk:           # queries before every key give 0
        assert not bool(out[:, :sq - sk].any())
    with pytest.raises(ValueError):
        fa.flash_attention(q, k.cpu(), v)              # no fallback
    with pytest.raises(ValueError):
        fa.flash_attention(q.half(), k.half(), v.half())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32,
                                        dict(atol=3e-5, rtol=1e-4)),
                                       (torch.bfloat16,
                                        dict(atol=1e-5, rtol=2.0 ** -7))])
@pytest.mark.parametrize("window", [None, 40])
def test_flash_attention_kernel_on_fused_qkv_views(cuda, dtype, tol,
                                                   window):
    """q, k, v as slices of one (B, S, H + 2 KV, D) projection: aligned,
    not contiguous (S stride (H + 2 KV) D), read in place."""
    from repro_torch.kernels.flash_attention import ops as fa
    b, s, h, kv, d = 2, 150, 8, 2, 64
    qkv = torch.as_tensor(RNG.normal(size=(b, s, h + 2 * kv, d)),
                          dtype=dtype, device=cuda)
    q, k, v = qkv[:, :, :h], qkv[:, :, h:h + kv], qkv[:, :, h + kv:]
    assert not q.is_contiguous() and not k.is_contiguous()
    out = fa.flash_attention(q, k, v, window=window)
    torch.cuda.synchronize()
    plain = fa.flash_attention_plain(q.contiguous(), k.contiguous(),
                                     v.contiguous(), window=window)
    torch.testing.assert_close(out.float(), plain.float(), **tol)


@pytest.mark.cuda
def test_flash_attention_rejects_misaligned_bf16(cuda):
    """cp.async stages 16-byte rows: a bf16 stride that is not a multiple
    of 8 elements, or a pointer off 16 bytes, raises; nothing falls
    back.  fp32 (the SIMT kernel) takes both."""
    from repro_torch.kernels.flash_attention import ops as fa
    b, s, h, d = 1, 64, 2, 32
    wide = torch.as_tensor(RNG.normal(size=(b, s, h, d + 4)),
                           dtype=torch.bfloat16, device=cuda)
    q = wide[..., :d]                                   # H stride d + 4
    k = v = torch.as_tensor(RNG.normal(size=(b, s, h, d)),
                            dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="multiples of 8"):
        fa.flash_attention(q, k, v)
    flat = torch.zeros(b * s * h * d + 1, dtype=torch.bfloat16,
                       device=cuda)
    shifted = flat[1:].view(b, s, h, d)                 # 2 bytes off
    with pytest.raises(ValueError, match="aligned"):
        fa.flash_attention(q.contiguous(), shifted, v)
    before = fa.flash_attention.launches
    out = fa.flash_attention(q.float(), k.float(), v.float())
    assert fa.flash_attention.launches == before + 1
    torch.testing.assert_close(
        out, fa.flash_attention_plain(q.float(), k.float(), v.float()),
        atol=3e-5, rtol=1e-4)


@pytest.mark.cuda
def test_prefill_goes_through_the_flash_kernel(cuda):
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.models.api import build_model
    cfg = dataclasses.replace(
        get_config("llama3.2-1b").reduced(num_layers=2, d_model=128),
        dtype="float32", attention_impl="kernel")
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device=cuda)
    toks = torch.as_tensor(RNG.integers(0, cfg.vocab_size, (2, 80)),
                           device=cuda)
    before = fa.flash_attention.launches
    out = model.prefill(params, {"tokens": toks})
    assert fa.flash_attention.launches == before + cfg.num_layers
    ref = build_model(dataclasses.replace(cfg, attention_impl="dot")) \
        .prefill(params, {"tokens": toks})
    torch.testing.assert_close(out, ref, atol=1e-4, rtol=1e-4)


# ssm_scan: (b, l, h, dk, dv, chunk, variant), tests/test_kernels.py's
# grid, ragged tails (50, 300), a ragged Dv (24), rwkv6-1.6b's own head
# and chunk, and at batch 1 a long sequence (32 chunks of 128)
SSM_GRID = [
    (2, 64, 2, 16, 16, 16, "mamba"),
    (1, 96, 3, 32, 32, 32, "rwkv"),
    (2, 50, 2, 16, 24, 16, "mamba"),
    (1, 128, 1, 64, 64, 32, "rwkv"),
    (1, 300, 4, 64, 64, 128, "rwkv"),
    (2, 300, 3, 64, 64, 128, "mamba"),
    (4, 300, 32, 64, 64, 128, "rwkv"),
    (8, 80, 16, 32, 24, 32, "mamba"),
    (1, 4096, 32, 64, 64, 128, "rwkv"),
]
# the kernels one ssm_scan call launches: every chunk's state
# contribution, the scan of the chunks' starting states, every chunk's
# output
SSM_KERNELS = 3


def _ssm_case(cuda, b, l, h, dk, dv, dtype, log_w):
    """q, k, v of ``dtype``, log_w (fp32, as the model passes it), bonus
    and a nonzero initial state on the card."""
    q, k = (torch.as_tensor(RNG.normal(size=(b, l, h, dk)), dtype=dtype,
                            device=cuda) for _ in range(2))
    v = torch.as_tensor(RNG.normal(size=(b, l, h, dv)), dtype=dtype,
                        device=cuda)
    lw = torch.as_tensor(log_w(size=(b, l, h, dk)), dtype=torch.float32,
                         device=cuda)
    bonus = torch.as_tensor(RNG.normal(size=(h, dk)), dtype=torch.float32,
                            device=cuda)
    s0 = torch.as_tensor(RNG.normal(size=(b, h, dk, dv)),
                         dtype=torch.float32, device=cuda)
    return q, k, v, lw, bonus, s0


def _ssm_check(ss, x, chunk, variant, tol):
    """The kernels against the plain version, which sums its products in
    float64 from the same fp32 factors (``gla_chunked_float64_sums`` is
    the same function under the name the checks use)."""
    q, k, v, lw, bonus, s0 = x
    before = ss.gla_chunked.launches
    y, s = ss.gla_chunked(q, k, v, lw, chunk=chunk, variant=variant,
                          bonus=bonus, initial_state=s0)
    torch.cuda.synchronize()
    assert ss.gla_chunked.launches == before + SSM_KERNELS
    assert y.dtype == v.dtype and y.shape == v.shape
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(s).all())
    for ref in (ss.gla_chunked_plain, ss.gla_chunked_float64_sums):
        py, ps = ref(q, k, v, lw, chunk=chunk, variant=variant, bonus=bonus,
                     initial_state=s0)
        torch.testing.assert_close(y.float(), py.float(), **tol)
        torch.testing.assert_close(s, ps, atol=1e-5, rtol=1e-4)


@pytest.mark.cuda
# y in bf16: kernel and plain version sum in fp32 and round once, so they
# differ by at most one bf16 ulp of the value; fp32 within summation order
@pytest.mark.parametrize("dtype,tol", [(torch.float32,
                                        dict(atol=1e-5, rtol=1e-4)),
                                       (torch.bfloat16,
                                        dict(atol=1e-5, rtol=2.0 ** -7))])
@pytest.mark.parametrize("b,l,h,dk,dv,chunk,variant", SSM_GRID)
def test_ssm_scan_kernel_on_card(cuda, b, l, h, dk, dv, chunk, variant,
                                 dtype, tol):
    from repro_torch.kernels.ssm_scan import ops as ss
    x = _ssm_case(cuda, b, l, h, dk, dv, dtype,
                  lambda size: -np.abs(RNG.normal(size=size)))
    _ssm_check(ss, x, chunk, variant, tol)
    q, k, v, lw = x[:4]
    with pytest.raises(ValueError):
        ss.gla_chunked(q, k.cpu(), v, lw, chunk=chunk)     # no fallback
    with pytest.raises(ValueError):
        ss.gla_chunked(q, k, v, lw, chunk=24)              # not 16 | chunk


@pytest.mark.cuda
def test_prefill_goes_through_the_ssm_scan_kernel(cuda):
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.kernels.ssm_scan import ops as ss
    from repro_torch.models.api import build_model
    cfg = dataclasses.replace(
        get_config("rwkv6-1.6b").reduced(num_layers=2, d_model=128),
        dtype="float32")
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device=cuda)
    toks = torch.as_tensor(RNG.integers(0, cfg.vocab_size, (2, 80)),
                           device=cuda)
    before = ss.gla_chunked.launches
    out = model.prefill(params, {"tokens": toks})
    assert ss.gla_chunked.launches == before + SSM_KERNELS * cfg.num_layers
    # a CPU generator draws the same weights for either device
    cpu = model.prefill(model.init(torch.Generator().manual_seed(0),
                                   device="cpu"), {"tokens": toks.cpu()})
    torch.testing.assert_close(out.cpu(), cpu, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["rwkv", "mamba"])
@pytest.mark.parametrize("dtype,tol", [(torch.float32,
                                        dict(atol=1e-5, rtol=1e-4)),
                                       (torch.bfloat16,
                                        dict(atol=1e-5, rtol=2.0 ** -7))])
def test_ssm_scan_strong_decay_on_card(cuda, variant, dtype, tol):
    # log_w = -8 +- 0.5: a 16-row block decays by ~128, past the factored
    # diagonal's span, so every diagonal block takes the per-pair branch
    from repro_torch.kernels.ssm_scan import ops as ss
    x = _ssm_case(cuda, 2, 300, 4, 64, 64, dtype,
                  lambda size: -8.0 + 0.5 * RNG.normal(size=size))
    _ssm_check(ss, x, 128, variant, tol)


def _wrapper_calls(cuda):
    """Each kernel wrapper on small CUDA inputs; ``g`` marks one floating
    input as requiring grad."""
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.ssm_scan import ops as ss
    r = lambda *shape: torch.as_tensor(  # noqa: E731
        RNG.normal(size=shape), dtype=torch.float32, device=cuda)
    preds = torch.as_tensor(_preds(6, 300), device=cuda)
    qkv = [r(1, 64, 4, 64).to(torch.bfloat16) for _ in range(3)]
    return {
        "alpha_combine": lambda g: ac.alpha_combine(
            r(5, 1000).requires_grad_(g), r(5, 3).abs()),
        "disagreement_counts": lambda g: dg.disagreement_counts(
            preds, torch.ones(300, device=cuda).requires_grad_(g)),
        "disagreement": lambda g: dg.disagreement(
            preds, torch.ones(300, device=cuda).requires_grad_(g)),
        "flash_attention": lambda g: fa.flash_attention(
            qkv[0].clone().requires_grad_(g), qkv[1], qkv[2]),
        "gla_chunked": lambda g: ss.gla_chunked(
            qkv[0], qkv[1], qkv[2].clone().requires_grad_(g),
            -r(1, 64, 4, 64).abs(), chunk=32, variant="rwkv",
            bonus=r(4, 64)),
    }


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["alpha_combine", "disagreement_counts",
                                  "disagreement", "flash_attention",
                                  "gla_chunked"])
def test_wrapper_refuses_grad_on_card(cuda, name):
    # no kernel has a backward pass: an output autograd would need raises
    # instead of silently dropping the gradient; no grad needed computes
    call = _wrapper_calls(cuda)[name]
    with pytest.raises(RuntimeError, match="requires grad"):
        call(True)
    with torch.no_grad():
        call(True)
    call(False)
    torch.cuda.synchronize()


# ------------------------------------------------- more than one card
@pytest.fixture
def cards():
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two or more CUDA devices (the sharded pool's "
                    "k-card layout)")
    return torch.cuda.device_count()


@pytest.mark.cuda
def test_kernels_launch_on_a_second_card(cards):
    """Each wrapper launches on its inputs' card while another card is
    current (the sharded pool's shards on cuda:s), both of
    alpha_combine's routes and the dynamic shared memory each kernel
    asks for on a card it has not yet run on."""
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.ssm_scan import ops as ss
    for first in (0, 1):                 # either card first, then the other
        for index in (first, 1 - first):
            dev = torch.device("cuda", index)
            with torch.cuda.device(1 - index):
                for s, t in ((10, 10), (64, 32)):   # mma.sync, then wgmma
                    theta, alpha = _ac_inputs(s, t, 4801)
                    th = torch.as_tensor(theta, device=dev)
                    al = torch.as_tensor(alpha, device=dev)
                    out = ac.alpha_combine(th, al)
                    assert out.device == dev
                    torch.testing.assert_close(
                        out, ac.alpha_combine_plain(th, al), rtol=1e-5,
                        atol=1e-5)
                preds = torch.as_tensor(_preds(40, 777), device=dev)
                valid = torch.as_tensor(RNG.random(777) < 0.7,
                                        device=dev).float()
                torch.testing.assert_close(
                    dg.disagreement_counts(preds, valid),
                    dg.disagreement_counts_plain(preds, valid))
                q, k, v = (torch.as_tensor(RNG.normal(size=(1, 130, 4, 64)),
                                           dtype=torch.bfloat16, device=dev)
                           for _ in range(3))
                torch.testing.assert_close(
                    fa.flash_attention(q, k, v, causal=True).float(),
                    fa.flash_attention_plain(q, k, v, causal=True).float(),
                    atol=1e-5, rtol=2.0 ** -7)
                x = _ssm_case(dev, 1, 96, 3, 32, 32, torch.float32,
                              lambda size: -np.abs(RNG.normal(size=size)))
                _ssm_check(ss, x, 32, "rwkv", dict(atol=3e-5, rtol=1e-4))
            torch.cuda.synchronize(dev)


@pytest.mark.cuda
def test_sharded_pool_on_separate_cards(cards):
    """``--mesh k`` on a k-card host: shard s on cuda:s, one slab a shard
    a round on its own card, the run's decisions those of the same mesh
    emulated on cuda:0; a mesh built for ``cuda:1`` starts there; a
    sharded 'faulty' run recovers lost shards on separate cards."""
    from repro_torch.sim import SimConfig, SimulationEngine
    from repro_torch.sim.shard.mesh import make_pool_mesh
    k = min(cards, 4)
    assert make_pool_mesh(k, "cuda:0").devices == \
        tuple(torch.device("cuda", i) for i in range(k))
    assert make_pool_mesh(cards - 1, "cuda:1").devices == \
        tuple(torch.device("cuda", i) for i in range(1, cards))
    with pytest.raises(RuntimeError, match="emulate=True"):
        make_pool_mesh(cards, "cuda:1")
    base = dict(devices=8, rounds=3, samples_per_device=40, train_iters=30,
                div_tau=1, div_T=3, solver_max_outer=4,
                solver_inner_steps=300, solver_inner_steps_warm=150)
    keys = ("n_active", "n_sources", "n_targets", "transmissions", "events",
            "resolved", "warm", "resolve_reason", "n_faults", "n_recovered")

    def same(a_rows, b_rows):
        for a, b in zip(a_rows, b_rows, strict=True):
            for key in keys:
                assert a[key] == b[key], (a["round"], key)
            np.testing.assert_allclose(a["energy"], b["energy"], rtol=1e-3,
                                       atol=1e-6)

    for cfg, mesh in ((dict(base, scenario="channel-drift"), k),
                      (dict(base, scenario="faulty", devices=6, rounds=4,
                            fault_shard_p=0.7, fault_crash_p=0.0), 2)):
        real = SimulationEngine(SimConfig(**cfg, mesh=mesh), device="cuda:0")
        assert real.pool.mesh.devices == \
            tuple(torch.device("cuda", i) for i in range(mesh))
        before = ac.alpha_combine.launches
        rows = real.run()
        pad = -(-cfg["devices"] // mesh) * mesh
        assert ac.alpha_combine.launches - before == \
            cfg["rounds"] * mesh * ac._plan(pad, pad // mesh)[0]
        assert all(v.device == torch.device("cuda", 0)
                   for v in real.state.params.values())
        emulated = SimulationEngine(SimConfig(**cfg, mesh=mesh),
                                    device="cuda:0", emulate=True).run()
        assert any(r["n_targets"] for r in rows)
        same(rows, emulated)
        if cfg["scenario"] == "faulty":
            assert sum(r["n_recovered"] for r in rows) > 0
    one = SimulationEngine(SimConfig(**base, scenario="channel-drift",
                                     mesh=1), device="cuda:1")
    assert one.pool.mesh.devices == (torch.device("cuda", 1),)
    same(one.run(), SimulationEngine(SimConfig(
        **base, scenario="channel-drift", mesh=1), device="cuda:0").run())
    assert all(v.device == torch.device("cuda", 1)
               for v in one.state.params.values())


# The head dims added for zamba2-7b's shared attention (112: staged as
# 128, TMA zero-filling the rest) and gemma-7b (256), on FLASH_GRID's
# edges: ragged query tiles, a window edge on the tile before the
# diagonal's, sq > sk with fully masked rows, bidirectional with a
# history, GQA.  These tests sit last in the file, so that the inputs
# the tests above draw from RNG stay as they were.
FLASH_HEAD_DIM_GRID = [
    (2, 130, 130, 4, 4, 112, True, None),
    (1, 200, 200, 8, 2, 112, True, 65),
    (1, 48, 32, 2, 2, 112, True, None),
    (1, 77, 150, 4, 1, 112, False, None),
    (2, 130, 130, 4, 4, 256, True, None),
    (1, 200, 200, 8, 2, 256, True, 65),
    (1, 48, 32, 2, 2, 256, True, None),
    (1, 77, 150, 4, 1, 256, False, None),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32,
                                        dict(atol=3e-5, rtol=1e-4)),
                                       (torch.bfloat16,
                                        dict(atol=1e-5, rtol=2.0 ** -7))])
@pytest.mark.parametrize("b,sq,sk,h,kv,d,causal,window",
                         FLASH_HEAD_DIM_GRID)
def test_flash_attention_kernel_at_model_head_dims_on_card(
        cuda, b, sq, sk, h, kv, d, causal, window, dtype, tol):
    test_flash_attention_kernel_on_card(cuda, b, sq, sk, h, kv, d, causal,
                                        window, dtype, tol)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["zamba2-7b", "gemma-7b"])
def test_prefill_at_the_models_head_dim_goes_through_the_kernels(cuda,
                                                                 arch):
    """zamba2-7b (D = 112: one flash call a group, three ssm_scan kernels
    a mamba layer) and gemma-7b (D = 256: one flash call a layer) at
    3 layers of d_model 128 with their own head dim, fp32, 80 tokens
    past the reduced window of 64: the card against the CPU port."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.ssm_scan import ops as ss
    from repro_torch.models.api import build_model
    full = get_config(arch)
    cfg = dataclasses.replace(full.reduced(num_layers=3, d_model=128),
                              head_dim=full.head_dim, dtype="float32",
                              attention_impl="kernel")
    model = build_model(cfg)
    hybrid = cfg.arch_type == "hybrid"
    params = model.init(torch.Generator().manual_seed(0), device=cuda)
    toks = torch.as_tensor(RNG.integers(0, cfg.vocab_size, (2, 80)),
                           device=cuda)
    before = fa.flash_attention.launches, ss.gla_chunked.launches
    out = model.prefill(params, {"tokens": toks})
    assert fa.flash_attention.launches == before[0] + (
        len(model.group_sizes) if hybrid else cfg.num_layers)
    assert ss.gla_chunked.launches == before[1] + (
        SSM_KERNELS * cfg.num_layers if hybrid else 0)
    cpu = model.prefill(model.init(torch.Generator().manual_seed(0),
                                   device="cpu"), {"tokens": toks.cpu()})
    torch.testing.assert_close(out.cpu(), cpu, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
def test_training_loss_through_the_flash_kernel_refuses_grad(cuda):
    """JAX trains through no Pallas kernel and the port adds no backward
    kernel: a loss through ``attention_impl="kernel"`` on the card raises
    under grad; under ``no_grad`` it launches the kernel once a layer and
    agrees with the dot route."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.launch.steps import value_and_grad
    from repro_torch.models.api import build_model
    cfg = get_config("repro-100m").reduced(num_layers=2, d_model=128)
    params = build_model(cfg).init(torch.Generator().manual_seed(0), cuda)
    toks = torch.as_tensor(RNG.integers(0, cfg.vocab_size, (2, 64)),
                           device=cuda)
    batch = {"tokens": toks, "labels": toks.roll(-1, 1)}
    kernel = build_model(dataclasses.replace(cfg, attention_impl="kernel"))
    dot = build_model(dataclasses.replace(cfg, attention_impl="dot"))
    with pytest.raises(RuntimeError, match="flash_attention"):
        value_and_grad(lambda p: kernel.loss(p, batch), params)
    with torch.no_grad():
        before = fa.flash_attention.launches
        lk, _ = kernel.loss(params, batch)
        assert fa.flash_attention.launches == before + cfg.num_layers
        ld, _ = dot.loss(params, batch)
    assert abs(float(lk) - float(ld)) <= 2e-2


# three fp32 train steps of reduced() on the card and on the CPU port:
# the losses within 1e-5 relative; the first step's gradients within 1e-3
# of each leaf's norm (rwkv6 and zamba2-7b keep JAX's bf16 rounding
# points in fp32: weights cast to bf16 at use, rwkv6's receptance gate);
# each leaf's change within DELTA_TOL of its norm over the elements whose
# changes agree within lr, at most 1e-4 of a leaf apart by more (Adam's
# first steps are +-lr by the gradient's sign, which summation order can
# flip where the gradient is near zero; rwkv6 and zamba2-7b carry their
# bf16 rounding points into their changes, 1.1e-3 and 1.3e-3 measured);
# chip_smoke.py's phase 7b bars
DELTA_TOL = {"repro-100m": 1e-3, "rwkv6-1.6b": 5e-3, "zamba2-7b": 5e-3}


@pytest.mark.cuda
@pytest.mark.parametrize("arch", sorted(DELTA_TOL))
def test_train_step_on_card_matches_cpu(cuda, arch):
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import make_train_step, value_and_grad
    from repro_torch.models.api import build_model
    from repro_torch.nn.param import tree_leaves, tree_map
    from repro_torch.optim import adamw
    lr = 3e-4
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
    model = build_model(cfg)
    init = model.init(torch.Generator().manual_seed(0), "cpu")
    step = make_train_step(cfg, lr=lr, opt_state_dtype=torch.float32)
    toks = [RNG.integers(0, cfg.vocab_size, (2, 2, 128)) for _ in range(3)]
    out = {}
    for dev in (cuda, torch.device("cpu")):
        p = tree_map(lambda x: x.to(dev), init)
        st = adamw(lr, weight_decay=0.1).init(p)
        losses = []
        for i, t in enumerate(toks):
            b = {"tokens": torch.as_tensor(t[0], device=dev),
                 "labels": torch.as_tensor(t[1], device=dev)}
            if i == 0:
                _, g = value_and_grad(lambda q: model.loss(q, b), p)
                grads = [x.double().cpu() for x in tree_leaves(g)]
            p, st, loss, _ = step(p, st, b)
            losses.append(float(loss))
        out[dev.type] = (losses, grads,
                         [x.double().cpu() for x in tree_leaves(p)])
    np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], rtol=1e-5)
    for a, b in zip(out["cuda"][1], out["cpu"][1]):
        assert float((a - b).norm()) <= 1e-3 * float(b.norm())
    for a, b, c in zip(out["cuda"][2], out["cpu"][2], tree_leaves(init)):
        da, db = a - c.double(), b - c.double()
        keep = (da - db).abs() <= lr
        assert float((~keep).double().mean()) <= 1e-4
        assert float((da - db)[keep].norm()) \
            <= DELTA_TOL[arch] * float(db[keep].norm()) + 1e-12


# The GQA ratios the MoE and vlm decoders give the kernel at D = 128:
# grok-1's 48/8 (6), llama4-scout's 40/8 (5) and internvl2-2b's 16/8 (2),
# causal and with a window edge inside a key tile.  Last in the file, as
# above.
FLASH_GQA_GRID = [(2, 512, 512, h, 8, 128, True, w)
                  for h in (48, 40, 16) for w in (None, 200)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,sq,sk,h,kv,d,causal,window", FLASH_GQA_GRID)
def test_flash_attention_kernel_at_moe_and_vlm_gqa_on_card(
        cuda, b, sq, sk, h, kv, d, causal, window):
    test_flash_attention_kernel_on_card(cuda, b, sq, sk, h, kv, d, causal,
                                        window, torch.bfloat16,
                                        dict(atol=1e-5, rtol=2.0 ** -7))


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["grok-1-314b", "llama4-scout-17b-a16e",
                                  "internvl2-2b"])
def test_moe_and_vlm_prefill_go_through_the_flash_kernel(cuda, arch):
    """The MoE decoders and the stub-frontend decoder at 2 layers of
    d_model 128, fp32, through the kernel (one launch a layer): the card
    against the CPU port, the MoE routing pinned to the CPU's (a
    near-tie may route differently on another summation order)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.models.api import build_model
    cfg = dataclasses.replace(
        get_config(arch).reduced(num_layers=2, d_model=128),
        dtype="float32", attention_impl="kernel")
    model = build_model(cfg)
    cpu_params = model.init(torch.Generator().manual_seed(0), device="cpu")
    params = model.init(torch.Generator().manual_seed(0), device=cuda)
    batch = {"tokens": torch.as_tensor(
        RNG.integers(0, cfg.vocab_size, (2, 80)))}
    if cfg.frontend.kind != "none":
        batch["embeds"] = torch.as_tensor(RNG.normal(
            size=(2, cfg.frontend.num_embeds, cfg.d_model)),
            dtype=torch.float32)
    if cfg.moe is not None:
        batch["expert_ids"] = model.routing(cpu_params, batch)
    cpu = model.prefill(cpu_params, batch)
    before = fa.flash_attention.launches
    out = model.prefill(params, {k: v.to(cuda) for k, v in batch.items()})
    assert fa.flash_attention.launches == before + cfg.num_layers
    torch.testing.assert_close(out.cpu(), cpu, atol=1e-4, rtol=1e-4)


# the four kernels as opaque ops (``torch.ops.repro_torch.*``): on the
# card each launches its kernel and matches its plain version at the bars
# above; its fake implementation, which a trace on ``meta`` runs, gives
# the CUDA output's shape, dtype and strides
def _op_case(name, dev):
    """(call, plain version, inputs on ``dev``, each output's bar (None:
    exact), the counter the call bumps)."""
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.ssm_scan import ops as ss
    g = np.random.default_rng(3)

    def t(size, dtype=torch.float32):
        return torch.as_tensor(g.normal(size=size), dtype=dtype,
                               device=dev)
    bf16 = dict(atol=1e-5, rtol=2.0 ** -7)
    if name == "flash_attention":
        x = [t((2, 300, 8, 64), torch.bfloat16),
             t((2, 300, 2, 64), torch.bfloat16),
             t((2, 300, 2, 64), torch.bfloat16)]
        return (lambda q, k, v: fa.flash_attention(q, k, v, window=100),
                lambda q, k, v: fa.flash_attention_plain(q, k, v,
                                                         window=100),
                x, [bf16], fa.flash_attention)
    if name == "gla_chunked":
        x = [t((2, 300, 4, 64), torch.bfloat16) for _ in range(3)] \
            + [-t((2, 300, 4, 64)).abs(), t((4, 64)), t((2, 4, 64, 64))]
        return (lambda *a: ss.gla_chunked(*a[:4], chunk=128, variant="rwkv",
                                          bonus=a[4], initial_state=a[5]),
                lambda *a: ss.gla_chunked_plain(*a[:4], chunk=128,
                                                variant="rwkv", bonus=a[4],
                                                initial_state=a[5]),
                x, [bf16, dict(atol=1e-5, rtol=1e-4)], ss.gla_chunked)
    if name == "alpha_combine":
        theta, alpha = _ac_inputs(70, 40, 3001)
        return (ac.alpha_combine, ac.alpha_combine_plain,
                [torch.as_tensor(theta, device=dev),
                 torch.as_tensor(alpha, device=dev)],
                [dict(rtol=1e-5, atol=1e-5)], ac.alpha_combine)
    preds = torch.as_tensor(_preds(40, 130), device=dev)
    valid = torch.ones(130, device=dev)
    if name == "disagreement_counts":
        return (dg.disagreement_counts, dg.disagreement_counts_plain,
                [preds, valid], [None], dg.disagreement_counts)
    return (dg.disagreement,
            lambda p, v: dg.disagreement_counts_plain(p, v) / v.sum(),
            [preds, valid], [None], dg.disagreement_counts)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["flash_attention", "gla_chunked",
                                  "alpha_combine", "disagreement_counts",
                                  "disagreement"])
def test_kernel_op_fake_matches_the_cuda_output(cuda, name):
    call, plain, x, tols, counter = _op_case(name, cuda)
    before = counter.launches
    out = call(*x)
    torch.cuda.synchronize()
    assert counter.launches > before           # the kernel ran
    outs = out if isinstance(out, tuple) else (out,)
    refs = plain(*x)
    refs = refs if isinstance(refs, tuple) else (refs,)
    for got, want, tol in zip(outs, refs, tols, strict=True):
        if tol is None:
            assert torch.equal(got, want)
        else:
            torch.testing.assert_close(got.float(), want.float(), **tol)
    fake = call(*(a.to("meta") for a in x))
    fakes = fake if isinstance(fake, tuple) else (fake,)
    assert len(fakes) == len(outs)
    for f, o in zip(fakes, outs):
        assert f.device.type == "meta"
        assert (f.shape, f.dtype, f.stride()) == (o.shape, o.dtype,
                                                 o.stride())


def _flash_on_mesh(model_axis):
    """A rank of a world of two ``nccl`` ranks: ``flash_attention`` on
    bf16 DTensor q, k, v laid out on the (2 / model_axis, model_axis)
    mesh as the rules lay them out (batch on 'data'; heads and kv heads
    on 'model' where they divide it), for GQA 8/2, MQA 8/1 and GQA 6/3
    (3 kv heads do not divide 2: the heads are gathered).  Rank 0
    returns each layout's max abs error against the plain version on
    the full tensors, the output's placements and its own launches."""
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.launch import mesh as mesh_lib
    dm = mesh_lib.make_device_mesh(model_axis, device_type="cuda")
    rng = np.random.default_rng(0)
    out = {}
    for h, kv in ((8, 2), (8, 1), (6, 3)):
        full = [torch.as_tensor(rng.normal(size=(4, 256, n, 64)),
                                dtype=torch.bfloat16, device="cuda")
                for n in (h, kv, kv)]
        placed = [distribute_tensor(t, dm, [
            Shard(0) if name == "data" else
            (Shard(2) if t.shape[2] % dm.shape[i] == 0 and t.shape[2] > 1
             else Replicate())
            for i, name in enumerate(dm.mesh_dim_names)],
            src_data_rank=None) for t in full]
        fa.flash_attention.launches = 0
        got = fa.flash_attention(*placed, causal=True)
        launches = fa.flash_attention.launches
        ref = fa.flash_attention_plain(*full, causal=True)
        bad = ~torch.isclose(got.full_tensor().float(), ref.float(),
                             atol=1e-5, rtol=2.0 ** -7)
        out[(h, kv)] = dict(beyond=int(bad.sum()), launches=launches,
                            placements=[repr(p) for p in got.placements])
    return out if dist.get_rank() == 0 else None


@pytest.mark.cuda
@pytest.mark.parametrize("model_axis", [2, 1], ids=["1x2", "2x1"])
def test_flash_sharding_rule_on_two_cards(cards, model_axis):
    """The op's DTensor sharding rule on two cards, each rank launching
    the kernel once on its shard: within one bf16 ulp of the plain
    version (the serve bar), heads split only where each local query
    head keeps its kv head (GQA 6/3 on two cards: never; DTensor may
    split the batch over 'model' instead)."""
    from repro_torch.kernels.flash_attention.ops import heads_split_ok
    from repro_torch.launch import mesh as mesh_lib
    got = mesh_lib.launch(_flash_on_mesh, 2, device_type="cuda",
                          args=(model_axis,), timeout=300)[0]
    for (h, kv), r in got.items():
        assert r["beyond"] == 0 and r["launches"] == 1, (h, kv, r)
        if model_axis == 2 and heads_split_ok(h, kv, 2):
            assert r["placements"][1] == "Shard(dim=2)", (h, kv, r)
        elif model_axis == 2:   # gathered heads, or the batch split
            assert r["placements"][1] != "Shard(dim=2)", (h, kv, r)
        else:
            assert r["placements"][0] == "Shard(dim=0)", (h, kv, r)


def _gla_on_mesh(model_axis):
    """A rank of a world of ``nccl`` ranks: ``gla_chunked`` on DTensor
    q, k, v, log_w laid out as the models lay them out (batch on 'data',
    heads on 'model'), bonus on heads and the initial state on both, in
    bf16 and fp32, both variants, at rwkv6-1.6b's head and chunk.  Rank
    0 returns, for each case, its launches, its local heads, the
    output's placements and the elements of y and of the final state
    beyond the serve bars against the plain version on the full
    tensors."""
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.kernels.ssm_scan import ops as ss
    from repro_torch.launch import mesh as mesh_lib
    dm = mesh_lib.make_device_mesh(model_axis, device_type="cuda")
    rng = np.random.default_rng(0)

    def place(t, batch, heads):
        return distribute_tensor(t, dm, [
            Shard(batch) if name == "data" and batch is not None
            else Shard(heads) if name == "model" else Replicate()
            for name in dm.mesh_dim_names], src_data_rank=None)

    out = {}
    for variant in ("rwkv", "mamba"):
        for dtype, tol in ((torch.bfloat16, 2.0 ** -7), (torch.float32,
                                                         1e-4)):
            b, l, h, d = 4, 300, 8, 64
            q, k, v = (torch.as_tensor(rng.normal(size=(b, l, h, d)),
                                       dtype=dtype, device="cuda")
                       for _ in range(3))
            lw = torch.as_tensor(-np.abs(rng.normal(size=(b, l, h, d))),
                                 dtype=torch.float32, device="cuda")
            bonus = torch.as_tensor(rng.normal(size=(h, d)),
                                    dtype=torch.float32, device="cuda")
            s0 = torch.as_tensor(rng.normal(size=(b, h, d, d)),
                                 dtype=torch.float32, device="cuda")
            local = []
            launch = ss._gla_launch
            ss._gla_launch = lambda q_, *a: (local.append(q_.shape[2]),
                                             launch(q_, *a))[1]
            ss.gla_chunked.launches = 0
            try:
                y, s = ss.gla_chunked(
                    *(place(t, 0, 2) for t in (q, k, v, lw)), chunk=128,
                    variant=variant, bonus=place(bonus, None, 0),
                    initial_state=place(s0, 0, 1))
            finally:
                ss._gla_launch = launch
            py, ps = ss.gla_chunked_plain(q, k, v, lw, chunk=128,
                                          variant=variant, bonus=bonus,
                                          initial_state=s0)
            out[(variant, str(dtype))] = dict(
                launches=ss.gla_chunked.launches, local_heads=local,
                placements=[[repr(p) for p in t.placements] for t in (y, s)],
                y_beyond=int((~torch.isclose(y.full_tensor().float(),
                                             py.float(), atol=1e-5,
                                             rtol=tol)).sum()),
                s_beyond=int((~torch.isclose(s.full_tensor(), ps,
                                             atol=1e-5, rtol=1e-4)).sum()))
    return out if dist.get_rank() == 0 else None


def _check_gla_on_mesh(got, model_axis):
    for case, r in got.items():
        assert r["launches"] == SSM_KERNELS, (case, r)
        assert r["local_heads"] == [8 // model_axis], (case, r)
        assert r["placements"] == [["Shard(dim=0)", "Shard(dim=2)"],
                                   ["Shard(dim=0)", "Shard(dim=1)"]], r
        assert r["y_beyond"] == 0 and r["s_beyond"] == 0, (case, r)


@pytest.mark.cuda
def test_gla_sharding_rule_on_a_one_rank_world(cuda):
    """The ``ssm_scan`` op's DTensor sharding rule in a world of one
    ``nccl`` rank: the kernels launch (three a call, never the plain
    version) on the rank's shard and agree with the plain version within
    the serve bars (bf16 y one ulp; fp32 within summation order)."""
    from repro_torch.launch import mesh as mesh_lib
    _check_gla_on_mesh(mesh_lib.launch(_gla_on_mesh, 1, device_type="cuda",
                                       args=(1,), timeout=300)[0], 1)


@pytest.mark.cuda
@pytest.mark.parametrize("model_axis", [2, 1], ids=["1x2", "2x1"])
def test_gla_sharding_rule_on_two_cards(cards, model_axis):
    """The same on two cards: rank 0's kernels run on its rows (2, 1) or
    on 4 of the 8 heads (1, 2)."""
    from repro_torch.launch import mesh as mesh_lib
    _check_gla_on_mesh(mesh_lib.launch(_gla_on_mesh, 2, device_type="cuda",
                                       args=(model_axis,), timeout=300)[0],
                       model_axis)
