"""Zamba2-style hybrid: Mamba2 backbone with *shared* attention blocks; the
port of ``repro.models.zamba.ZambaModel``.

81 mamba layers are run in groups of ``attn_every``; after each group one
of ``num_shared_blocks`` shared transformer blocks (attn+MLP, weights reused
across applications) is applied, alternating — the Zamba2 parameter-sharing
trick (arXiv:2411.15242).  As in JAX, the shared block takes the hidden
state directly: no concatenation with the embedding and no per-use LoRA.

Parameters keep JAX's layer-stacked layout; JAX's ``lax.scan`` over a
group is a Python loop over ``unstack``'s layers.  The cache is JAX's
``{"mamba": (conv (L,B,W-1,C), ssm (L,B,H,N,hd) fp32), "kv": {"k", "v"}
(G,B,kv_len,KV,hd)}`` with one KV ring buffer per group (G applications
of the shared blocks); ``decode_step`` updates it in place and returns it.
The prefill runs the ``ssm_scan`` kernel once a mamba layer (``scan_impl=
"kernel"``; ``"plain"`` runs ``nn.linear_attn.gla_chunked``) and the
attention through ``cfg.attention_impl``.  ``loss`` runs every scan
through ``impl="plain"`` (``nn.linear_attn.gla_chunked``, differentiable)
whatever ``scan_impl`` is, the path JAX's ``loss`` takes through its jnp
scan; its shared attention follows ``cfg.attention_impl``.  With
``cfg.remat`` each mamba layer is recomputed in the backward pass, as
JAX checkpoints its scanned mamba body.

On a mesh (``ctx``, a ``ShardCtx`` over a ``DeviceMesh``, with DTensor
parameters and inputs) it runs as a DTensor program constrained at
JAX's points (``src/repro/models/zamba.py:100, 146, 161, 191``), the
mamba layers' scans on each rank's heads (``nn/mamba.py``), the shared
attention through ``nn/attention`` (the flash op's sharding rule on the
kernel route, the KV ring buffer written rank by rank) and decode's
conv and SSD states written in place, each rank its own shard
(``write_layer``).
"""
from __future__ import annotations

import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.common import (LMBase, chunked_softmax_xent,
                                      maybe_checkpoint, spec_zeros,
                                      stack_specs, take_layer, unstack,
                                      write_layer)
from repro_torch.nn import attention as attn
from repro_torch.nn import mamba
from repro_torch.nn import mlp as mlp_lib
from repro_torch.nn import param as P
from repro_torch.nn.layers import (NO_SHARD, ShardCtx, embed,
                                   embedding_spec, on_mesh_of, rmsnorm,
                                   rmsnorm_spec, unembed)


def _mamba_layer_specs(cfg):
    return {"ln": rmsnorm_spec(cfg.d_model), "mix": mamba.mamba_specs(cfg)}


def _shared_block_specs(cfg):
    hd = cfg.resolved_head_dim()
    return {
        "ln1": rmsnorm_spec(cfg.d_model),
        "attn": attn.attention_specs(cfg.d_model, cfg.num_heads,
                                     cfg.num_kv_heads, hd),
        "ln2": rmsnorm_spec(cfg.d_model),
        "mlp": mlp_lib.mlp_specs(cfg.d_model, cfg.d_ff, cfg.mlp_activation),
    }



class ZambaModel(LMBase):
    def __init__(self, cfg, scan_impl: str = "kernel"):
        super().__init__(cfg)
        if scan_impl not in ("kernel", "plain"):
            raise ValueError(f"ZambaModel: scan_impl {scan_impl!r} is not "
                             f"'kernel' or 'plain'")
        self.scan_impl = scan_impl
        k = cfg.hybrid.attn_every
        n = cfg.num_layers
        self.group_sizes = [k] * (n // k) + ([n % k] if n % k else [])
        self.group_offsets = [sum(self.group_sizes[:i])
                              for i in range(len(self.group_sizes))]

    def param_specs(self):
        cfg = self.cfg
        return {
            "embedding": embedding_spec(cfg.vocab_size, cfg.d_model),
            "layers": stack_specs(_mamba_layer_specs(cfg), cfg.num_layers),
            "shared": stack_specs(_shared_block_specs(cfg),
                                  cfg.hybrid.num_shared_blocks),
            "ln_f": rmsnorm_spec(cfg.d_model),
            "unembed": P.ParamSpec((cfg.vocab_size, cfg.d_model),
                                   ("vocab", "embed"), init="embed",
                                   scale=0.02),
        }

    # --------------------------------------------------------------- shared
    def _shared_attn(self, sp, x, positions, kv_cache=None, pos=None,
                     ctx: ShardCtx = NO_SHARD):
        cfg = self.cfg
        dt = getattr(torch, cfg.dtype)
        hn = rmsnorm(x, sp["ln1"], cfg.norm_eps)
        kw = dict(num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
                  head_dim=cfg.resolved_head_dim(),
                  rope_theta=cfg.rope_theta, window=cfg.sliding_window,
                  ctx=ctx, dtype=dt)
        if kv_cache is None:
            a = attn.attend(sp["attn"], hn, positions, causal=True,
                            impl=cfg.attention_impl, **kw)
        else:
            a, _ = attn.decode_attend(sp["attn"], hn, kv_cache, pos, **kw)
        x = x + a
        y = mlp_lib.mlp(sp["mlp"], rmsnorm(x, sp["ln2"], cfg.norm_eps),
                        cfg.mlp_activation, dt, ctx)
        return x + y

    def _mamba_layer(self, lp, x, impl, ctx: ShardCtx = NO_SHARD):
        cfg = self.cfg
        x = ctx.constrain(x, "batch", None, "embed_act")
        m, _ = mamba.mamba_block(lp["mix"], rmsnorm(x, lp["ln"], cfg.norm_eps),
                                 cfg, ctx=ctx, impl=impl)
        return x + m

    def _backbone(self, params, x, positions, cache=None, pos=None,
                  impl=None, ctx: ShardCtx = NO_SHARD):
        """The groups of mamba layers, each followed by its shared block;
        from the zero state (prefill: the new states are dropped, as JAX's
        ``prefill`` drops them) or one decode step on ``cache``, updated
        in place.  ``impl``: the scans' (default ``self.scan_impl``)."""
        cfg = self.cfg
        impl = impl or self.scan_impl
        nsb = cfg.hybrid.num_shared_blocks
        layers, shared = unstack(params["layers"]), unstack(params["shared"])
        for gi, (off, size) in enumerate(zip(self.group_offsets,
                                             self.group_sizes)):
            for i in range(off, off + size):
                lp = layers[i]
                if cache is None:
                    x = maybe_checkpoint(cfg.remat, self._mamba_layer, lp,
                                         x, impl, ctx)
                    continue
                conv, ssm = cache["mamba"]
                x = ctx.constrain(x, "batch", None, "embed_act")
                m, (nc, ns) = mamba.mamba_decode(
                    lp["mix"], rmsnorm(x, lp["ln"], cfg.norm_eps), cfg,
                    state=(conv[i], ssm[i]), ctx=ctx)
                write_layer(conv, i, nc)
                write_layer(ssm, i, ns)
                x = x + m
            sp = shared[gi % nsb]
            kvc = None if cache is None else take_layer(cache["kv"], gi)
            x = self._shared_attn(sp, x, positions, kv_cache=kvc, pos=pos,
                                  ctx=ctx)
        return x

    def _hidden(self, params, tokens, impl=None, ctx: ShardCtx = NO_SHARD,
                loss: bool = False):
        """The final-normed hidden of ``tokens``; ``loss`` constrains the
        embeddings as JAX's ``loss`` does."""
        cfg = self.cfg
        x = embed(tokens, params["embedding"], getattr(torch, cfg.dtype))
        b, s, _ = x.shape
        positions = on_mesh_of(torch.arange(s, device=x.device)
                               .expand(b, s), x)
        if loss:
            x = ctx.constrain(x, "batch", None, None)
        return rmsnorm(self._backbone(params, x, positions, impl=impl,
                                      ctx=ctx),
                       params["ln_f"], cfg.norm_eps)

    # ------------------------------------------------------------ training
    def loss(self, params, batch, ctx: ShardCtx = NO_SHARD):
        h = self._hidden(params, batch["tokens"], impl="plain", ctx=ctx,
                         loss=True)
        ce = chunked_softmax_xent(h, params["unembed"], batch["labels"],
                                  ctx=ctx)
        return ce, {"ce": ce, "aux": on_mesh_of(torch.zeros(
            (), dtype=torch.float32, device=h.device), h)}

    # ------------------------------------------------------------- serving
    @torch.no_grad()
    def prefill(self, params, batch, ctx: ShardCtx = NO_SHARD):
        h = self._hidden(params, batch["tokens"], ctx=ctx)
        return ctx.constrain(unembed(h[:, -1:], params["unembed"]),
                             "batch", None, "vocab")

    def cache_specs(self, batch: int, max_len: int):
        cfg = self.cfg
        kv_len = min(max_len, cfg.sliding_window or max_len)
        n_groups = len(self.group_sizes)
        mstate = mamba.mamba_state_specs(batch, cfg, cfg.dtype)
        mstate = tuple(stack_specs(s, cfg.num_layers) for s in mstate)
        kv = stack_specs(attn.cache_specs(batch, kv_len, cfg.num_kv_heads,
                                          cfg.resolved_head_dim(), cfg.dtype),
                         n_groups)
        return {"mamba": mstate, "kv": kv}

    def init_cache(self, batch: int, max_len: int,
                   device: DeviceLike = None):
        """Zeros of ``cache_specs`` on ``device`` (default: the GPU)."""
        return spec_zeros(self.cache_specs(batch, max_len),
                          resolve_device(device))

    @torch.no_grad()
    def decode_step(self, params, cache, batch, ctx: ShardCtx = NO_SHARD):
        """One token for every row.  ``cache`` is updated in place and
        returned: each mamba layer's conv and SSD state, and each group's
        KV ring buffer (window ``cfg.sliding_window``); on a mesh each
        rank writes its own shard."""
        cfg = self.cfg
        x = embed(batch["token"], params["embedding"],
                  getattr(torch, cfg.dtype))
        pos = batch["pos"]
        h = self._backbone(params, x, pos[:, None], cache=cache, pos=pos,
                           ctx=ctx)
        h = rmsnorm(h, params["ln_f"], cfg.norm_eps)
        return ctx.constrain(unembed(h, params["unembed"]),
                             "batch", None, "vocab"), cache
