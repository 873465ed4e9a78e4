"""RWKV6 language model (attention-free; O(1)-state decode): the port of
``repro.models.rwkv_model.RWKVModel``.

Parameters keep JAX's layer-stacked layout; JAX's ``lax.scan`` over
layers is a Python loop over ``unstack`` (``take_layer`` in decode).
The recurrent state is JAX's 3-tuple ``(prev_att (L,B,D), wkv
(L,B,H,hd,hd) fp32, prev_ffn (L,B,D))``; ``decode_step`` updates it in
place and returns it.  The prefill's WKV runs the ``ssm_scan`` kernel
once per layer.  As in JAX, the blocks take their default bfloat16
weight casts whatever ``cfg.dtype`` (the activations') is.  ``loss`` runs the WKV through
``impl="plain"`` (``nn.linear_attn.gla_chunked``, differentiable), the
path JAX's ``loss`` takes through its jnp scan; with ``cfg.remat`` each
layer is recomputed in the backward pass.

On a mesh (``ctx``, a ``ShardCtx`` over a ``DeviceMesh``, with DTensor
parameters and inputs) it runs as a DTensor program constrained at
JAX's points (``src/repro/models/rwkv_model.py:48, 91, 103, 128``): r,
k and v come out of their ("embed", "heads") projections with their
heads split on 'model', so the scan takes the heads split through the
``ssm_scan`` op's sharding rule (``impl="plain"``: each rank's rows and
heads, ``nn.linear_attn``), and decode writes each rank's shard of the
three-part state in place (``write_layer``).
"""
from __future__ import annotations

import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.common import (LMBase, chunked_softmax_xent,
                                      maybe_checkpoint, stack_specs,
                                      take_layer, unstack, write_layer)
from repro_torch.nn import param as P
from repro_torch.nn import rwkv
from repro_torch.nn.layers import (NO_SHARD, ShardCtx, embed,
                                   embedding_spec, on_mesh_of, rmsnorm,
                                   rmsnorm_spec, unembed)


def _layer_specs(cfg):
    return {
        "ln1": rmsnorm_spec(cfg.d_model),
        "att": rwkv.time_mix_specs(cfg),
        "ln2": rmsnorm_spec(cfg.d_model),
        "ffn": rwkv.channel_mix_specs(cfg),
    }


class RWKVModel(LMBase):
    def param_specs(self):
        cfg = self.cfg
        return {
            "embedding": embedding_spec(cfg.vocab_size, cfg.d_model),
            "ln_in": rmsnorm_spec(cfg.d_model),
            "layers": stack_specs(_layer_specs(cfg), cfg.num_layers),
            "ln_f": rmsnorm_spec(cfg.d_model),
            "unembed": P.ParamSpec((cfg.vocab_size, cfg.d_model),
                                   ("vocab", "embed"), init="embed",
                                   scale=0.02),
        }

    def _embed(self, params, tokens):
        cfg = self.cfg
        x = embed(tokens, params["embedding"], getattr(torch, cfg.dtype))
        return rmsnorm(x, params["ln_in"], cfg.norm_eps)

    def _layer(self, lp, x, impl, ctx: ShardCtx = NO_SHARD):
        cfg = self.cfg
        x = ctx.constrain(x, "batch", None, "embed_act")
        zero = torch.zeros_like(x[:, 0])                # no previous token
        a, _ = rwkv.time_mix(
            lp["att"], rmsnorm(x, lp["ln1"], cfg.norm_eps), cfg,
            prev_x=zero, state=None, ctx=ctx, impl=impl)
        x = x + a
        f, _ = rwkv.channel_mix(
            lp["ffn"], rmsnorm(x, lp["ln2"], cfg.norm_eps), prev_x=zero)
        return x + f

    def _backbone(self, params, x, impl="kernel", ctx: ShardCtx = NO_SHARD):
        """The layers from the zero state; returns the final-normed
        hidden (JAX's also returns the new state, which ``prefill``
        drops).  ``impl``: the WKV scan's (``rwkv.time_mix``)."""
        cfg = self.cfg
        for lp in unstack(params["layers"]):
            x = maybe_checkpoint(cfg.remat, self._layer, lp, x, impl, ctx)
        return rmsnorm(x, params["ln_f"], cfg.norm_eps)

    def cache_specs(self, batch: int, max_len: int):
        cfg = self.cfg
        h, hd = cfg.num_heads, cfg.resolved_head_dim()
        L = cfg.num_layers
        return (P.ParamSpec((L, batch, cfg.d_model),
                            ("layers", "batch", "embed_act"),
                            init="zeros", dtype=cfg.dtype),
                P.ParamSpec((L, batch, h, hd, hd),
                            ("layers", "batch", "heads", None, None),
                            init="zeros", dtype="float32"),
                P.ParamSpec((L, batch, cfg.d_model),
                            ("layers", "batch", "embed_act"),
                            init="zeros", dtype=cfg.dtype))

    def init_cache(self, batch: int, max_len: int,
                   device: DeviceLike = None):
        """The zero state on ``device`` (default: the GPU); its size does
        not depend on ``max_len``."""
        cfg = self.cfg
        dev = resolve_device(device)
        h, hd = cfg.num_heads, cfg.resolved_head_dim()
        dt = getattr(torch, cfg.dtype)
        L = cfg.num_layers
        return (torch.zeros(L, batch, cfg.d_model, dtype=dt, device=dev),
                torch.zeros(L, batch, h, hd, hd, device=dev),
                torch.zeros(L, batch, cfg.d_model, dtype=dt, device=dev))

    # ------------------------------------------------------------ training
    def loss(self, params, batch, ctx: ShardCtx = NO_SHARD):
        x = ctx.constrain(self._embed(params, batch["tokens"]),
                          "batch", None, None)
        h = self._backbone(params, x, impl="plain", ctx=ctx)
        ce = chunked_softmax_xent(h, params["unembed"], batch["labels"],
                                  ctx=ctx)
        return ce, {"ce": ce, "aux": on_mesh_of(torch.zeros(
            (), dtype=torch.float32, device=h.device), h)}

    # ------------------------------------------------------------- serving
    @torch.no_grad()
    def prefill(self, params, batch, ctx: ShardCtx = NO_SHARD):
        h = self._backbone(params, self._embed(params, batch["tokens"]),
                           ctx=ctx)
        return ctx.constrain(unembed(h[:, -1:], params["unembed"]),
                             "batch", None, "vocab")

    @torch.no_grad()
    def decode_step(self, params, cache, batch, ctx: ShardCtx = NO_SHARD):
        """One token for every row (``batch["pos"]`` is not needed: the
        state carries the history).  ``cache`` is updated in place and
        returned (on a mesh, each rank its own shard)."""
        cfg = self.cfg
        x = self._embed(params, batch["token"])
        prev_att, wkv, prev_ffn = cache
        for i in range(cfg.num_layers):
            lp = take_layer(params["layers"], i)
            a, (na, nw) = rwkv.time_mix_decode(
                lp["att"], rmsnorm(x, lp["ln1"], cfg.norm_eps), cfg,
                prev_x=prev_att[i], state=wkv[i], ctx=ctx)
            x = x + a
            f, nf = rwkv.channel_mix(
                lp["ffn"], rmsnorm(x, lp["ln2"], cfg.norm_eps),
                prev_x=prev_ffn[i])
            x = x + f
            for stack, new in ((prev_att, na), (wkv, nw), (prev_ffn, nf)):
                write_layer(stack, i, new)
        h = rmsnorm(x, params["ln_f"], cfg.norm_eps)
        return ctx.constrain(unembed(h, params["unembed"]),
                             "batch", None, "vocab"), cache
