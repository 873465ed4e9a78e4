"""Decoder-only LM: the port of ``repro.models.decoder.DecoderLM``.  Dense
(llama3.2, repro-100m, gemma, granite, minitron), MoE (grok-1,
llama4-scout: ``nn/moe.py`` in place of the MLP, its load-balance loss
summed over layers into ``loss``) and stub-frontend decoders (internvl2:
``batch["embeds"]`` rows prepended to the token embeddings).

Parameters keep JAX's layer-stacked layout (``layers/attn/wq`` is
(L, D, H, hd)); JAX's ``lax.scan`` over layers is a Python loop over
``unstack(params["layers"])`` (``take_layer`` in decode).  ``loss``
trains through the attention of ``cfg.attention_impl``: ``"dot"`` or
``"chunked"`` (the kernel has no backward pass and refuses an input
that requires grad); with ``cfg.remat`` each layer is recomputed in the
backward pass, as JAX's ``jax.checkpoint`` over its scanned block.

On a mesh (``ctx``, a ``ShardCtx`` over a ``DeviceMesh``, with DTensor
parameters and inputs) every family runs as a DTensor program,
constrained at JAX's points (``src/repro/models/decoder.py:83, 110,
135, 183``); the MoE layers keep their dispatch on each rank's rows and
run the expert MLP as DTensor products (``nn/moe.py``), under the
default rules or ``EXPERT_PARALLEL_RULES``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.common import (LMBase, chunked_softmax_xent,
                                      maybe_checkpoint, spec_zeros,
                                      stack_specs, take_layer, unstack)
from repro_torch.nn import attention as attn
from repro_torch.nn import mlp as mlp_lib
from repro_torch.nn import moe as moe_lib
from repro_torch.nn import param as P
from repro_torch.nn.layers import (NO_SHARD, ShardCtx, embed,
                                   embedding_spec, on_mesh_of, rmsnorm,
                                   rmsnorm_spec, unembed)


def _layer_specs(cfg: ModelConfig):
    specs = {
        "ln1": rmsnorm_spec(cfg.d_model),
        "attn": attn.attention_specs(cfg.d_model, cfg.num_heads,
                                     cfg.num_kv_heads,
                                     cfg.resolved_head_dim()),
        "ln2": rmsnorm_spec(cfg.d_model),
    }
    if cfg.moe is not None:
        specs["moe"] = moe_lib.moe_specs(cfg.d_model, cfg.d_ff, cfg.moe,
                                         cfg.mlp_activation)
    else:
        specs["mlp"] = mlp_lib.mlp_specs(cfg.d_model, cfg.d_ff,
                                         cfg.mlp_activation)
    return specs


class DecoderLM(LMBase):
    def param_specs(self):
        cfg = self.cfg
        specs = {
            "embedding": embedding_spec(cfg.vocab_size, cfg.d_model),
            "layers": stack_specs(_layer_specs(cfg), cfg.num_layers),
            "ln_f": rmsnorm_spec(cfg.d_model),
        }
        if not cfg.tie_embeddings:
            specs["unembed"] = P.ParamSpec(
                (cfg.vocab_size, cfg.d_model), ("vocab", "embed"),
                init="embed", scale=0.02)
        return specs

    # ------------------------------------------------------------- forward
    def _ffn(self, p, x, dtype, pin=None, ctx: ShardCtx = NO_SHARD):
        """The block's MLP or MoE on x = rmsnorm(h): (y, aux, the expert
        ids it routed to or None)."""
        cfg = self.cfg
        if cfg.moe is None:
            return mlp_lib.mlp(p["mlp"], x, cfg.mlp_activation, dtype,
                               ctx), on_mesh_of(torch.zeros(
                                   (), dtype=torch.float32,
                                   device=x.device), x), None
        return moe_lib.moe_mlp_routed(p["moe"], x, cfg.moe,
                                      cfg.mlp_activation, dtype,
                                      expert_ids=pin, ctx=ctx)

    def _block(self, p, x, positions, window, dtype, pin=None,
               ctx: ShardCtx = NO_SHARD):
        cfg = self.cfg
        h = attn.attend(p["attn"], rmsnorm(x, p["ln1"], cfg.norm_eps),
                        positions, num_heads=cfg.num_heads,
                        num_kv_heads=cfg.num_kv_heads,
                        head_dim=cfg.resolved_head_dim(),
                        rope_theta=cfg.rope_theta, causal=True,
                        window=window, ctx=ctx, dtype=dtype,
                        impl=cfg.attention_impl)
        x = x + h
        y, aux, ids = self._ffn(p, rmsnorm(x, p["ln2"], cfg.norm_eps),
                                dtype, pin, ctx)
        return x + y, aux, ids

    def _backbone(self, params, x, positions, window=None, pins=None,
                  ctx: ShardCtx = NO_SHARD):
        """(final-normed hidden, the layers' summed aux loss, each MoE
        layer's expert ids); ``pins`` (L, B, S, k) fixes the routing."""
        cfg = self.cfg
        dtype = getattr(torch, cfg.dtype)
        aux = on_mesh_of(torch.zeros((), dtype=torch.float32,
                                     device=x.device), x)
        ids = []
        for i, lp in enumerate(unstack(params["layers"])):
            x = ctx.constrain(x, "batch", None, "embed_act")
            x, a, e = maybe_checkpoint(
                cfg.remat, self._block, lp, x, positions, window, dtype,
                None if pins is None else pins[i], ctx)
            aux = aux + a
            ids.append(e)
        return rmsnorm(x, params["ln_f"], cfg.norm_eps), aux, ids

    def _embed_inputs(self, params, batch, dtype):
        x = embed(batch["tokens"], params["embedding"], dtype)
        if "embeds" in batch:   # vlm/audio stub frontend: prepend embeddings
            x = torch.cat([batch["embeds"].to(dtype), x], dim=1)
        return x

    def _table(self, params):
        return params["embedding"] if self.cfg.tie_embeddings \
            else params["unembed"]

    def _hidden(self, params, batch, ctx: ShardCtx = NO_SHARD,
                loss: bool = False):
        """``_backbone`` over ``batch["tokens"]`` (after ``batch["embeds"]``
        where given; positions run over the whole sequence); the sliding
        window applies only past ``cfg.sliding_window``.
        ``batch["expert_ids"]`` (L, B, S, k), for checks only, pins the
        MoE routing (``nn.moe.moe_mlp``).  ``loss`` constrains the
        embeddings as JAX's ``loss`` does (``:110``)."""
        cfg = self.cfg
        x = self._embed_inputs(params, batch, getattr(torch, cfg.dtype))
        b, s, _ = x.shape
        positions = on_mesh_of(torch.arange(s, device=x.device)
                               .expand(b, s), x)
        if loss:
            x = ctx.constrain(x, "batch", None, None)
        return self._backbone(params, x, positions,
                              window=cfg.sliding_window
                              if cfg.sliding_window
                              and s > cfg.sliding_window else None,
                              pins=batch.get("expert_ids"), ctx=ctx)

    # ------------------------------------------------------------- training
    def loss(self, params, batch, ctx: ShardCtx = NO_SHARD):
        """(ce + the MoE layers' aux loss, {"ce", "aux"}); the frontend's
        ``embeds`` rows carry no labels."""
        h, aux, _ = self._hidden(params, batch, ctx, loss=True)
        npad = h.shape[1] - batch["labels"].shape[1]
        ce = chunked_softmax_xent(h[:, npad:], self._table(params),
                                  batch["labels"], ctx=ctx)
        return ce + aux, {"ce": ce, "aux": aux}

    # ------------------------------------------------------------- serving
    @torch.no_grad()
    def prefill(self, params, batch, ctx: ShardCtx = NO_SHARD):
        h, _, _ = self._hidden(params, batch, ctx)
        return ctx.constrain(unembed(h[:, -1:], self._table(params)),
                             "batch", None, "vocab")

    @torch.no_grad()
    def routing(self, params, batch, ctx: ShardCtx = NO_SHARD):
        """The expert ids (L, B, S, k) that ``prefill`` of ``batch`` routes
        each MoE layer's tokens to: what ``batch["expert_ids"]`` takes to
        replay this routing on another attention route (or mesh)."""
        if self.cfg.moe is None:
            raise ValueError(f"{self.cfg.name} has no MoE layers")
        return torch.stack(self._hidden(params, batch, ctx)[2])

    def cache_specs(self, batch: int, max_len: int):
        cfg = self.cfg
        one = attn.cache_specs(batch, max_len, cfg.num_kv_heads,
                               cfg.resolved_head_dim(), dtype=cfg.dtype)
        return stack_specs(one, cfg.num_layers)

    def init_cache(self, batch: int, max_len: int,
                   device: DeviceLike = None):
        """Zeros of ``cache_specs`` on ``device`` (default: the GPU)."""
        return spec_zeros(self.cache_specs(batch, max_len),
                          resolve_device(device))

    @torch.no_grad()
    def decode_step(self, params, cache, batch,
                    window: Optional[int] = None,
                    ctx: ShardCtx = NO_SHARD):
        """One token for every row.  ``cache`` is updated in place and
        returned (see ``attn.decode_attend``)."""
        cfg = self.cfg
        dtype = getattr(torch, cfg.dtype)
        x = embed(batch["token"], params["embedding"], dtype)
        pos = batch["pos"]
        max_len = cache["k"].shape[2]
        win = window
        if win is None and cfg.sliding_window is not None \
                and max_len == cfg.sliding_window:
            win = cfg.sliding_window   # ring-buffer cache
        h = x
        for i in range(cfg.num_layers):
            p = take_layer(params["layers"], i)
            a, _ = attn.decode_attend(
                p["attn"], rmsnorm(h, p["ln1"], cfg.norm_eps),
                take_layer(cache, i), pos, num_heads=cfg.num_heads,
                num_kv_heads=cfg.num_kv_heads,
                head_dim=cfg.resolved_head_dim(), rope_theta=cfg.rope_theta,
                window=win, ctx=ctx, dtype=dtype)
            h = h + a
            h = h + self._ffn(p, rmsnorm(h, p["ln2"], cfg.norm_eps),
                              dtype, ctx=ctx)[0]
        h = rmsnorm(h, params["ln_f"], cfg.norm_eps)
        return ctx.constrain(unembed(h, self._table(params)),
                             "batch", None, "vocab"), cache
