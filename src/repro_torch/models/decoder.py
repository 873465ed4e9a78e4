"""Decoder-only LM, dense family (llama3.2, repro-100m, gemma, granite,
minitron): the port of ``repro.models.decoder.DecoderLM``.

Parameters keep JAX's layer-stacked layout (``layers/attn/wq`` is
(L, D, H, hd)); JAX's ``lax.scan`` over layers is a Python loop over
``unstack(params["layers"])`` (``take_layer`` in decode).  ``loss``
trains through the attention of ``cfg.attention_impl``: ``"dot"`` or
``"chunked"`` (the kernel has no backward pass and refuses an input
that requires grad); with ``cfg.remat`` each layer is recomputed in the
backward pass, as JAX's ``jax.checkpoint`` over its scanned block.  MoE
layers and stub frontends wait for their slices.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.common import (LMBase, chunked_softmax_xent,
                                      maybe_checkpoint, stack_specs,
                                      take_layer, unstack)
from repro_torch.nn import attention as attn
from repro_torch.nn import mlp as mlp_lib
from repro_torch.nn import param as P
from repro_torch.nn.layers import (embed, embedding_spec, rmsnorm,
                                   rmsnorm_spec, unembed)


def _layer_specs(cfg: ModelConfig):
    return {
        "ln1": rmsnorm_spec(cfg.d_model),
        "attn": attn.attention_specs(cfg.d_model, cfg.num_heads,
                                     cfg.num_kv_heads,
                                     cfg.resolved_head_dim()),
        "ln2": rmsnorm_spec(cfg.d_model),
        "mlp": mlp_lib.mlp_specs(cfg.d_model, cfg.d_ff, cfg.mlp_activation),
    }


class DecoderLM(LMBase):
    def __init__(self, cfg: ModelConfig):
        if cfg.moe is not None:
            raise NotImplementedError(
                f"{cfg.name}: MoE layers are not ported yet (ROADMAP.md "
                f"queue 1, item 6.4: MoE)")
        if cfg.frontend.kind != "none":
            raise NotImplementedError(
                f"{cfg.name}: stub frontends are not ported yet "
                f"(ROADMAP.md queue 1, item 6.5)")
        super().__init__(cfg)

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
    def _block(self, p, x, positions, window, dtype):
        cfg = self.cfg
        h = attn.attend(p["attn"], rmsnorm(x, p["ln1"], cfg.norm_eps),
                        positions, num_heads=cfg.num_heads,
                        num_kv_heads=cfg.num_kv_heads,
                        head_dim=cfg.resolved_head_dim(),
                        rope_theta=cfg.rope_theta, causal=True,
                        window=window, dtype=dtype,
                        impl=cfg.attention_impl)
        x = x + h
        y = mlp_lib.mlp(p["mlp"], rmsnorm(x, p["ln2"], cfg.norm_eps),
                        cfg.mlp_activation, dtype)
        return x + y

    def _backbone(self, params, x, positions, window=None):
        cfg = self.cfg
        dtype = getattr(torch, cfg.dtype)
        for lp in unstack(params["layers"]):
            x = maybe_checkpoint(cfg.remat, self._block, lp, x, positions,
                                 window, dtype)
        return rmsnorm(x, params["ln_f"], cfg.norm_eps)

    def _embed_inputs(self, params, batch, dtype):
        return embed(batch["tokens"], params["embedding"], dtype)

    def _table(self, params):
        return params["embedding"] if self.cfg.tie_embeddings \
            else params["unembed"]

    def _hidden(self, params, batch):
        """The final-normed hidden (B, S, D) of ``batch["tokens"]``;
        the sliding window applies only past ``cfg.sliding_window``."""
        cfg = self.cfg
        x = self._embed_inputs(params, batch, getattr(torch, cfg.dtype))
        b, s, _ = x.shape
        positions = torch.arange(s, device=x.device).expand(b, s)
        return self._backbone(params, x, positions,
                              window=cfg.sliding_window
                              if cfg.sliding_window
                              and s > cfg.sliding_window else None)

    # ------------------------------------------------------------- training
    def loss(self, params, batch):
        h = self._hidden(params, batch)
        npad = h.shape[1] - batch["labels"].shape[1]
        ce = chunked_softmax_xent(h[:, npad:], self._table(params),
                                  batch["labels"])
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
        return ce + aux, {"ce": ce, "aux": aux}

    # ------------------------------------------------------------- serving
    @torch.no_grad()
    def prefill(self, params, batch):
        h = self._hidden(params, batch)
        return unembed(h[:, -1:], self._table(params))

    def cache_specs(self, batch: int, max_len: int):
        cfg = self.cfg
        one = attn.cache_specs(batch, max_len, cfg.num_kv_heads,
                               cfg.resolved_head_dim(), dtype=cfg.dtype)
        return stack_specs(one, cfg.num_layers)

    def init_cache(self, batch: int, max_len: int,
                   device: DeviceLike = None):
        """Zeros of ``cache_specs`` on ``device`` (default: the GPU)."""
        dev = resolve_device(device)
        return {k: torch.zeros(s.shape, dtype=getattr(torch, s.dtype),
                               device=dev)
                for k, s in self.cache_specs(batch, max_len).items()}

    @torch.no_grad()
    def decode_step(self, params, cache, batch,
                    window: Optional[int] = None):
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
                window=win, dtype=dtype)
            h = h + a
            h = h + mlp_lib.mlp(p["mlp"], rmsnorm(h, p["ln2"], cfg.norm_eps),
                                cfg.mlp_activation, dtype)
        h = rmsnorm(h, params["ln_f"], cfg.norm_eps)
        return unembed(h, self._table(params)), cache
