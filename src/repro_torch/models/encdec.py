"""Encoder-decoder transformer (seamless-m4t backbone): the port of
``repro.models.encdec.EncDecModel``.

Encoder: bidirectional self-attention over stub frame embeddings (the
audio frontend carve-out).  Decoder: causal self-attention +
cross-attention to the encoder memory.  Decode caches self-attention KV
per layer; cross KV is computed once from the encoder output
(``build_cross_cache``).  Every attention here takes the plain route, as
in JAX, whose encoder-decoder passes no ``impl``: ``cfg.attention_impl``
is not read.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.common import (LMBase, chunked_softmax_xent,
                                      maybe_checkpoint, spec_zeros,
                                      stack_specs, take_layer, unstack)
from repro_torch.nn import attention as attn
from repro_torch.nn import mlp as mlp_lib
from repro_torch.nn import param as P
from repro_torch.nn.layers import (embed, embedding_spec, rmsnorm,
                                   rmsnorm_spec, unembed)


def _enc_layer_specs(cfg):
    hd = cfg.resolved_head_dim()
    return {
        "ln1": rmsnorm_spec(cfg.d_model),
        "attn": attn.attention_specs(cfg.d_model, cfg.num_heads,
                                     cfg.num_kv_heads, hd),
        "ln2": rmsnorm_spec(cfg.d_model),
        "mlp": mlp_lib.mlp_specs(cfg.d_model, cfg.d_ff, cfg.mlp_activation),
    }


def _dec_layer_specs(cfg):
    hd = cfg.resolved_head_dim()
    return {
        "ln1": rmsnorm_spec(cfg.d_model),
        "self_attn": attn.attention_specs(cfg.d_model, cfg.num_heads,
                                          cfg.num_kv_heads, hd),
        "ln_x": rmsnorm_spec(cfg.d_model),
        "cross_attn": attn.attention_specs(cfg.d_model, cfg.num_heads,
                                           cfg.num_kv_heads, hd),
        "ln2": rmsnorm_spec(cfg.d_model),
        "mlp": mlp_lib.mlp_specs(cfg.d_model, cfg.d_ff, cfg.mlp_activation),
    }


class EncDecModel(LMBase):
    def param_specs(self):
        cfg = self.cfg
        return {
            "embedding": embedding_spec(cfg.vocab_size, cfg.d_model),
            "enc_layers": stack_specs(_enc_layer_specs(cfg),
                                      cfg.encdec.num_encoder_layers),
            "enc_ln_f": rmsnorm_spec(cfg.d_model),
            "dec_layers": stack_specs(_dec_layer_specs(cfg), cfg.num_layers),
            "ln_f": rmsnorm_spec(cfg.d_model),
            "unembed": P.ParamSpec((cfg.vocab_size, cfg.d_model),
                                   ("vocab", "embed"), init="embed",
                                   scale=0.02),
        }

    def _attn_kw(self):
        cfg = self.cfg
        return dict(num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
                    head_dim=cfg.resolved_head_dim(),
                    rope_theta=cfg.rope_theta)

    def _enc_block(self, lp, h, positions, dt):
        cfg = self.cfg
        h = h + attn.attend(lp["attn"], rmsnorm(h, lp["ln1"], cfg.norm_eps),
                            positions, causal=False, dtype=dt,
                            **self._attn_kw())
        return h + mlp_lib.mlp(lp["mlp"], rmsnorm(h, lp["ln2"], cfg.norm_eps),
                               cfg.mlp_activation, dt)

    def _encode(self, params, src):
        """The encoder memory (B, S_enc, D) of frame embeddings ``src``."""
        cfg = self.cfg
        dt = getattr(torch, cfg.dtype)
        x = src.to(dt)
        b, s, _ = x.shape
        positions = torch.arange(s, device=x.device).expand(b, s)
        for lp in unstack(params["enc_layers"]):
            x = maybe_checkpoint(cfg.remat, self._enc_block, lp, x,
                                 positions, dt)
        return rmsnorm(x, params["enc_ln_f"], cfg.norm_eps)

    def _cross_kv(self, lp, memory, dt):
        k = torch.einsum("bsd,dhk->bshk", memory,
                         lp["cross_attn"]["wk"].to(dt))
        v = torch.einsum("bsd,dhk->bshk", memory,
                         lp["cross_attn"]["wv"].to(dt))
        return k, v

    def _dec_block(self, lp, h, memory, positions, dt):
        cfg = self.cfg
        h = h + attn.attend(lp["self_attn"],
                            rmsnorm(h, lp["ln1"], cfg.norm_eps), positions,
                            causal=True, dtype=dt, **self._attn_kw())
        h = h + attn.attend(lp["cross_attn"],
                            rmsnorm(h, lp["ln_x"], cfg.norm_eps), positions,
                            cross_kv=self._cross_kv(lp, memory, dt),
                            dtype=dt, **self._attn_kw())
        return h + mlp_lib.mlp(lp["mlp"], rmsnorm(h, lp["ln2"], cfg.norm_eps),
                               cfg.mlp_activation, dt)

    def _decode_seq(self, params, tokens, memory):
        cfg = self.cfg
        dt = getattr(torch, cfg.dtype)
        x = embed(tokens, params["embedding"], dt)
        b, s, _ = x.shape
        positions = torch.arange(s, device=x.device).expand(b, s)
        for lp in unstack(params["dec_layers"]):
            x = maybe_checkpoint(cfg.remat, self._dec_block, lp, x, memory,
                                 positions, dt)
        return rmsnorm(x, params["ln_f"], cfg.norm_eps)

    def loss(self, params, batch):
        """(ce, {"ce", "aux": 0}) of a {"src_embeds", "tokens", "labels"}
        batch."""
        memory = self._encode(params, batch["src_embeds"])
        h = self._decode_seq(params, batch["tokens"], memory)
        ce = chunked_softmax_xent(h, params["unembed"], batch["labels"])
        return ce, {"ce": ce,
                    "aux": torch.zeros((), dtype=torch.float32,
                                       device=h.device)}

    @torch.no_grad()
    def prefill(self, params, batch):
        """Last-token logits (B, 1, V) of {"src_embeds", "tokens"}."""
        memory = self._encode(params, batch["src_embeds"])
        h = self._decode_seq(params, batch["tokens"], memory)
        return unembed(h[:, -1:], params["unembed"])

    # ---------------------------------------------------------------- decode
    def cache_specs(self, batch: int, max_len: int):
        cfg = self.cfg
        hd = cfg.resolved_head_dim()
        self_kv = stack_specs(attn.cache_specs(batch, max_len,
                                               cfg.num_kv_heads, hd,
                                               cfg.dtype), cfg.num_layers)
        enc = cfg.encdec.encoder_seq
        cross = P.ParamSpec(
            (cfg.num_layers, batch, enc, cfg.num_kv_heads, hd),
            ("layers", "batch", None, "kv_heads", "qkv"), init="zeros",
            dtype=cfg.dtype)
        return {"self": self_kv, "cross": {"k": cross, "v": cross}}

    def init_cache(self, batch: int, max_len: int,
                   device: DeviceLike = None):
        """Zeros of ``cache_specs`` on ``device`` (default: the GPU)."""
        return spec_zeros(self.cache_specs(batch, max_len),
                          resolve_device(device))

    @torch.no_grad()
    def build_cross_cache(self, params, memory):
        """{"k", "v"} (L, B, S_enc, KV, hd): every decoder layer's cross
        keys and values of the encoder memory."""
        dt = getattr(torch, self.cfg.dtype)
        kv = [self._cross_kv(take_layer(params["dec_layers"], i), memory, dt)
              for i in range(self.cfg.num_layers)]
        return {"k": torch.stack([k for k, _ in kv]),
                "v": torch.stack([v for _, v in kv])}

    @torch.no_grad()
    def decode_step(self, params, cache, batch,
                    window: Optional[int] = None):
        """One token for every row against ``cache["cross"]``; the
        self-attention cache is updated in place and returned."""
        cfg = self.cfg
        dt = getattr(torch, cfg.dtype)
        h = embed(batch["token"], params["embedding"], dt)
        pos = batch["pos"]
        for i in range(cfg.num_layers):
            lp = take_layer(params["dec_layers"], i)
            a, _ = attn.decode_attend(
                lp["self_attn"], rmsnorm(h, lp["ln1"], cfg.norm_eps),
                take_layer(cache["self"], i), pos, dtype=dt,
                **self._attn_kw())
            h = h + a
            cross = take_layer(cache["cross"], i)
            c, _ = attn.decode_attend(
                lp["cross_attn"], rmsnorm(h, lp["ln_x"], cfg.norm_eps),
                None, pos, dtype=dt, cross_kv=(cross["k"], cross["v"]),
                **self._attn_kw())
            h = h + c
            h = h + mlp_lib.mlp(lp["mlp"], rmsnorm(h, lp["ln2"],
                                                   cfg.norm_eps),
                                cfg.mlp_activation, dt)
        h = rmsnorm(h, params["ln_f"], cfg.norm_eps)
        return unembed(h, params["unembed"]), cache

    def input_specs(self, shape):
        """The dry run's inputs: {"src_embeds", "tokens"[, "labels"]}, or
        decode's {"token", "pos"} (its cross cache is in the cache)."""
        cfg = self.cfg
        i32 = "int32"
        b = shape.global_batch
        src = P.ShapeDtype((b, cfg.encdec.encoder_seq, cfg.d_model),
                           "bfloat16")
        if shape.kind == "train":
            return {"src_embeds": src,
                    "tokens": P.ShapeDtype((b, shape.seq_len), i32),
                    "labels": P.ShapeDtype((b, shape.seq_len), i32)}
        if shape.kind == "prefill":
            return {"src_embeds": src,
                    "tokens": P.ShapeDtype((b, shape.seq_len), i32)}
        return {"token": P.ShapeDtype((b, 1), i32),
                "pos": P.ShapeDtype((b,), i32)}
