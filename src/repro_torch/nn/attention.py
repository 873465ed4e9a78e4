"""GQA/MQA attention: prefill (causal or bidirectional or sliding window),
cross attention, and cached decode (full or ring-buffer window cache).

The port of ``repro.nn.attention``.  ``attend(impl=...)`` takes ``"dot"``
(scores materialized), ``"chunked"`` (the online softmax over KV chunks
in PyTorch) or ``"kernel"`` (the CUDA flash-attention kernel; its plain
version on CPU tensors).  The casts are JAX's: ``dot_attention`` casts
the fp32 probabilities to the compute dtype before the PV product, the
chunked and kernel paths keep PV in fp32.

On a mesh (``ctx``, a ``ShardCtx`` over a ``DeviceMesh``) the weights
and activations are DTensors: q, k and the attention output are
constrained at JAX's points (``src/repro/nn/attention.py:131-132, 151,
221``), the positions, rope tables and masks are made as replicated
DTensors on the activations' mesh, the flash kernel runs on each rank's
shard through its sharding rule (``kernels/flash_attention/ops.py``),
and decode writes each rank's own rows of a cache sharded on batch and
kv heads, then attends on each rank's rows and query heads only (its
input whole on its rows, q laid out on its rows and heads, and from the
cache the kv heads those query heads read: ``_repeat_kv``), as JAX's
partitioner splits it.  Attention is independent per (batch, head),
so what DTensor cannot run as it stands (the dot and chunked routes,
``_repeat_kv``, the flash kernel's plain version that CPU training on a
mesh takes) runs on each rank's rows and heads (``nn.layers.per_rank``).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.nn.layers import (NO_SHARD, ShardCtx, apply_rope, kept,
                                   on_mesh_of, per_rank)
from repro_torch.nn.param import ParamSpec

NEG_INF = -2.0e9


def attention_specs(d_model: int, num_heads: int, num_kv_heads: int,
                    head_dim: int):
    return {
        "wq": ParamSpec((d_model, num_heads, head_dim), ("embed", "heads", "qkv")),
        "wk": ParamSpec((d_model, num_kv_heads, head_dim), ("embed", "kv_heads", "qkv")),
        "wv": ParamSpec((d_model, num_kv_heads, head_dim), ("embed", "kv_heads", "qkv")),
        "wo": ParamSpec((num_heads, head_dim, d_model), ("heads", "qkv", "embed")),
    }


def _local_range(n: int, mesh, placements, dim: int):
    """(first global index, count) of this rank's entries of a dim ``dim``
    of size ``n`` under ``placements`` (split evenly, the outer mesh dim
    first, as DTensor splits it)."""
    coord, off = mesh.get_coordinate(), 0
    for i, p in enumerate(placements):
        if isinstance(p, Shard) and p.dim == dim:
            n //= mesh.size(i)
            off += coord[i] * n
    return off, n


def _repeat_kv(k: torch.Tensor, num_heads: int,
               q: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, S, KV, hd) -> (B, S, H, hd) by group broadcast.  A DTensor is
    repeated on each rank's shard.  With ``q`` (decode) the result is
    laid out as q splits its batch and heads: each rank reads only the kv
    heads its own query heads use, so a cache whose kv heads are
    replicated (JAX's divisibility fallback) is indexed locally, not
    gathered.  Without it the result keeps the shard's layout: a rank
    holding KV heads [a, b) holds query heads [a, b) * H/KV."""
    rep = num_heads // k.shape[2]
    if rep == 1:
        return k
    if not isinstance(k, DTensor):
        return k.repeat_interleave(rep, dim=2)
    mesh, shape = k.device_mesh, k.shape[:2] + (num_heads,) + k.shape[3:]
    if q is None:
        return per_rank(lambda t: t.repeat_interleave(rep, dim=2), mesh,
                        [(k, k.placements)], [(k.placements, shape)])
    out = kept(q, 0, 2)
    split = [p == Shard(2) for p in out]
    # k keeps its kv-heads split where q's heads split alike
    lk = [p if not s else kp if kp == Shard(2) else Replicate()
          for p, s, kp in zip(kept(q, 0), split, k.placements)]
    # a replicated cache's gradient: a partial sum over the heads' ranks
    grads = [Partial() if s and p == Replicate() else p
             for p, s in zip(lk, split)]
    h0, n = _local_range(num_heads, mesh, out, 2)
    k0, _ = _local_range(k.shape[2], mesh, lk, 2)
    return per_rank(lambda t: t.index_select(2, torch.arange(
        h0, h0 + n, device=t.device) // rep - k0), mesh,
                    [(k, lk, grads)], [(out, shape)])


# fp32 score elements ``dot_attention`` holds at once (4 GiB): past
# them it takes the queries a block of rows at a time
SCORES_BLOCK = 1 << 30


def _per_shard(fn, q, k, v, mask=None):
    """``fn(q, k, v[, mask])`` on each rank's own rows and heads when q is
    a DTensor: attention is independent per (batch, head), so with k, v
    (heads pre-repeated) laid out as q, and the mask's batch dim as q's,
    each rank's local call computes its shard of the output (DTensor's
    own einsum strategies would flatten a sharded head dim into the
    batch, which some torch versions refuse).  Batch and head splits
    stay; any other split of q is gathered first."""
    if not isinstance(q, DTensor):
        return fn(q, k, v) if mask is None else fn(q, k, v, mask)
    keep = kept(q, 0, 2)
    inputs = [(t, keep) for t in (q, k, v)]
    if mask is not None:
        inputs.append((on_mesh_of(mask, q), [
            p if mask.shape[0] > 1 else Replicate()
            for p in kept(q, 0)]))
    # made contiguous: the strides ``per_rank`` gives
    return per_rank(lambda *a: fn(*a).contiguous(), q.device_mesh, inputs,
                    [(keep, q.shape[:3] + v.shape[3:])])


def _flash_plain_per_rank(q, k, v, window):
    """The flash kernel's plain version (differentiable, causal) on each
    rank's shards of DTensors q, k, v, in a layout the op's sharding
    rule offers: q's batch splits kept, its heads split kept where
    ``heads_split_ok`` holds (K/V split alike, or replicated with their
    gradient a partial sum when they have one head), any other split
    gathered."""
    heads = fa_ops.heads_split_ok(q.shape[2], k.shape[2],
                                  q.device_mesh.size())
    lq = kept(q, 0, 2) if heads else kept(q, 0)
    mqa = [Replicate() if isinstance(p, Shard) and p.dim == 2 else p
           for p in lq]
    kv = (mqa, [Partial() if isinstance(p, Shard) and p.dim == 2 else p
                for p in lq]) if k.shape[2] == 1 else (lq,)
    return per_rank(lambda *a: fa_ops.flash_attention_plain(
        *a, causal=True, window=window).contiguous(), q.device_mesh,
                    [(q, lq), (k, *kv), (v, *kv)], [(lq, q.shape)])


def _dot_rows(q, k, v, mask, dtype):
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) \
        / float(q.shape[-1]) ** 0.5
    scores.masked_fill_(~mask, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(dtype)
    del scores
    return torch.einsum("bhqk,bkhd->bqhd", probs, v.to(dtype))


def dot_attention(q, k, v, mask, dtype=torch.bfloat16):
    """q: (B,Sq,H,hd); k,v: (B,Sk,H,hd); mask (B,1,Sq,Sk) or (1,1,Sq,Sk).
    The scores are materialized, for SCORES_BLOCK elements at most: a
    longer prompt's queries go a block of rows at a time (each row's
    softmax is its own), so a (1, 9216) prompt of 48 heads holds 4 GiB
    of scores, not 15.  DTensors: each rank its own rows and heads
    (``_per_shard``)."""
    return _per_shard(lambda *a: _dot_blocks(*a, dtype), q, k, v, mask)


def _dot_blocks(q, k, v, mask, dtype):
    b, sq, h, _ = q.shape
    rows = max(1, SCORES_BLOCK // (b * h * k.shape[1]))
    if rows >= sq:
        return _dot_rows(q, k, v, mask, dtype)
    return torch.cat([_dot_rows(q[:, r:r + rows], k, v,
                                mask[..., r:r + rows, :], dtype)
                      for r in range(0, sq, rows)], dim=1)


def chunked_attention(q, k, v, *, causal=True, window=None,
                      chunk: int = 1024, dtype=torch.bfloat16):
    """Online-softmax attention over KV chunks, so the (Sq, Sk) scores are
    never materialized.  q: (B,Sq,H,hd); k,v: (B,Sk,H,hd) (heads
    pre-repeated).  JAX's ``lax.scan`` over chunks is a Python loop.
    DTensors: each rank its own rows and heads (``_per_shard``)."""
    return _per_shard(lambda *a: _chunked(*a, causal, window, chunk, dtype),
                      q, k, v)


def _chunked(q, k, v, causal, window, chunk, dtype):
    b, sq, h, hd = q.shape
    sk = k.shape[1]
    qf = q.float() / float(hd) ** 0.5
    q_pos = torch.arange(sq, device=q.device)[:, None] + (sk - sq)
    m = torch.full((b, h, sq), NEG_INF, device=q.device)
    l = torch.zeros((b, h, sq), device=q.device)
    acc = torch.zeros((b, h, sq, hd), device=q.device)
    for c0 in range(0, sk, chunk):
        kb = k[:, c0:c0 + chunk].float()
        vb = v[:, c0:c0 + chunk].float()
        s = torch.einsum("bqhd,bkhd->bhqk", qf, kb)
        k_pos = c0 + torch.arange(kb.shape[1], device=q.device)[None, :]
        mask = torch.ones_like(k_pos, dtype=torch.bool)
        if causal:
            mask = mask & (k_pos <= q_pos)
        if window is not None:
            mask = mask & (k_pos > q_pos - window)
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.where(mask, torch.exp(s - m_new[..., None]), 0.0)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum("bhqk,bkhd->bhqd", p, vb)
        m = m_new
    out = acc / l.clamp_min(1e-20)[..., None]
    return out.transpose(1, 2).to(dtype)                  # (B,Sq,H,hd)


def causal_mask(sq: int, sk: int, window: Optional[int] = None,
                offset: int = 0, device=None) -> torch.Tensor:
    """(1,1,Sq,Sk) bool; query i attends to key j iff j <= i+offset and,
    with a window, j > i+offset-window."""
    qi = torch.arange(sq, device=device)[:, None] + offset
    kj = torch.arange(sk, device=device)[None, :]
    m = kj <= qi
    if window is not None:
        m = m & (kj > qi - window)
    return m[None, None]


def project_qkv(params, x, positions, rope_theta, dtype=torch.bfloat16):
    """Self attention's q (B,S,H,hd) and k, v (B,S,KV,hd) from x (B,S,D),
    rope applied to q and k: what ``attend`` hands to its impl."""
    q = torch.einsum("bsd,dhk->bshk", x, params["wq"].to(dtype))
    k = torch.einsum("bsd,dhk->bshk", x, params["wk"].to(dtype))
    v = torch.einsum("bsd,dhk->bshk", x, params["wv"].to(dtype))
    return (apply_rope(q, positions, rope_theta),
            apply_rope(k, positions, rope_theta), v)


def attend(params, x, positions, *, num_heads, num_kv_heads, head_dim,
           rope_theta, causal=True, window=None, ctx: ShardCtx = NO_SHARD,
           dtype=torch.bfloat16, cross_kv=None, impl="dot"):
    """Self (or cross) attention over a full sequence (prefill).

    x: (B, S, D).  cross_kv: optional (k, v) from an encoder
    (B, S_enc, KV, hd) for cross attention (bidirectional over memory).
    With ``impl="kernel"`` the flash kernel takes K/V un-repeated (GQA
    inside the kernel); JAX's call repeats them first, the same function.
    """
    b, s, _ = x.shape
    if cross_kv is None:
        q, k, v = project_qkv(params, x, positions, rope_theta, dtype)
    else:
        q = torch.einsum("bsd,dhk->bshk", x, params["wq"].to(dtype))
        k, v = cross_kv
    # 'seq' resolves to () under the default rules; seq_parallel maps it
    # to the model axis
    q = ctx.constrain(q, "batch", "seq", "heads", None)
    k = ctx.constrain(k, "batch", None, "kv_heads", None)
    sk = k.shape[1]

    if impl == "kernel" and cross_kv is None and causal:
        if isinstance(q, DTensor) and q.device.type != "cuda" \
                and torch.is_grad_enabled() \
                and any(t.requires_grad for t in (q, k, v)):
            # CPU training on a mesh: the plain version, per rank
            out = _flash_plain_per_rank(q, k, v, window)
        else:
            out = fa_ops.flash_attention(q, k, v, causal=True,
                                         window=window)
    elif impl == "chunked" and cross_kv is None and causal:
        out = chunked_attention(q, _repeat_kv(k, num_heads),
                                _repeat_kv(v, num_heads), causal=True,
                                window=window, dtype=dtype)
    else:
        if cross_kv is not None or not causal:
            mask = torch.ones((1, 1, s, sk), dtype=torch.bool,
                              device=x.device)
        else:
            mask = causal_mask(s, sk, window=window, device=x.device)
        out = dot_attention(q, _repeat_kv(k, num_heads),
                            _repeat_kv(v, num_heads), on_mesh_of(mask, q),
                            dtype=dtype)
    out = ctx.constrain(out, "batch", None, "heads", None)
    return torch.einsum("bshk,hkd->bsd", out, params["wo"].to(dtype))


# ------------------------------------------------------------------ decode
def cache_specs(batch: int, max_len: int, num_kv_heads: int, head_dim: int,
                dtype="bfloat16"):
    s = ParamSpec((batch, max_len, num_kv_heads, head_dim),
                  ("batch", "kv_seq", "kv_heads", "qkv"), init="zeros",
                  dtype=dtype)
    return {"k": s, "v": s}


def init_cache(batch: int, max_len: int, num_kv_heads: int, head_dim: int,
               dtype=torch.bfloat16, device=None):
    shape = (batch, max_len, num_kv_heads, head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _write_rows(cache: torch.Tensor, rows: torch.Tensor,
                slot: torch.Tensor) -> None:
    """``cache[b, slot[b]] = rows[b, 0]`` for every row b, in place.  On a
    mesh each rank writes the rows of its own shard: ``rows`` (B, 1, KV,
    hd) is laid out as the cache (batch and kv heads) and ``slot`` (B,)
    as the cache's batch dim, so the local tensors line up."""
    if isinstance(cache, DTensor):
        rows = rows.redistribute(cache.device_mesh, cache.placements)
        slot = slot.redistribute(cache.device_mesh, [
            p if isinstance(p, Shard) and p.dim == 0 else Replicate()
            for p in cache.placements])
        cache, rows, slot = cache.to_local(), rows.to_local(), \
            slot.to_local()
    bidx = torch.arange(cache.shape[0], device=cache.device)
    cache[bidx, slot] = rows[:, 0].to(cache.dtype)


def decode_attend(params, x, cache, pos, *, num_heads, num_kv_heads,
                  head_dim, rope_theta, window=None,
                  ctx: ShardCtx = NO_SHARD, dtype=torch.bfloat16,
                  cross_kv=None):
    """One-token decode.  x: (B, 1, D); pos: (B,) current absolute position.

    With ``window`` the cache is a ring buffer of size ``window`` (slot =
    pos % window).  The new key and value are written into ``cache`` in
    place (JAX returns an updated copy; the port saves the copy, as JAX's
    donated buffers do), on a mesh each rank its own rows
    (``_write_rows``).  Returns (out (B,1,D), cache).
    """
    # on a mesh: x whole on each rank's rows (no partial sums, so no
    # projection runs on every head), q on its rows and heads
    x = ctx.constrain(x, "batch", None, None)
    q = torch.einsum("bsd,dhk->bshk", x, params["wq"].to(dtype))
    if cross_kv is None:
        q = apply_rope(q, pos[:, None], rope_theta)
    q = ctx.constrain(q, "batch", None, "heads", None)

    if cross_kv is not None:
        k, v = cross_kv
        mask = torch.ones((1, 1, 1, k.shape[1]), dtype=torch.bool,
                          device=x.device)
        out = dot_attention(q, _repeat_kv(k, num_heads, q),
                            _repeat_kv(v, num_heads, q), mask, dtype=dtype)
        out = ctx.constrain(out, "batch", None, "heads", None)
        return torch.einsum("bshk,hkd->bsd", out,
                            params["wo"].to(dtype)), cache

    kn = torch.einsum("bsd,dhk->bshk", x, params["wk"].to(dtype))
    vn = torch.einsum("bsd,dhk->bshk", x, params["wv"].to(dtype))
    kn = apply_rope(kn, pos[:, None], rope_theta)

    max_len = cache["k"].shape[1]
    slot = pos % max_len if window is not None else pos
    _write_rows(cache["k"], kn, slot)
    _write_rows(cache["v"], vn, slot)

    kpos = on_mesh_of(torch.arange(max_len, device=x.device)[None, :],
                      pos)                                     # (1, S)
    p = pos[:, None]
    if window is not None:
        # ring buffer: entry at slot j holds absolute position a with
        # a % window == j and a <= pos; valid iff pos - a < window.
        base = (p // max_len) * max_len
        abs_pos = torch.where(kpos <= p % max_len, base + kpos,
                              base - max_len + kpos)
        valid = (abs_pos >= 0) & (abs_pos <= p) & (abs_pos > p - window)
    else:
        valid = kpos <= p
    mask = valid[:, None, None, :]                             # (B,1,1,S)

    out = dot_attention(q, _repeat_kv(cache["k"], num_heads, q),
                        _repeat_kv(cache["v"], num_heads, q), mask,
                        dtype=dtype)
    out = ctx.constrain(out, "batch", None, "heads", None)
    return torch.einsum("bshk,hkd->bsd", out, params["wo"].to(dtype)), cache
