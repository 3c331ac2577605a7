"""Attention mixers: GQA / MQA / MHA, chunked flash-style.

Two execution regimes share the math, as in the reference:

* ``gqa_apply``  -- full sequence (prefill).  Attention runs chunked with an
  online-softmax accumulator: a Python loop over q chunks, and for each an
  ordered loop over the kv chunks at or before it (causal), so the (qc, kc)
  score tile stays bounded.
* ``gqa_decode`` -- one new token against a cached KV, written in place at
  ``length``.

Scores and the probability-weighted values are float32 products of the
compute-dtype operands (the reference's ``preferred_element_type=f32``):
the operands are widened to float32, where a product of two bf16 values is
exact, and multiplied without TF32 (``layers.exact_products``).  This is
not ``scaled_dot_product_attention``, which rounds and masks otherwise.

MLA (DeepSeek) and cross-attention (Whisper) are still to port
(``ROADMAP.md``).
"""
from __future__ import annotations

import math

import torch
from torch import nn

from .config import ModelConfig
from .layers import apply_rope, cast, dense_init, zeros

NEG_INF = -1e30

_MLA_TODO = "MLA attention is not ported yet: it waits for DeepSeek (ROADMAP.md)"
CROSS_TODO = ("cross-attention is not ported yet: it waits for the audio "
              "family (ROADMAP.md)")


# ---------------------------------------------------------------------------
# chunked causal attention (online softmax), grouped heads
# ---------------------------------------------------------------------------


def _scores(qg: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """``einsum("btghd,bshd->bghts")`` in float32: qg (B,Tq,G,Hkv,hd), k
    (B,Tk,Hkv,hd) -> (B,G,Hkv,Tq,Tk)."""
    return qg.float().permute(0, 2, 3, 1, 4) @ k.float().permute(0, 2, 3, 1)[:, None]


def _weighted(p: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``einsum("bghts,bshd->bghtd")`` in float32 of ``p`` rounded to v's
    dtype: p (B,G,Hkv,Tq,Tk), v (B,Tk,Hkv,hv) -> (B,G,Hkv,Tq,hv)."""
    return p.to(v.dtype).float() @ v.float().permute(0, 2, 1, 3)[:, None]


def chunked_causal_attention(q, k, v, *, chunk: int, causal: bool = True,
                             kv_len=None, scale: float | None = None):
    """Flash-style attention.  q (B,T,Hq,hd), k/v (B,S,Hkv,hd|hv).

    Hq must be a multiple of Hkv (GQA groups; query head ``g * Hkv + h``
    reads kv head ``h``).  ``kv_len`` optionally masks positions >= kv_len
    (ragged cache).  Returns (B,T,Hq,hv) in q's dtype.
    """
    b, t, hq, hd = q.shape
    hkv = k.shape[2]
    hv = v.shape[-1]
    g = hq // hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)

    # pad q and kv to chunk multiples; padded kv columns are masked below.
    qc = min(chunk, t)
    kc = min(chunk, k.shape[1])
    t_pad = -(-t // qc) * qc - t
    s_pad = -(-k.shape[1] // kc) * kc - k.shape[1]
    if kv_len is None and s_pad:
        kv_len = k.shape[1]
    if t_pad:
        q = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, t_pad))
    if s_pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, s_pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, s_pad))
    t_full, s_len = t + t_pad, k.shape[1]
    qg = (q * scale).reshape(b, t_full, g, hkv, hd)
    nq, nk = t_full // qc, s_len // kc
    dev = q.device

    out = []
    for i in range(nq):
        qi = qg[:, i * qc:(i + 1) * qc]
        # kv chunks 0..hi-1 (inclusive of the diagonal chunk when causal)
        hi = min(((i + 1) * qc + kc - 1) // kc, nk) if causal else nk
        pos_q = i * qc + torch.arange(qc, device=dev)
        m = torch.full((b, g, hkv, qc), NEG_INF, dtype=torch.float32, device=dev)
        l = torch.zeros((b, g, hkv, qc), dtype=torch.float32, device=dev)
        acc = torch.zeros((b, g, hkv, qc, hv), dtype=torch.float32, device=dev)
        for j in range(hi):
            kj = k[:, j * kc:(j + 1) * kc]
            vj = v[:, j * kc:(j + 1) * kc]
            pos_k = j * kc + torch.arange(kc, device=dev)
            bias = torch.zeros((qc, kc), dtype=torch.float32, device=dev)
            if causal:
                bias = torch.where(pos_q[:, None] >= pos_k[None, :], 0.0, NEG_INF)
            if kv_len is not None:
                bias = bias + torch.where(pos_k[None, :] < kv_len, 0.0, NEG_INF)
            s = _scores(qi, kj) + bias  # (B,G,Hkv,qc,kc)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + _weighted(p, vj)
            m = m_new
        o = acc / torch.clamp_min(l, 1e-30)[..., None]  # (B,G,Hkv,qc,hv)
        out.append(o.permute(0, 3, 1, 2, 4).reshape(b, qc, hq, hv))
    res = torch.cat(out, dim=1) if len(out) > 1 else out[0]
    return res[:, :t].to(q.dtype)


def decode_attention(q, k_cache, v_cache, length, scale: float | None = None):
    """Single-step attention: q (B,1,Hq,hd) vs cache (B,S,Hkv,hd|hv); cache
    positions >= ``length`` are masked."""
    b, _, hq, hd = q.shape
    s = k_cache.shape[1]
    hkv = k_cache.shape[2]
    g = hq // hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    qg = (q * scale).reshape(b, 1, g, hkv, hd)
    sc = _scores(qg, k_cache)
    mask = torch.arange(s, device=q.device) < length
    sc = torch.where(mask, sc, NEG_INF)
    p = torch.softmax(sc, dim=-1)
    o = _weighted(p, v_cache)
    return o.permute(0, 3, 1, 2, 4).reshape(b, 1, hq, v_cache.shape[-1]).to(q.dtype)


# ---------------------------------------------------------------------------
# GQA layer
# ---------------------------------------------------------------------------


def gqa_init(rng, cfg: ModelConfig) -> nn.ParameterDict:
    d, h, hkv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_
    p = nn.ParameterDict({
        "wq": dense_init(rng, (d, h, hd)),
        "wk": dense_init(rng, (d, hkv, hd)),
        "wv": dense_init(rng, (d, hkv, hd)),
        "wo": dense_init(rng, (h, hd, d), in_axis=(0, 1)),
    })
    if cfg.qkv_bias:
        p["bq"] = zeros((h, hd), rng.device)
        p["bk"] = zeros((hkv, hd), rng.device)
        p["bv"] = zeros((hkv, hd), rng.device)
    return p


def _project(x, w):
    """``einsum("btd,dhk->bthk")``."""
    d, h, k = w.shape
    return (x @ cast(w, x.dtype).reshape(d, h * k)).reshape(x.shape[:2] + (h, k))


def _out(o, w):
    """``einsum("bthk,hkd->btd")``."""
    h, k, d = w.shape
    return o.reshape(o.shape[:2] + (h * k,)) @ cast(w, o.dtype).reshape(h * k, d)


def _qkv(cfg, p, x, positions, rope=True):
    dt = x.dtype
    q, k, v = _project(x, p["wq"]), _project(x, p["wk"]), _project(x, p["wv"])
    if cfg.qkv_bias:
        q = q + cast(p["bq"], dt)
        k = k + cast(p["bk"], dt)
        v = v + cast(p["bv"], dt)
    if rope and cfg.pos_emb == "rope":
        q = apply_rope(cfg, q, positions)
        k = apply_rope(cfg, k, positions)
    return q, k, v


def gqa_apply(cfg: ModelConfig, ctx, p, x, positions, *, causal=True):
    """Full-sequence GQA.  Returns (out (B,T,D), (k, v))."""
    q, k, v = _qkv(cfg, p, x, positions)
    q = ctx.act_bthd(q)
    k = ctx.act_bthd(k)
    v = ctx.act_bthd(v)
    o = chunked_causal_attention(q, k, v, chunk=cfg.attn_chunk, causal=causal)
    o = ctx.act_bthd(o)
    return _out(o, p["wo"]), (k, v)


def gqa_decode(cfg: ModelConfig, ctx, p, x, cache_k, cache_v, length: int):
    """One-token decode.  x (B,1,D); cache (B,S,Hkv,hd), written in place at
    position ``length`` (a host integer).  Returns (out, cache_k, cache_v)."""
    pos = torch.full((x.shape[0], 1), length, dtype=torch.int32, device=x.device)
    q, k, v = _qkv(cfg, p, x, pos)
    cache_k[:, length] = k[:, 0]
    cache_v[:, length] = v[:, 0]
    o = decode_attention(q, ctx.kv_cache(cache_k), ctx.kv_cache(cache_v), length + 1)
    return _out(o, p["wo"]), cache_k, cache_v


def mla_init(rng, cfg: ModelConfig):
    raise NotImplementedError(_MLA_TODO)


def mla_apply(cfg: ModelConfig, ctx, p, x, positions, *, causal=True):
    raise NotImplementedError(_MLA_TODO)


def mla_decode(cfg: ModelConfig, ctx, p, x, cache_ckv, cache_krope, length):
    raise NotImplementedError(_MLA_TODO)
