"""Block assembly and the layer stack.

A *block* is one layer: pre-norm mixer (GQA or MLA attention, or Mamba;
RWKV is still to port) plus pre-norm FFN (MLP or MoE).  Each block's parameters
are an ``nn.ModuleDict`` (``norm1``, ``mixer``, ``norm2``, ``ffn``: the
reference's per-block dict), one per layer in an ``nn.ModuleList``; the
stack runs them in layer order, which is the order of the reference's
segments (``config.derive_segments``).

The decode cache keeps the reference's layout: per segment, per position
of its pattern, a dict of buffers stacked over the segment's repeats
(``k`` / ``v``, ``ckv`` / ``krope`` for MLA, ``conv`` / ``ssm`` for
Mamba).  Each layer reads and writes its own slice of those buffers in
place.

Three modes share the block code:
  'train'   -- full sequence, no cache.
  'prefill' -- full sequence, fills the cache at position 0.
  'decode'  -- one token against the cache at position ``length``.
"""
from __future__ import annotations

import torch
from torch import nn

from . import attention as attn
from . import mamba as mam
from . import moe as moe_mod
from . import rwkv as rk
from .config import LayerSpec, ModelConfig, derive_segments
from .layers import compute_dtype, mlp_apply, mlp_init, norm_apply, norm_init


# ---------------------------------------------------------------------------
# per-block init
# ---------------------------------------------------------------------------


def block_init(rng, cfg: ModelConfig, spec: LayerSpec, cross: bool = False) -> nn.ModuleDict:
    if cross:
        raise NotImplementedError(attn.CROSS_TODO)
    p = nn.ModuleDict({"norm1": norm_init(cfg, device=rng.device)})
    if spec.mixer == "attn":
        p["mixer"] = (attn.mla_init(rng, cfg) if cfg.attention == "mla"
                      else attn.gqa_init(rng, cfg))
    elif spec.mixer == "mamba":
        p["mixer"] = mam.mamba_init(rng, cfg)
    elif spec.mixer == "rwkv":
        p["mixer"] = rk.rwkv_time_init(rng, cfg)
    else:
        raise ValueError(spec.mixer)
    p["norm2"] = norm_init(cfg, device=rng.device)
    if spec.mixer == "rwkv":
        p["ffn"] = rk.rwkv_channel_init(rng, cfg)
    elif spec.moe:
        p["ffn"] = moe_mod.moe_init(rng, cfg)
    else:
        p["ffn"] = mlp_init(rng, cfg)
    return p


# ---------------------------------------------------------------------------
# per-block cache
# ---------------------------------------------------------------------------


def block_cache_shapes(cfg: ModelConfig, spec: LayerSpec, batch: int,
                       max_len: int, cross_len: int = 0):
    """Dict of (shape, dtype) for this block's decode cache."""
    cd = compute_dtype(cfg)
    out: dict[str, tuple] = {}
    if spec.mixer == "attn":
        if cfg.attention == "mla":
            m = cfg.mla
            out["ckv"] = ((batch, max_len, m.kv_lora_rank), cd)
            out["krope"] = ((batch, max_len, m.qk_rope_head_dim), cd)
        else:
            hkv, hd = cfg.num_kv_heads, cfg.head_dim_
            out["k"] = ((batch, max_len, hkv, hd), cd)
            out["v"] = ((batch, max_len, hkv, hd), cd)
        if cross_len:
            hkv, hd = cfg.num_kv_heads, cfg.head_dim_
            out["ck"] = ((batch, cross_len, hkv, hd), cd)
            out["cv"] = ((batch, cross_len, hkv, hd), cd)
    elif spec.mixer == "mamba":
        conv_s, ssm_s = mam.mamba_state_shapes(cfg, batch)
        out["conv"] = (conv_s, cd)
        out["ssm"] = (ssm_s, torch.float32)
    elif spec.mixer == "rwkv":
        xt, s, xc = rk.rwkv_state_shapes(cfg, batch)
        out["xt"] = (xt, cd)
        out["s"] = (s, torch.float32)
        out["xc"] = (xc, cd)
    return out


# ---------------------------------------------------------------------------
# per-block apply (train / prefill / decode)
# ---------------------------------------------------------------------------


def block_apply(cfg: ModelConfig, ctx, spec: LayerSpec, p, h, positions,
                mode: str, cache, length, enc_h):
    """Returns (h, cache, aux); ``cache`` (this block's buffers) is written
    in place."""
    aux = 0.0
    x = norm_apply(cfg, p["norm1"], h)

    if spec.mixer == "mamba":
        if mode == "decode":
            y, conv_s, ssm_s = mam.mamba_decode(cfg, ctx, p["mixer"], x, cache["conv"],
                                                cache["ssm"])
        else:
            y, (conv_s, ssm_s) = mam.mamba_apply(cfg, ctx, p["mixer"], x)
        if mode != "train":
            cache["conv"].copy_(conv_s)
            cache["ssm"].copy_(ssm_s)
    elif spec.mixer == "rwkv":
        y, _ = rk.rwkv_time_apply(cfg, ctx, p["mixer"], x)
    elif cfg.attention == "mla":
        if mode == "decode":
            y, _, _ = attn.mla_decode(cfg, ctx, p["mixer"], x, cache["ckv"],
                                      cache["krope"], length)
        else:
            y, (c_kv, k_rope) = attn.mla_apply(cfg, ctx, p["mixer"], x, positions,
                                               causal=cfg.causal)
            if mode == "prefill":
                _fill(cache["ckv"], c_kv)
                _fill(cache["krope"], k_rope)
    elif mode == "decode":
        y, _, _ = attn.gqa_decode(cfg, ctx, p["mixer"], x, cache["k"], cache["v"],
                                  length)
    else:
        y, (k, v) = attn.gqa_apply(cfg, ctx, p["mixer"], x, positions,
                                   causal=cfg.causal)
        if mode == "prefill":
            _fill(cache["k"], k)
            _fill(cache["v"], v)
    h = h + y

    if "xattn" in p:  # enc-dec decoder blocks
        raise NotImplementedError(attn.CROSS_TODO)

    x2 = norm_apply(cfg, p["norm2"], h)
    if spec.moe:
        y2, aux = moe_mod.moe_apply(cfg, ctx, p["ffn"], x2)
    else:
        y2 = mlp_apply(cfg, ctx, p["ffn"], x2)
    h = ctx.act_btd(h + y2)
    return h, cache, aux


def _fill(cache_arr: torch.Tensor, new_vals: torch.Tensor) -> torch.Tensor:
    """Write full-sequence values at position 0 of the cache, zeros after,
    in place."""
    t = new_vals.shape[1]
    cache_arr[:, :t] = new_vals
    cache_arr[:, t:] = 0
    return cache_arr


# ---------------------------------------------------------------------------
# the layer stack
# ---------------------------------------------------------------------------


def stack_init(rng, cfg: ModelConfig, cross=False) -> nn.ModuleList:
    """One block per layer, in layer order."""
    return nn.ModuleList([block_init(rng, cfg, spec, cross=cross)
                          for spec in cfg.layer_specs()])


def stack_apply(cfg: ModelConfig, ctx, layers, h, positions, mode,
                caches=None, length=None, enc_h=None):
    """Run the whole layer stack in segment order.  ``caches`` (the
    per-segment stacked buffers) is written in place.  Returns (h, caches,
    aux_sum)."""
    aux_tot = 0.0
    i = 0
    for si, (pattern, repeats) in enumerate(derive_segments(cfg)):
        for r in range(repeats):
            for j, spec in enumerate(pattern):
                cache = (None if caches is None
                         else {k: buf[r] for k, buf in caches[si][j].items()})
                h, _, aux = block_apply(cfg, ctx, spec, layers[i], h, positions,
                                        mode, cache, length, enc_h)
                aux_tot = aux_tot + aux
                i += 1
    return h, caches, aux_tot


def stack_cache_shapes(cfg: ModelConfig, batch: int, max_len: int,
                       cross_len: int = 0):
    """Stacked cache shape/dtype tree matching the reference's traversal."""
    out = []
    for pattern, repeats in derive_segments(cfg):
        seg = []
        for spec in pattern:
            shapes = block_cache_shapes(cfg, spec, batch, max_len, cross_len)
            seg.append({k: ((repeats,) + s, d) for k, (s, d) in shapes.items()})
        out.append(seg)
    return out
