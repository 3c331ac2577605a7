"""Shared neural layers: norms, RoPE, embeddings, MLPs.

The reference's functional style, on tensors: ``*_init(rng, cfg, ...)``
returns an ``nn.ParameterDict`` of float32 master weights (the reference's
``param_dtype``) drawn from a ``torch.Generator`` on its device, and
``*_apply(..., p, x)`` reads ``p[name]`` the way the reference reads its
dict, so a plain dict of tensors serves as well.  Compute runs in the
activations' dtype (``cfg.compute_dtype``, bf16 by default) with f32
statistics in the norms.  ``lm_loss`` waits for the training slice.
"""
from __future__ import annotations

import contextlib
import math
import threading

import torch
import torch.nn.functional as F
from torch import nn

from .config import ModelConfig

# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------


def dense_init(rng: torch.Generator, shape, in_axis=0, scale=1.0) -> nn.Parameter:
    """Fan-in scaled truncated normal: N(0, 1) cut at +-2, times
    ``scale / sqrt(fan_in)``; float32 on the generator's device."""
    fan_in = (shape[in_axis] if isinstance(in_axis, int)
              else math.prod(shape[a] for a in in_axis))
    std = scale / math.sqrt(max(fan_in, 1))
    w = torch.empty(shape, dtype=torch.float32, device=rng.device)
    nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=rng)
    return nn.Parameter(w.mul_(std))


def ones(d: int, device) -> nn.Parameter:
    return nn.Parameter(torch.ones((d,), dtype=torch.float32, device=device))


def zeros(shape, device) -> nn.Parameter:
    return nn.Parameter(torch.zeros(shape, dtype=torch.float32, device=device))


def cast(w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """A weight in the compute dtype (the reference's ``.astype(dt)``)."""
    return w if w.dtype == dtype else w.to(dtype)


def compute_dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.compute_dtype)


_exact_lock = threading.Lock()
_exact_depth = 0
_exact_saved = None


@contextlib.contextmanager
def exact_products():
    """Matrix products on the card as the reference computes them: float32
    products without TF32 (``Precision.HIGHEST``) and bf16 products
    reduced in float32.

    The two settings are process-wide.  The first caller to enter saves
    them and the last to leave restores them, so threads that serve at
    once all keep exact products until the last of them is done; code that
    runs meanwhile outside this context, in any thread, sees them off."""
    global _exact_depth, _exact_saved
    m = torch.backends.cuda.matmul
    with _exact_lock:
        if _exact_depth == 0:
            _exact_saved = m.allow_tf32, m.allow_bf16_reduced_precision_reduction
            m.allow_tf32 = m.allow_bf16_reduced_precision_reduction = False
        _exact_depth += 1
    try:
        yield
    finally:
        with _exact_lock:
            _exact_depth -= 1
            if _exact_depth == 0:
                m.allow_tf32, m.allow_bf16_reduced_precision_reduction = _exact_saved


# ---------------------------------------------------------------------------
# normalization
# ---------------------------------------------------------------------------


def norm_init(cfg: ModelConfig, d=None, *, device=None) -> nn.ParameterDict:
    d = d or cfg.d_model
    p = nn.ParameterDict({"scale": ones(d, device)})
    if cfg.norm == "layernorm":
        p["bias"] = zeros((d,), device)
    return p


def norm_apply(cfg: ModelConfig, p, x: torch.Tensor, eps=1e-5) -> torch.Tensor:
    xf = x.float()
    if cfg.norm == "layernorm":
        mu = xf.mean(-1, keepdim=True)
        var = ((xf - mu) ** 2).mean(-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]
    else:  # rmsnorm
        ms = (xf * xf).mean(-1, keepdim=True)
        y = xf * torch.rsqrt(ms + eps) * p["scale"]
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# rotary / sinusoidal positions
# ---------------------------------------------------------------------------


def _rot(cfg: ModelConfig, head_dim: int) -> int:
    return int(head_dim * cfg.rope_fraction) // 2 * 2


def rope_freqs(cfg: ModelConfig, head_dim: int, device=None) -> torch.Tensor:
    """Inverse frequencies for the rotated sub-dimension."""
    rot = _rot(cfg, head_dim)
    return 1.0 / (cfg.rope_theta ** (
        torch.arange(0, rot, 2, dtype=torch.float32, device=device) / rot))


def apply_rope(cfg: ModelConfig, x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """Rotate the first ``rope_fraction`` of head_dim; pass the rest through.

    x: (B, T, H, hd); positions: (B, T) or (T,).  Pairs are interleaved
    (``0::2`` with ``1::2``), not the half-split ``rotate_half`` form;
    ``rope_fraction=0.5`` is ChatGLM's 2d/partial rotary, ``1.0`` the
    llama-family full rotary.
    """
    hd = x.shape[-1]
    rot = _rot(cfg, hd)
    if rot == 0:
        return x
    inv = rope_freqs(cfg, hd, device=x.device)
    ang = positions.float()[..., None] * inv  # (..., T, rot/2)
    if ang.ndim == 2:  # (T, r) -> broadcast batch
        ang = ang[None]
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    xr = x[..., :rot].float()
    x1, x2 = xr[..., 0::2], xr[..., 1::2]
    r1 = x1 * cos - x2 * sin
    r2 = x2 * cos + x1 * sin
    rotated = torch.stack([r1, r2], dim=-1).reshape(x.shape[:-1] + (rot,))
    return torch.cat([rotated.to(x.dtype), x[..., rot:]], dim=-1)


def sinusoidal_pos(length: int, d_model: int, device=None) -> torch.Tensor:
    """Whisper-style fixed sinusoidal embeddings (length, d_model)."""
    half = d_model // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(
        half, dtype=torch.float32, device=device) / max(half - 1, 1))
    args = (torch.arange(length, dtype=torch.float32, device=device)[:, None]
            * freqs[None, :])
    return torch.cat([torch.sin(args), torch.cos(args)], dim=-1)


# ---------------------------------------------------------------------------
# MLP (gated SwiGLU or plain)
# ---------------------------------------------------------------------------


def mlp_init(rng, cfg: ModelConfig, d_ff=None) -> nn.ParameterDict:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    p = nn.ParameterDict({"wi": dense_init(rng, (d, f)),
                          "wo": dense_init(rng, (f, d))})
    if cfg.mlp_gated:
        p["wg"] = dense_init(rng, (d, f))
    return p


def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu`` as the reference computes it: x * (1 / (1 + exp(-x))),
    each op rounded to ``x``'s dtype (in bf16, ``F.silu`` rounds once and
    differs from it in the last bit)."""
    return x * (1 / (1 + torch.exp(-x)))


def _act(cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    if cfg.act == "silu":
        return silu(x)
    if cfg.act == "gelu":  # jax.nn.gelu's default is the tanh form
        return F.gelu(x, approximate="tanh")
    if cfg.act == "relu_sq":
        r = F.relu(x)
        return r * r
    raise ValueError(cfg.act)


def mlp_apply(cfg: ModelConfig, ctx, p, x: torch.Tensor) -> torch.Tensor:
    dt = x.dtype
    h = x @ cast(p["wi"], dt)
    if cfg.mlp_gated:
        h = _act(cfg, x @ cast(p["wg"], dt)) * h
    else:
        h = _act(cfg, h)
    h = ctx.act_btf(h)
    return h @ cast(p["wo"], dt)


# ---------------------------------------------------------------------------
# embeddings
# ---------------------------------------------------------------------------


def embed_init(rng, cfg: ModelConfig) -> nn.ParameterDict:
    p = nn.ParameterDict({"tok": dense_init(rng, (cfg.vocab_size, cfg.d_model),
                                            in_axis=1)})
    if not cfg.tie_embeddings:
        p["unembed"] = dense_init(rng, (cfg.d_model, cfg.vocab_size))
    return p


def embed_apply(cfg: ModelConfig, p, tokens: torch.Tensor) -> torch.Tensor:
    # rows first, then the cast: the reference casts the whole table, which
    # gives the same values
    return p["tok"][tokens].to(compute_dtype(cfg))


def unembed_matrix(cfg: ModelConfig, p) -> torch.Tensor:
    return p["tok"].T if cfg.tie_embeddings else p["unembed"]


def logits_apply(cfg: ModelConfig, ctx, p, h: torch.Tensor) -> torch.Tensor:
    w = cast(unembed_matrix(cfg, p), h.dtype)
    return ctx.act_btv(h @ w)
