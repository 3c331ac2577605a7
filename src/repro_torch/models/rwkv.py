"""RWKV-6 time-mix and channel-mix: their shapes.

The port has the shape functions, which ``count_params`` and
``cache_shapes`` read for every architecture; the mixers themselves are
still to port (``ROADMAP.md``).
"""
from __future__ import annotations

from .config import ModelConfig, RWKVConfig

_TODO = "the RWKV mixers are not ported yet (ROADMAP.md, queue 1)"


def rwkv_heads(cfg: ModelConfig):
    r: RWKVConfig = cfg.rwkv
    if cfg.d_model % r.head_size:
        raise ValueError(f"d_model {cfg.d_model} is not a multiple of the RWKV "
                         f"head size {r.head_size}")
    return cfg.d_model // r.head_size, r.head_size


def rwkv_state_shapes(cfg: ModelConfig, batch: int):
    h, hs = rwkv_heads(cfg)
    return ((batch, cfg.d_model),  # time-mix shift state
            (batch, h, hs, hs),  # wkv state
            (batch, cfg.d_model))  # channel-mix shift state


def rwkv_time_init(rng, cfg: ModelConfig, device=None):
    raise NotImplementedError(_TODO)


def rwkv_channel_init(rng, cfg: ModelConfig, device=None):
    raise NotImplementedError(_TODO)


def rwkv_time_apply(cfg: ModelConfig, ctx, p, x, state=None, x_prev=None):
    raise NotImplementedError(_TODO)


def rwkv_channel_apply(cfg: ModelConfig, ctx, p, x, x_prev=None):
    raise NotImplementedError(_TODO)
