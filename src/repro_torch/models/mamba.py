"""Mamba (selective SSM) mixer: its shapes.

The port has the shape functions, which ``count_params`` and
``cache_shapes`` read for every architecture; the mixer itself (the Jamba
hybrid's attention-free layer) is still to port (``ROADMAP.md``).
"""
from __future__ import annotations

from .config import MambaConfig, ModelConfig

_TODO = ("the Mamba mixer is not ported yet: it waits for the Jamba hybrid "
         "(ROADMAP.md, queue 1)")


def mamba_dims(cfg: ModelConfig):
    m: MambaConfig = cfg.mamba
    d_inner = m.expand * cfg.d_model
    return d_inner, m.d_state, cfg.dt_rank_


def mamba_state_shapes(cfg: ModelConfig, batch: int):
    m: MambaConfig = cfg.mamba
    d_in, n, _ = mamba_dims(cfg)
    return ((batch, m.d_conv - 1, d_in), (batch, d_in, n))


def mamba_init(rng, cfg: ModelConfig, device=None):
    raise NotImplementedError(_TODO)


def mamba_apply(cfg: ModelConfig, ctx, p, x, ssm_state=None, conv_state=None):
    raise NotImplementedError(_TODO)
