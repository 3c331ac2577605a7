"""Mamba (selective SSM) mixer: the Jamba hybrid's attention-free layer.

The recurrence h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t is diagonal over
(d_inner, d_state), so it runs as a log-depth associative scan within
time chunks of ``cfg.mamba.chunk`` steps, with a (B, d_inner, d_state)
float32 carry passed from chunk to chunk.  The scan within a chunk is the
odd/even recursion of ``jax.lax.associative_scan``, written out, so that
its products associate as the reference's do; a closed form (``cumprod``
of the decays, a divide) would underflow.  Each chunk holds a handful of
(B, chunk, d_inner, d_state) float32 tensors at once: 1.07 GB each at
Jamba-1.5-Large's full width, batch 8 and chunk 128.

Jamba's details, as the reference has them: RMSNorms on the dt / B / C
projections, a silu-gated output, a causal depthwise conv1d front end
(``d_conv`` taps), softplus dt with a learned bias, S4D-real A init.  The
scan is plain PyTorch: the reference's is plain JAX, no Pallas kernel.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .config import MambaConfig, ModelConfig
from .layers import cast, dense_init, norm_apply, ones, silu, zeros


def mamba_dims(cfg: ModelConfig):
    m: MambaConfig = cfg.mamba
    d_inner = m.expand * cfg.d_model
    return d_inner, m.d_state, cfg.dt_rank_


def mamba_state_shapes(cfg: ModelConfig, batch: int):
    m: MambaConfig = cfg.mamba
    d_in, n, _ = mamba_dims(cfg)
    return ((batch, m.d_conv - 1, d_in), (batch, d_in, n))


def mamba_init(rng: torch.Generator, cfg: ModelConfig) -> nn.ParameterDict:
    """The reference's parameter dict, float32 on the generator's device;
    the dt / B / C norms each a dict of one ``scale``."""
    m: MambaConfig = cfg.mamba
    d = cfg.d_model
    d_in, n, dt_rank = mamba_dims(cfg)
    dev = rng.device
    # S4D-real A init: A[d, n] = -(1..n)
    a = torch.arange(1, n + 1, dtype=torch.float32, device=dev).repeat(d_in, 1)
    # softplus^-1(0.01)
    dt_bias = torch.log(torch.expm1(torch.full((d_in,), 0.01, dtype=torch.float32,
                                               device=dev)))
    return nn.ParameterDict({
        "in_proj": dense_init(rng, (d, 2 * d_in)),
        "conv_w": dense_init(rng, (m.d_conv, d_in), in_axis=0),
        "conv_b": zeros((d_in,), dev),
        "x_proj": dense_init(rng, (d_in, dt_rank + 2 * n)),
        "dt_proj": dense_init(rng, (dt_rank, d_in), scale=dt_rank ** -0.5),
        "dt_bias": nn.Parameter(dt_bias),
        "a_log": nn.Parameter(torch.log(a)),
        "d_skip": ones(d_in, dev),
        "out_proj": dense_init(rng, (d_in, d)),
        "dt_norm": nn.ParameterDict({"scale": ones(dt_rank, dev)}),
        "b_norm": nn.ParameterDict({"scale": ones(n, dev)}),
        "c_norm": nn.ParameterDict({"scale": ones(n, dev)}),
    })


def _conv1d(p, x: torch.Tensor, conv_state=None):
    """Causal depthwise conv over time.  x (B, T, Din); state (B, K-1, Din).

    Returns (y, new_state): the taps summed in order in ``x``'s dtype, and
    the last K-1 rows of the padded input (before any activation)."""
    k = p["conv_w"].shape[0]
    if conv_state is None:
        xp = F.pad(x, (0, 0, k - 1, 0))
    else:
        xp = torch.cat([conv_state.to(x.dtype), x], dim=1)
    t = x.shape[1]
    w = cast(p["conv_w"], x.dtype)
    y = sum(xp[:, i:i + t] * w[i] for i in range(k))
    new_state = xp[:, xp.shape[1] - (k - 1):]
    return y + cast(p["conv_b"], x.dtype), new_state


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus`` (``logaddexp(x, 0)``) as the reference computes
    it: max(x, 0) + log1p(exp(-|x|)), each op rounded to ``x``'s dtype."""
    return torch.clamp_min(x, 0) + torch.log1p(torch.exp(-x.abs()))


def _ssm_params(cfg: ModelConfig, p, xc: torch.Tensor):
    """From conv'd activations to (dt, B, C), float32, with Jamba's inner
    RMSNorms; the norms and the softplus run in ``xc``'s dtype."""
    _, n, dt_rank = mamba_dims(cfg)
    x_dbc = xc @ cast(p["x_proj"], xc.dtype)
    dt = norm_apply(cfg, p["dt_norm"], x_dbc[..., :dt_rank])
    b = norm_apply(cfg, p["b_norm"], x_dbc[..., dt_rank:dt_rank + n])
    c = norm_apply(cfg, p["c_norm"], x_dbc[..., dt_rank + n:])
    dt = _softplus(dt @ cast(p["dt_proj"], dt.dtype) + cast(p["dt_bias"], dt.dtype))
    return dt.float(), b.float(), c.float()


def _combine(left, right):
    """The scan's operator on (decay, state) pairs: h = a2 (a1 h + m1) + m2."""
    (a1, m1), (a2, m2) = left, right
    return a1 * a2, a2 * m1 + m2


def _associative_scan(elems, dim: int = 1):
    """Inclusive scan of :func:`_combine` along ``dim``: the odd/even
    recursion of ``jax.lax.associative_scan``, so each output is the
    reference's product tree."""
    n = elems[0].shape[dim]
    if n < 2:
        return elems

    def sl(x, start, stop=None, step=1):
        return x[(slice(None),) * dim + (slice(start, stop, step),)]

    # adjacent pairs combined and scanned by recursion: the odd outputs
    odd = _associative_scan(_combine([sl(e, 0, n - 1, 2) for e in elems],
                                     [sl(e, 1, None, 2) for e in elems]), dim)
    # the even outputs past the first: an odd output and the next element
    even = _combine([sl(o, 0, -1) for o in odd] if n % 2 == 0 else odd,
                    [sl(e, 2, None, 2) for e in elems])
    out = []
    for e, ev, od in zip(elems, even, odd):
        r = torch.empty_like(e)
        sl(r, 0, 1).copy_(sl(e, 0, 1))
        sl(r, 2, None, 2).copy_(ev)
        sl(r, 1, None, 2).copy_(od)
        out.append(r)
    return out


def _chunk_scan(a_c, bx_c, h0):
    """Associative scan within one chunk.

    a_c, bx_c: (B, c, Din, N); h0: (B, Din, N).  Returns (h_all (B, c,
    Din, N), h_end); h_t = a_t h_{t-1} + bx_t."""
    a_cum, m_cum = _associative_scan([a_c, bx_c])
    h_all = a_cum.mul_(h0[:, None]).add_(m_cum)
    return h_all, h_all[:, -1]


def selective_scan(cfg: ModelConfig, dt, b, c, xc, p, h0=None):
    """The selective SSM.  dt (B, T, Din) f32, b / c (B, T, N) f32, xc
    (B, T, Din).  Returns (y (B, T, Din) f32, h_end (B, Din, N) f32)."""
    m: MambaConfig = cfg.mamba
    bsz, t, d_in = dt.shape
    n = b.shape[-1]
    a = -torch.exp(p["a_log"].float())  # (Din, N)
    if h0 is None:
        h0 = dt.new_zeros((bsz, d_in, n))

    chunk = min(m.chunk, t)
    # zero-padded to whole chunks: dt = 0 there gives a = 1 and bx = 0, so
    # the carry leaves the last chunk as the state at the last real step
    pad = -(-t // chunk) * chunk - t
    xp = xc
    if pad:
        dt, b, c, xp = (F.pad(z, (0, 0, 0, pad)) for z in (dt, b, c, xc))
    h, parts = h0, []
    for lo in range(0, t + pad, chunk):
        dt_c, b_c, c_c = dt[:, lo:lo + chunk], b[:, lo:lo + chunk], c[:, lo:lo + chunk]
        x_c = xp[:, lo:lo + chunk].float()
        a_c = (dt_c[..., None] * a).exp_()  # (B, c, Din, N): exp(dt A)
        bx_c = (dt_c * x_c)[..., None] * b_c[:, :, None, :]  # dt B x
        h_all, h = _chunk_scan(a_c, bx_c, h)
        del a_c, bx_c
        parts.append(torch.einsum("bcdn,bcn->bcd", h_all, c_c))  # y = C h
        h = h.clone()  # the carry, apart from the chunk's tensors
        del h_all
    y = torch.cat(parts, dim=1)[:, :t] + xc.float() * p["d_skip"]
    return y, h


def mamba_apply(cfg: ModelConfig, ctx, p, x, ssm_state=None, conv_state=None):
    """Full-sequence Mamba mixer.  x (B, T, D) -> (y, (conv_state, ssm_state))."""
    dt_ = x.dtype
    xz = x @ cast(p["in_proj"], dt_)  # (B, T, 2 Din)
    d_in = xz.shape[-1] // 2
    x_in = ctx.act_btf(xz[..., :d_in])
    z = ctx.act_btf(xz[..., d_in:])
    xc, conv_state = _conv1d(p, x_in, conv_state)
    xc = silu(xc)
    dt, b, c = _ssm_params(cfg, p, xc)
    # the scan is a time recurrence: its operands keep the whole sequence
    dt = ctx.act_recurrent(dt, ctx.model_axis)
    xc = ctx.act_recurrent(xc, ctx.model_axis)
    b = ctx.act_recurrent(b)
    c = ctx.act_recurrent(c)
    y, h_end = selective_scan(cfg, dt, b, c, xc, p, ssm_state)
    y = ctx.act_recurrent(y, ctx.model_axis)
    y = ctx.act_btf(y.to(dt_) * silu(z))
    return y @ cast(p["out_proj"], dt_), (conv_state, h_end)


def mamba_decode(cfg: ModelConfig, ctx, p, x, conv_state, ssm_state):
    """One token.  x (B, 1, D); conv_state (B, K-1, Din) in the compute
    dtype; ssm_state (B, Din, N) f32.  Returns (y, conv_state, ssm_state)."""
    y, (conv_state, h) = mamba_apply(cfg, ctx, p, x, ssm_state=ssm_state,
                                     conv_state=conv_state)
    return y, conv_state, h
