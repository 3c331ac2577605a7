"""Public model API: init / prefill / decode_step / init_cache.

The port serves the language-model families whose blocks are GQA
attention with a dense or MoE FFN (``dense``, ``moe``).  Parameters are an
``nn.ModuleDict``: ``embed`` and ``final_norm`` (``nn.ParameterDict``) and
``layers``, one ``nn.ModuleDict`` block per layer (``models.transformer``),
float32 master weights on one device.  Caches are dicts: ``{"segs":
[per-segment stacked block buffers], "len": host int}``; ``prefill`` and
``decode_step`` write the buffers in place (the reference donates them)
and return the cache with its new length, so a decode step reads nothing
back from the device.

Still to port (``ROADMAP.md``, queue 1): the ``audio`` and ``vlm``
families, MLA with multi-token prediction (DeepSeek), the Mamba and RWKV
mixers, and ``train_loss``.
"""
from __future__ import annotations

import torch
from torch import nn

from ..core.device import resolve_device
from .config import ModelConfig
from .layers import (compute_dtype, embed_apply, embed_init, exact_products,
                     logits_apply, norm_apply, norm_init, sinusoidal_pos)
from .moe import count_moe_params
from .transformer import stack_apply, stack_cache_shapes, stack_init


def check_ported(cfg: ModelConfig) -> None:
    """Raise for the parts of a config the port does not run yet."""
    if cfg.family in ("audio", "vlm"):
        raise NotImplementedError(
            f"the {cfg.family} family ({cfg.name}) is not ported yet: it "
            "waits in ROADMAP.md, queue 1")
    if cfg.mtp_depth > 0:
        raise NotImplementedError(
            f"multi-token prediction (mtp_depth={cfg.mtp_depth}, {cfg.name}) "
            "is not ported yet: it waits for DeepSeek in ROADMAP.md, queue 1")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def init_params(rng, cfg: ModelConfig, device=None) -> nn.ModuleDict:
    """Random parameters of ``cfg`` on ``device`` (default CUDA, raising
    without a GPU; pass ``device="cpu"`` for the plain path), drawn from
    ``rng``: a ``torch.Generator`` on that device, or an int seed."""
    check_ported(cfg)
    device = resolve_device(device)
    if not isinstance(rng, torch.Generator):
        rng = torch.Generator(device=device).manual_seed(int(rng))
    elif rng.device.type != device.type:
        raise ValueError(f"generator on {rng.device}, parameters on {device}")
    return nn.ModuleDict({
        "embed": embed_init(rng, cfg),
        "layers": stack_init(rng, cfg),
        "final_norm": norm_init(cfg, device=device),
    })


def params_device(params) -> torch.device:
    return params["embed"]["tok"].device


# ---------------------------------------------------------------------------
# forward passes
# ---------------------------------------------------------------------------


def _embed_inputs(cfg: ModelConfig, ctx, params, batch):
    """Token embedding (and sinusoidal positions).  Returns (h, labels,
    positions)."""
    check_ported(cfg)
    h = embed_apply(cfg, params["embed"], batch["tokens"])
    labels = batch.get("labels")
    t = h.shape[1]
    positions = torch.arange(t, dtype=torch.int32, device=h.device).expand(h.shape[:2])
    if cfg.pos_emb == "sinusoidal":
        h = h + sinusoidal_pos(t, cfg.d_model, device=h.device).to(h.dtype)
    return ctx.act_btd(h), labels, positions


def forward(cfg: ModelConfig, ctx, params, batch, mode="train", caches=None):
    """Backbone forward.  Returns (h_final, labels, aux, caches, enc_h);
    ``enc_h`` is None (the encoder towers are not ported)."""
    h, labels, positions = _embed_inputs(cfg, ctx, params, batch)
    segs = caches["segs"] if caches is not None else None
    length = caches["len"] if caches is not None else None
    h, segs, aux = stack_apply(cfg, ctx, params["layers"], h, positions, mode,
                               segs, length)
    h = norm_apply(cfg, params["final_norm"], h)
    return h, labels, aux, segs, None


# ---------------------------------------------------------------------------
# serving: cache init / prefill / decode
# ---------------------------------------------------------------------------


def cache_shapes(cfg: ModelConfig, batch: int, max_len: int):
    """Shape/dtype tree of the decode cache, as the reference's."""
    cross_len = cfg.encoder.seq_len if cfg.encoder is not None else 0
    shapes = {"segs": stack_cache_shapes(cfg, batch, max_len, cross_len),
              "len": ((), torch.int32)}
    if cfg.encoder is not None:
        shapes["enc_h"] = ((batch, cfg.encoder.seq_len, cfg.d_model),
                           compute_dtype(cfg))
    return shapes


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device=None):
    """Zeroed buffers of :func:`cache_shapes` on ``device`` (default CUDA)
    and length 0."""
    check_ported(cfg)
    device = resolve_device(device)
    segs = [[{k: torch.zeros(s, dtype=dt, device=device) for k, (s, dt) in blk.items()}
             for blk in seg]
            for seg in cache_shapes(cfg, batch, max_len)["segs"]]
    return {"segs": segs, "len": 0}


@torch.no_grad()
def prefill(cfg: ModelConfig, ctx, params, batch, cache):
    """Fill the cache from a full prompt; returns (last-token logits, cache)."""
    with exact_products():
        h, _, _, segs, _ = forward(cfg, ctx, params, batch, mode="prefill",
                                   caches=cache)
        logits = logits_apply(cfg, ctx, params["embed"], h[:, -1:])
    return logits, {**cache, "segs": segs, "len": batch["tokens"].shape[1]}


@torch.no_grad()
def decode_step(cfg: ModelConfig, ctx, params, cache, tokens):
    """One decode step.  tokens (B, 1).  Returns (logits, cache)."""
    with exact_products():
        h, _, _, segs, _ = forward(cfg, ctx, params, {"tokens": tokens},
                                   mode="decode", caches=cache)
        logits = logits_apply(cfg, ctx, params["embed"], h)
    return logits, {**cache, "segs": segs, "len": cache["len"] + 1}


# ---------------------------------------------------------------------------
# analytic parameter count (6ND roofline term)
# ---------------------------------------------------------------------------


def count_params(cfg: ModelConfig) -> int:
    d = cfg.d_model
    norm_p = 2 * d if cfg.norm == "layernorm" else d

    def attn_params():
        if cfg.attention == "mla":
            m = cfg.mla
            dn, dr, dv = (m.qk_nope_head_dim, m.qk_rope_head_dim,
                          m.v_head_dim)
            t = d * m.q_lora_rank + m.q_lora_rank
            t += m.q_lora_rank * cfg.num_heads * (dn + dr)
            t += d * (m.kv_lora_rank + dr) + m.kv_lora_rank
            t += m.kv_lora_rank * cfg.num_heads * (dn + dv)
            t += cfg.num_heads * dv * d
            return t
        hd = cfg.head_dim_
        t = d * hd * (cfg.num_heads + 2 * cfg.num_kv_heads)
        t += cfg.num_heads * hd * d
        if cfg.qkv_bias:
            t += hd * (cfg.num_heads + 2 * cfg.num_kv_heads)
        return t

    def mlp_params():
        n_mats = 3 if cfg.mlp_gated else 2
        return n_mats * d * cfg.d_ff

    total = cfg.vocab_size * d
    if not cfg.tie_embeddings:
        total += cfg.vocab_size * d
    for spec in cfg.layer_specs():
        total += norm_p  # norm1
        if spec.mixer == "attn":
            total += attn_params()
            if cfg.encoder is not None:  # decoder cross-attention
                total += norm_p + attn_params()
        elif spec.mixer == "mamba":
            from .mamba import mamba_dims
            d_in, n, dt_rank = mamba_dims(cfg)
            total += d * 2 * d_in + cfg.mamba.d_conv * d_in + d_in
            total += d_in * (dt_rank + 2 * n) + dt_rank * d_in + d_in
            total += d_in * n + d_in + d_in * d
            total += dt_rank + 2 * n  # dt/b/c inner rmsnorms
        elif spec.mixer == "rwkv":
            total += 5 * d + 5 * d * d + 2 * d * cfg.rwkv.decay_lora
            total += 4 * d  # w_base, u, gn scale/bias
        total += norm_p  # norm2
        if spec.mixer == "rwkv":
            total += 2 * d + 2 * d * cfg.d_ff + d * d
        elif spec.moe:
            tot, _ = count_moe_params(cfg)
            total += tot
        else:
            total += mlp_params()
    total += norm_p  # final norm
    if cfg.encoder is not None:
        e = cfg.encoder
        per = attn_params() + mlp_params() + 2 * norm_p
        total += e.num_layers * per + norm_p
    if cfg.mtp_depth > 0:
        total += 2 * d * d + 2 * norm_p  # proj + norms
        total += attn_params() + mlp_params() + 2 * norm_p  # mtp block
        total += norm_p
    return int(total)


def count_active_params(cfg: ModelConfig) -> int:
    """Active (per-token) params -- the N in 6ND for MoE models."""
    if cfg.moe is None:
        return count_params(cfg)
    total = count_params(cfg)
    tot_moe, active_moe = count_moe_params(cfg)
    n_moe = sum(1 for s in cfg.layer_specs() if s.moe)
    return int(total - n_moe * (tot_moe - active_moe))
