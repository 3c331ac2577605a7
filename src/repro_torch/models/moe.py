"""Mixture-of-Experts block with the datapath's angular mode as the router.

Router scores between token activations and expert embeddings are the
paper's **OpAngular** jobs (DESIGN.md §4): the router builds the port's
:class:`~repro_torch.core.session.VectorIndex` over the expert table, whose
``||e||^2`` norms the norm kernel (``csrc/distance.cu``) computes on the
card, and takes its ``dots`` (or, with ``router_metric="cosine"``, its
cosine epilogue, which reads those norms).

Dispatch is the reference's capacity gather: each (token, choice) takes the
next slot of its expert in token-major order, a choice past the expert's
capacity ``C`` is dropped (GShard semantics), the kept tokens are gathered
into an (E, C, D) block, run through their experts' gated MLPs, weighted
and added back onto each token in the reference's (expert, slot) order
(:func:`moe_combine`).  Expert parallelism over a mesh is still to port.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..core.knn import key_value, order_key, topk_keys
from ..core.session import VectorIndex
from .config import ModelConfig, MoEConfig
from .layers import cast, dense_init, silu


def moe_init(rng, cfg: ModelConfig) -> nn.ParameterDict:
    m: MoEConfig = cfg.moe
    d, f, e = cfg.d_model, m.d_ff_expert, m.num_experts
    p = nn.ParameterDict({
        # router: expert embeddings -- the OpAngular "candidate points"
        "router": dense_init(rng, (e, d), in_axis=1),
        "wi": dense_init(rng, (e, d, f), in_axis=1),
        "wg": dense_init(rng, (e, d, f), in_axis=1),
        "wo": dense_init(rng, (e, f, d), in_axis=1),
    })
    if m.num_shared:
        p["shared_wi"] = dense_init(rng, (d, f * m.num_shared))
        p["shared_wg"] = dense_init(rng, (d, f * m.num_shared))
        p["shared_wo"] = dense_init(rng, (f * m.num_shared, d))
    return p


def router_scores(m: MoEConfig, x_flat: torch.Tensor, router_w: torch.Tensor):
    """Datapath OpAngular jobs: scores[n, e] = x_n . router_e (or cosine).

    The expert table is a :class:`VectorIndex` built per call on the
    table's device; building it computes ``||e||^2`` (the norm kernel on a
    CUDA device), which the cosine epilogue reads."""
    index = VectorIndex.from_database(router_w.float(), device=router_w.device)
    queries = x_flat.float()
    if m.router_metric == "cosine":
        return index.cosine_similarity(queries)
    return index.dots(queries)


def router_topk(m: MoEConfig, scores: torch.Tensor):
    """Top-k gating.  Returns (weights (N,k) f32, experts (N,k), aux_loss).

    Ties rank as in ``jax.lax.top_k``: equal probabilities in ascending
    expert order (``core/knn.topk_keys`` over IEEE order keys)."""
    n, e = scores.shape
    if m.router == "sigmoid":  # deepseek-v3 gating
        probs = torch.sigmoid(scores)
        keys, idx = topk_keys(order_key(probs), m.top_k)
        w = key_value(keys)
        w = w / torch.clamp_min(w.sum(-1, keepdim=True), 1e-20) * m.route_scale
        full = probs / torch.clamp_min(probs.sum(-1, keepdim=True), 1e-20)
    else:
        probs = torch.softmax(scores, dim=-1)
        keys, idx = topk_keys(order_key(probs), m.top_k)
        w = key_value(keys)
        full = probs
    # Switch-style load-balance loss: E * sum_e f_e * P_e.  The counts by a
    # scatter-add, which (unlike bincount) needs no device-to-host sync
    counts = torch.zeros(e, dtype=torch.float32, device=idx.device).scatter_add_(
        0, idx.reshape(-1), torch.ones(idx.numel(), dtype=torch.float32,
                                       device=idx.device))
    f_e = counts / max(n * m.top_k, 1)
    p_e = full.mean(0)
    aux = e * torch.sum(f_e * p_e)
    return w, idx, aux


def _expert_ffn(cfg: ModelConfig, wi, wg, wo, xs):
    """xs (E, C, D) through each expert's gated MLP."""
    dt = xs.dtype
    h = torch.bmm(xs, cast(wi, dt))
    g = torch.bmm(xs, cast(wg, dt))
    h = silu(g) * h
    return torch.bmm(h, cast(wo, dt))


def moe_dispatch(n: int, weights, experts, e_loc: int, expert_offset: int,
                 capacity: int):
    """The capacity-gather bookkeeping of :func:`moe_local`.

    Returns ``table`` (E_loc, C) int64 of token ids (``n`` pads an empty
    slot), ``gather_w`` (E_loc, C) f32 of their gate weights, and ``src``
    (N*k,) int64: where each (token, choice), token-major, went in the
    flattened table, or ``E_loc * C`` where it was dropped (out of range or
    past its expert's capacity)."""
    k = experts.shape[1]
    flat_e = experts.reshape(-1)
    local = flat_e - expert_offset
    in_range = (local >= 0) & (local < e_loc)
    local = torch.where(in_range, local, 0)
    # slot of each (token, choice) within its expert: a running count of
    # the earlier choices of that expert, token-major
    onehot = F.one_hot(local, e_loc) * in_range[:, None]
    slot = (torch.cumsum(onehot, dim=0) - 1).gather(1, local[:, None])[:, 0]
    keep = in_range & (slot < capacity)
    src = torch.where(keep, local * capacity + slot, e_loc * capacity)
    table = torch.full((e_loc * capacity + 1,), n, dtype=torch.int64,
                       device=experts.device)
    gather_w = torch.zeros((e_loc * capacity + 1,), dtype=torch.float32,
                           device=experts.device)
    # kept (expert, slot) pairs are distinct; every dropped pair writes the
    # spare last entry, which is cut off (the reference's mode="drop")
    table[src] = torch.arange(n * k, device=experts.device) // k
    gather_w[src] = weights.reshape(-1).float()
    return (table[:-1].reshape(e_loc, capacity),
            gather_w[:-1].reshape(e_loc, capacity), src)


def moe_combine(flat: torch.Tensor, src: torch.Tensor, n: int, k: int) -> torch.Tensor:
    """The combine of :func:`moe_local`: ``flat`` (E_loc * C + 1, D) holds
    the gated expert outputs slot by slot, then a zero row that dropped
    choices read; ``src`` (N*k,) is :func:`moe_dispatch`'s.  Each token's
    kept contributions are added onto 0 in ascending (expert, slot) order,
    the order of the reference's scatter-add over its (E_loc, C) table; a
    token's dropped choices (``src = E_loc * C``) sort last and add +0.
    One gather-add per choice rank, no atomics, so the card gives the same
    bits on every run."""
    order = src.view(n, k).sort(dim=1).values
    out = flat.new_zeros((n, flat.shape[1]))
    for j in range(k):
        out += flat[order[:, j]]
    return out


def moe_local(cfg: ModelConfig, x_flat, weights, experts, wi, wg, wo,
              expert_offset: int, capacity: int):
    """Capacity-gather MoE over a local expert slice [offset, offset+E_loc).

    x_flat (N, D); weights/experts (N, k); expert weights (E_loc, D, F) etc.
    Returns (N, D), the contributions of the local experts, combined as
    :func:`moe_combine` adds them."""
    n, d = x_flat.shape
    table, gather_w, src = moe_dispatch(n, weights, experts, wi.shape[0],
                                        expert_offset, capacity)
    x_pad = torch.cat([x_flat, x_flat.new_zeros((1, d))], 0)
    xs = x_pad[table]  # (E_loc, C, D)
    ys = _expert_ffn(cfg, wi, wg, wo, xs)
    # the gated outputs, slot by slot, and the zero row of the drops
    flat = torch.cat([ys.reshape(-1, d), ys.new_zeros((1, d))])
    del ys
    flat[:-1] *= gather_w.reshape(-1, 1).to(flat.dtype)
    return moe_combine(flat, src, n, experts.shape[1])


def moe_apply(cfg: ModelConfig, ctx, p, x):
    """Full MoE block.  x (B, T, D) -> (y (B, T, D), aux_loss)."""
    m: MoEConfig = cfg.moe
    b, t, d = x.shape
    x_flat = x.reshape(b * t, d)

    scores = router_scores(m, x_flat, p["router"])  # OpAngular jobs
    weights, experts, aux = router_topk(m, scores)
    y = moe_local(cfg, x_flat, weights, experts, p["wi"], p["wg"], p["wo"], 0,
                  _capacity(m, x_flat.shape[0]))

    if m.num_shared:
        dt = x_flat.dtype
        h = x_flat @ cast(p["shared_wi"], dt)
        g = x_flat @ cast(p["shared_wg"], dt)
        y = y + (silu(g) * h) @ cast(p["shared_wo"], dt)
    return y.reshape(b, t, d).to(x.dtype), aux


def _capacity(m: MoEConfig, n_tokens: int) -> int:
    per = n_tokens * m.top_k / m.num_experts * m.capacity_factor
    return max(8, -(-int(per) // 8) * 8)


def _moe_ep(cfg: ModelConfig, ctx, p, x_flat, weights, experts):
    raise NotImplementedError("expert parallelism needs a mesh: it waits for "
                              "parallel/* on DeviceMesh (ROADMAP.md)")


def count_moe_params(cfg: ModelConfig) -> tuple[int, int]:
    """(total, active-per-token) params of one MoE block (excl. router)."""
    m = cfg.moe
    per_expert = 3 * cfg.d_model * m.d_ff_expert
    total = m.num_experts * per_expert + m.num_experts * cfg.d_model
    shared = m.num_shared * 3 * cfg.d_model * m.d_ff_expert
    active = m.top_k * per_expert + shared
    return total + shared, active
