"""Wavefront BVH4 traversal: one batched datapath job stream per round.

The port's counterpart of ``repro/core/wavefront.py`` and the **plain
version of the fused traversal kernel** (``csrc/traverse.cu``): the CPU
path of ``QueryEngine.trace``, and what ``chip_smoke.py`` holds the
kernel against on the card.  Each round every active ray pops its stack
top, issues one OpQuadbox job on the node's 4 children and, at a
leaf-parent node, 4 OpTriangle jobs with the external divide; the best
hit commits under ``t < t_best``, ``t <= extent`` and ``t >= t_min``; hit
children are pushed farthest first, with drop-and-flag at ``stack_size``.

Three query types: ``"closest"``; ``"any"`` (a ray retires on its first
accepted hit); ``"shadow"`` (any-hit with a ``t_min`` epsilon).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .bvh import BVH4, DatapathConfig, child_boxes, level_offset, resolve_config
from .datapath import ray_box_test, ray_triangle_test
from .types import Ray, Triangle

RAY_TYPES = ("closest", "any", "shadow")

SHADOW_T_MIN = 1e-3  # default self-intersection epsilon for shadow rays


class WavefrontRecord(NamedTuple):
    """Per-ray results plus the batch-level round count."""

    t: torch.Tensor  # (R,) f32  hit distance (inf = miss)
    tri_index: torch.Tensor  # (R,) i32  index into the soup, -1 = miss
    hit: torch.Tensor  # (R,) bool
    quadbox_jobs: torch.Tensor  # (R,) i32  per-ray OpQuadbox jobs issued
    triangle_jobs: torch.Tensor  # (R,) i32  per-ray OpTriangle jobs issued
    stack_overflow: torch.Tensor  # (R,) bool  a push was dropped at capacity
    rounds: torch.Tensor  # ()   i32  batched rounds = max(quadbox_jobs)


def _tile_ray(rays: Ray, width: int) -> Ray:
    """(R,)-batched Ray -> (R, width)-batched Ray (shared across slots)."""
    return Ray(*[f.unsqueeze(1).expand((f.shape[0], width) + f.shape[1:])
                 for f in rays])


def _gather_triangles(tri: Triangle, idx: torch.Tensor) -> Triangle:
    safe = idx.clamp(min=0).long()
    return Triangle(a=tri.a[safe], b=tri.b[safe], c=tri.c[safe])


def default_t_min(ray_type: str) -> float:
    return SHADOW_T_MIN if ray_type == "shadow" else 0.0


def trace_wavefront(bvh: BVH4, rays: Ray, depth: int, ray_type: str = "closest",
                    t_min: float | None = None, max_rounds: int | None = None,
                    config: DatapathConfig | None = None) -> WavefrontRecord:
    """Traverse a whole ray batch with one batch-level loop.

    ``rays`` carry one leading batch axis.  ``max_rounds`` defaults to the
    internal-node count (each node is popped at most once per ray).
    ``t_min`` defaults to 0, and to :data:`SHADOW_T_MIN` for shadow rays.
    """
    if ray_type not in RAY_TYPES:
        raise ValueError(f"ray_type must be one of {RAY_TYPES}, got {ray_type!r}")
    if t_min is None:
        t_min = default_t_min(ray_type)
    config = resolve_config(config)
    arity, stack_size = config.arity, config.stack_size
    leaf_parent_offset = level_offset(depth - 1, arity)
    leaf_offset = level_offset(depth, arity)
    if max_rounds is None:
        max_rounds = level_offset(depth, arity)

    dev = rays.origin.device
    n = rays.origin.shape[0]
    n_leaf = bvh.leaf_tri.shape[0]
    rows = torch.arange(n, device=dev)
    slots = torch.arange(arity, device=dev)
    t_min_t = torch.tensor(t_min, dtype=torch.float32, device=dev)
    inf = float("inf")

    stack = torch.zeros((n, stack_size), dtype=torch.int32, device=dev)
    sp = torch.ones((n,), dtype=torch.int32, device=dev)  # root pre-pushed
    t_best = torch.full((n,), inf, dtype=torch.float32, device=dev)
    best_tri = torch.full((n,), -1, dtype=torch.int32, device=dev)
    n_qb = torch.zeros((n,), dtype=torch.int32, device=dev)
    n_tri = torch.zeros((n,), dtype=torch.int32, device=dev)
    overflow = torch.zeros((n,), dtype=torch.bool, device=dev)
    done = torch.zeros((n,), dtype=torch.bool, device=dev)
    rounds = 0
    tiled = _tile_ray(rays, arity)

    while rounds < max_rounds:
        active = (sp > 0) & ~done
        if not bool(active.any()):
            break

        # frontier pop (masked: retired rays contribute no jobs)
        top = stack[rows, (sp - 1).clamp(min=0).long()]
        node = torch.where(active, top, torch.zeros_like(top))
        sp = torch.where(active, sp - 1, sp)
        is_leaf_parent = node >= leaf_parent_offset

        # one batched box-test job over the whole frontier
        qb = ray_box_test(rays, child_boxes(bvh, node, arity))

        # batched OpTriangle round for the leaf-parent rays
        leaf_pos = (arity * node.long()[:, None] + 1 - leaf_offset + slots)
        leaf_pos = leaf_pos.clamp(0, n_leaf - 1)
        tri_idx = bvh.leaf_tri[leaf_pos]  # (R, arity), -1 = padded leaf
        tr = ray_triangle_test(tiled, _gather_triangles(bvh.triangles, tri_idx))
        t = tr.t_num / tr.t_denom  # the external divide
        valid = (tr.hit & (tri_idx >= 0) & (t < t_best[:, None])
                 & (t <= rays.extent[:, None]) & (t >= t_min_t))
        t_masked = torch.where(valid, t, torch.full_like(t, inf))
        j = torch.argmin(t_masked, dim=1)  # first minimum
        leaf_t = t_masked[rows, j]
        leaf_better = active & is_leaf_parent & (leaf_t < t_best)
        t_best = torch.where(leaf_better, leaf_t, t_best)
        best_tri = torch.where(leaf_better, tri_idx[rows, j], best_tri)
        if ray_type != "closest":  # any-hit: retire on the first commit
            done = done | leaf_better

        # push hit children farthest first, so the nearest ends on top
        for i in range(arity):
            slot = arity - 1 - i
            ok = (active & ~is_leaf_parent & qb.is_intersect[:, slot]
                  & (qb.tmin[:, slot] < t_best))
            child = arity * node + 1 + qb.box_index[:, slot]
            can = ok & (sp < stack_size)  # drop-and-flag at capacity
            overflow = overflow | (ok & (sp >= stack_size))
            pos = sp.clamp(max=stack_size - 1).long()
            stack[rows, pos] = torch.where(can, child, stack[rows, pos])
            sp = torch.where(can, sp + 1, sp)

        n_qb = n_qb + active.to(torch.int32)
        n_tri = n_tri + torch.where(active & is_leaf_parent,
                                    torch.full_like(n_tri, arity),
                                    torch.zeros_like(n_tri))
        rounds += 1

    return WavefrontRecord(t=t_best, tri_index=best_tri, hit=best_tri >= 0,
                           quadbox_jobs=n_qb, triangle_jobs=n_tri,
                           stack_overflow=overflow,
                           rounds=torch.tensor(rounds, dtype=torch.int32,
                                               device=dev))


def occlusion_test(bvh: BVH4, rays: Ray, depth: int,
                   t_min: float = SHADOW_T_MIN) -> torch.Tensor:
    """Is anything hit within each ray's extent (the shadow query)?"""
    return trace_wavefront(bvh, rays, depth, ray_type="shadow", t_min=t_min).hit
