"""Traversal-backed neighbour search: kNN / radius queries on the BVH walk.

The port's counterpart of ``repro/core/neighbor.py`` and the **plain
version of the fused neighbour kernel** (``csrc/neighbor.cu``): the CPU
path of the tree backends, and what ``chip_smoke.py`` holds the kernel
against on the card.  Each database point is an AABB-per-point leaf of an
ordinary :class:`~repro_torch.core.bvh.BVH4`
(:func:`~repro_torch.core.build.points.build_point_bvh`); a query is a
ray whose ``extent`` is the search radius (:func:`point_queries`); a
round pops each active query's stack top, orders the node's children by
box distance (:func:`~repro_torch.core.datapath.point_box_test`), and at
a leaf parent scores its 4 candidate points (:func:`leaf_dist_sq`) and
folds them into a sorted top-k list (:func:`insert_sorted`).

The leaf test reuses the brute-force scoring form term for term, so the
in-radius decision is the oracle's own kind of float comparison; node
pruning uses geometric box distance with a conservative slack
(:data:`PRUNE_SLACK`).  Every sum over the 3 axes is written out as
``(x + y) + z`` so that the kernel can repeat it bit for bit.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .bvh import BVH4, child_boxes, level_offset
from .datapath import fmin, point_box_test
from .device import resolve_device
from .traversal import STACK_SIZE
from .types import Ray, as_f32, make_ray

NEIGHBOR_MODES = ("within", "nearest")

#: relative + scaled-absolute slack on the node-pruning bound (see
#: ``repro/core/neighbor.py``): ``bound = b*(1+S) + S*||q||^2``
PRUNE_SLACK = 1e-5


class NeighborRecord(NamedTuple):
    """Per-query results plus the frontier-level scheduling statistics."""

    dist_sq: torch.Tensor  # (R, k) f32 squared distances, ascending, inf pad
    index: torch.Tensor  # (R, k) i32 database indices, -1 pad
    valid: torch.Tensor  # (R, k) bool slot holds a real neighbour
    count: torch.Tensor  # (R,) i32 exact in-radius count
    box_jobs: torch.Tensor  # (R,) i32 per-query point-box jobs issued
    point_jobs: torch.Tensor  # (R,) i32 per-query point-distance jobs issued
    rounds: torch.Tensor  # ()   i32 batched rounds (= max box_jobs)


def empty_neighbors(k: int, device) -> NeighborRecord:
    """The typed record of an empty query batch."""
    z = torch.zeros((0,), dtype=torch.int32, device=device)
    return NeighborRecord(
        dist_sq=torch.zeros((0, k), dtype=torch.float32, device=device),
        index=torch.zeros((0, k), dtype=torch.int32, device=device),
        valid=torch.zeros((0, k), dtype=torch.bool, device=device), count=z,
        box_jobs=z, point_jobs=z,
        rounds=torch.zeros((), dtype=torch.int32, device=device))


def point_queries(points, radius=None, *, device=None) -> Ray:
    """Wrap query points as extent-limited rays on ``device`` (default
    CUDA, raising without a GPU): a dummy +x direction, and the radius as
    ``extent`` (inf for unbounded kNN)."""
    device = resolve_device(device)
    points = as_f32(points, device)
    direction = torch.tensor([1.0, 0.0, 0.0], device=device).expand(points.shape)
    extent = float("inf") if radius is None else radius
    return make_ray(points, direction, extent, device=device)


def sum3(x: torch.Tensor) -> torch.Tensor:
    """``(x0 + x1) + x2`` over the last axis of size 3."""
    return (x[..., 0] + x[..., 1]) + x[..., 2]


def point_sq_norms(points: torch.Tensor) -> torch.Tensor:
    """``||c||^2`` of an (N, 3) cloud, as ``(x*x + y*y) + z*z``."""
    return sum3(points * points)


def leaf_dist_sq(p: torch.Tensor, pts: torch.Tensor,
                 p_sq_norms: torch.Tensor) -> torch.Tensor:
    """Query-to-candidate squared distances in the brute form:
    ``max((||q||^2 - 2 q.c) + ||c||^2, 0)``.  p: (..., 3); pts: (..., 4, 3);
    p_sq_norms: (..., 4) precomputed ``||c||^2``."""
    q2 = sum3(p * p)
    qc = sum3(p[..., None, :] * pts)
    return ((q2[..., None] - 2.0 * qc) + p_sq_norms).clamp_min(0.0)


def insert_sorted(best_d: torch.Tensor, best_i: torch.Tensor, d: torch.Tensor,
                  i: torch.Tensor, accept: torch.Tensor):
    """One compare-shift-insert beat of the running top-k network.

    best_d/best_i: (k, L) sorted ascending (inf / -1 in empty slots);
    d/i/accept: (L,) one candidate per lane.  An accepted candidate lands
    in its rank slot under a strict ``<`` (on equal distances the earlier
    candidate keeps its slot) and everything below shifts down one."""
    ins = accept[None, :] & (d[None, :] < best_d)  # monotone down the k axis
    first = ins & ~torch.cat([torch.zeros_like(ins[:1]), ins[:-1]], dim=0)
    shift_d = torch.cat([best_d[:1], best_d[:-1]], dim=0)
    shift_i = torch.cat([best_i[:1], best_i[:-1]], dim=0)
    new_d = torch.where(first, d[None, :], torch.where(ins, shift_d, best_d))
    new_i = torch.where(first, i[None, :], torch.where(ins, shift_i, best_i))
    return new_d, new_i


def prune_bound(r_sq: torch.Tensor, kth_best: torch.Tensor, q_sq: torch.Tensor,
                mode: str) -> torch.Tensor:
    """Node-visit bound: a child is pushed iff its box distance is <= this.
    ``"within"`` prunes on the radius alone; ``"nearest"`` also contracts
    to the current k-th best once the list fills."""
    b = r_sq if mode == "within" else fmin(r_sq, kth_best)
    return b * (1.0 + PRUNE_SLACK) + PRUNE_SLACK * q_sq


def check_neighbor_args(k: int, mode: str) -> None:
    if mode not in NEIGHBOR_MODES:
        raise ValueError(f"mode must be one of {NEIGHBOR_MODES}, got {mode!r}")
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")


def neighbor_wavefront(bvh: BVH4, sq_norms: torch.Tensor, queries: Ray,
                       depth: int, k: int, mode: str = "within",
                       max_rounds: int | None = None) -> NeighborRecord:
    """Batch-level neighbour traversal (the wavefront engine's distance
    twin).  ``bvh`` is a point BVH; ``sq_norms`` its points' ``||c||^2``;
    ``queries`` carry the radius as ``extent``.  ``max_rounds`` defaults
    to the internal-node count."""
    check_neighbor_args(k, mode)
    leaf_parent_offset = level_offset(depth - 1)
    leaf_offset = level_offset(depth)
    if max_rounds is None:
        max_rounds = level_offset(depth)

    points = bvh.triangles.a
    p = queries.origin  # (R, 3)
    dev = p.device
    r_sq = queries.extent * queries.extent  # inf extent -> inf bound
    q_sq = sum3(p * p)
    n_q = p.shape[0]
    n_leaf = bvh.leaf_tri.shape[0]
    rows = torch.arange(n_q, device=dev)
    quad = torch.arange(4, device=dev)

    stack = torch.zeros((n_q, STACK_SIZE), dtype=torch.int32, device=dev)
    sp = torch.ones((n_q,), dtype=torch.int32, device=dev)  # root pre-pushed
    best_d = torch.full((k, n_q), float("inf"), dtype=torch.float32, device=dev)
    best_i = torch.full((k, n_q), -1, dtype=torch.int32, device=dev)
    count = torch.zeros((n_q,), dtype=torch.int32, device=dev)
    n_box = torch.zeros((n_q,), dtype=torch.int32, device=dev)
    n_pt = torch.zeros((n_q,), dtype=torch.int32, device=dev)
    rounds = 0

    while rounds < max_rounds and bool((sp > 0).any()):
        active = sp > 0
        # frontier pop; the stack index clamps to its top slot, as the
        # reference's gather clamps
        top = stack[rows, (sp - 1).clamp(0, STACK_SIZE - 1).long()]
        node = torch.where(active, top, torch.zeros_like(top))
        sp = torch.where(active, sp - 1, sp)
        is_leaf_parent = node >= leaf_parent_offset

        pb = point_box_test(p, child_boxes(bvh, node))

        # point-distance round for the leaf-parent queries
        leaf_pos = (4 * node.long()[:, None] + 1 - leaf_offset + quad)
        cand = bvh.leaf_tri[leaf_pos.clamp(0, n_leaf - 1)]  # (R, 4), -1 = pad
        safe = cand.clamp(min=0).long()
        d_sq = leaf_dist_sq(p, points[safe], sq_norms[safe])
        in_r = ((active & is_leaf_parent)[:, None] & (cand >= 0)
                & (d_sq <= r_sq[:, None]))
        count = count + in_r.sum(1, dtype=torch.int32)
        for c in range(4):  # 4 insertion beats per round
            best_d, best_i = insert_sorted(best_d, best_i, d_sq[:, c],
                                           cand[:, c], in_r[:, c])

        # push surviving children far to near; the slot clamps to the top
        # of the stack while sp keeps counting (no overflow flag)
        bound = prune_bound(r_sq, best_d[k - 1], q_sq, mode)
        for c in range(4):
            slot = 3 - c
            ok = active & ~is_leaf_parent & (pb.dist_sq[:, slot] <= bound)
            child = 4 * node + 1 + pb.box_index[:, slot]
            pos = sp.clamp(max=STACK_SIZE - 1).long()
            stack[rows, pos] = torch.where(ok, child, stack[rows, pos])
            sp = torch.where(ok, sp + 1, sp)
        n_box = n_box + active.to(torch.int32)
        n_pt = n_pt + 4 * (active & is_leaf_parent).to(torch.int32)
        rounds += 1

    return NeighborRecord(dist_sq=best_d.T, index=best_i.T,
                          valid=(best_i >= 0).T, count=count, box_jobs=n_box,
                          point_jobs=n_pt,
                          rounds=torch.tensor(rounds, dtype=torch.int32,
                                              device=dev))
