"""Binned SAH -> wide BVH: the top-down quality builder, in PyTorch.

The port's counterpart of ``repro/core/build/sah.py``.  In the implicit
complete tree the only freedom a builder has is the permutation of
primitives into leaf slots, and a node at level ``l`` owns a contiguous
run of ``arity**(depth - l)`` slots.  So construction is ``log2(arity)``
binary split rounds per tree level (2 for BVH4, 3 for BVH8), where round
``j`` splits each of its ``2**j`` segments:

1. per-segment centroid bounds -> the widest axis (first on ties);
2. bin every centroid into :data:`BINS` buckets along that axis
   (``(rel * bins)`` truncated); per-(segment, bin) counts and boxes;
3. the SAH sweep over the ``bins - 1`` planes, prefix / suffix box
   accumulations, ``cost = N_L A_L + N_R A_R`` (first minimum);
4. a rank split: order each segment by (bin, centroid) with the stable
   two-pass argsort and send ranks below the plane's count left, the
   count clamped to the child's slot capacity.

Every op is one eager tensor op, rounded on its own as the reference's
eager build rounds it (``_half_area`` and the cost are ``a*b + c*d``
forms no FMA may contract), and an empty segment's reductions hold +-inf
as ``jax.ops.segment_min`` / ``segment_max`` do, so ``leaf_perm`` and the
node arrays are bit-equal to the reference's.
"""
from __future__ import annotations

import torch

from ..bvh import (BVH4, DatapathConfig, bvh_depth, encode_nodes, fit_nodes,
                   leaf_arrays, nondegenerate_mask, resolve_config)
from ..types import Box, Triangle, aabb_of_triangles
from . import register_builder

#: candidate planes per split = BINS - 1
BINS = 16

_BINARY_ROUNDS = {4: 2, 8: 3}  # binary split rounds per tree level


def _half_area(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """Half surface area of boxes (..., 3); the SAH cost weight."""
    d = hi - lo
    return d[..., 0] * d[..., 1] + d[..., 1] * d[..., 2] + d[..., 2] * d[..., 0]


def _segment_reduce(data: torch.Tensor, seg: torch.Tensor, n_seg: int,
                    reduce: str) -> torch.Tensor:
    """Per-segment min or max of ``(N, 3)`` rows; an empty segment holds
    +inf (min) or -inf (max)."""
    fill = float("inf") if reduce == "amin" else float("-inf")
    out = torch.full((n_seg, 3), fill, dtype=data.dtype, device=data.device)
    index = seg.long()[:, None].expand(-1, 3)
    return out.scatter_reduce(0, index, data, reduce, include_self=True)


def sah_leaf_perm(boxes: Box, depth: int, bins: int = BINS,
                  arity: int = 4) -> torch.Tensor:
    """Binned-SAH leaf-slot assignment over per-primitive boxes (shared by
    triangle soups and point clouds): the ``(arity**depth,)`` slot
    permutation, -1 for an empty pad slot."""
    if arity not in _BINARY_ROUNDS:
        raise ValueError(f"arity must be 4 or 8, got {arity}")
    dev = boxes.lo.device
    n = boxes.lo.shape[0]
    n_leaves = arity**depth
    centroid = 0.5 * (boxes.lo + boxes.hi)
    tri_ids = torch.arange(n, dtype=torch.int32, device=dev)
    rows = torch.arange(n, device=dev)

    seg = torch.zeros((n,), dtype=torch.int64, device=dev)
    for level in range(depth * _BINARY_ROUNDS[arity]):
        n_seg = 2**level
        cap_child = n_leaves // 2**(level + 1)  # leaf slots per child

        # 1. per-segment centroid bounds -> split axis (first maximum)
        seg_lo = _segment_reduce(centroid, seg, n_seg, "amin")
        seg_hi = _segment_reduce(centroid, seg, n_seg, "amax")
        ext = seg_hi - seg_lo
        axis = torch.argmax(ext, dim=-1)  # (n_seg,)

        # 2. bin the centroids along each segment's axis
        c = centroid[rows, axis[seg]]
        lo_t = seg_lo.gather(1, axis[:, None])[:, 0][seg]
        ext_t = ext.gather(1, axis[:, None])[:, 0][seg]
        rel = (c - lo_t) / torch.clamp(ext_t, min=1e-12)
        b = (rel * bins).to(torch.int32).clamp(0, bins - 1).long()

        sb = seg * bins + b
        counts = torch.zeros((n_seg * bins,), dtype=torch.int64, device=dev)
        counts = counts.index_add_(0, sb, torch.ones_like(sb)).reshape(n_seg, bins)
        bin_lo = _segment_reduce(boxes.lo, sb, n_seg * bins, "amin").reshape(n_seg, bins, 3)
        bin_hi = _segment_reduce(boxes.hi, sb, n_seg * bins, "amax").reshape(n_seg, bins, 3)

        # 3. SAH sweep over the bins - 1 candidate planes
        cum = torch.cumsum(counts, dim=1)  # count through bin k
        n_l = cum[:, :-1]  # split after bin k, k = 0 .. bins - 2
        n_r = cum[:, -1:] - n_l
        area_l = _half_area(torch.cummin(bin_lo, dim=1).values[:, :-1],
                            torch.cummax(bin_hi, dim=1).values[:, :-1])
        area_r = _half_area(
            torch.cummin(bin_lo.flip(1), dim=1).values.flip(1)[:, 1:],
            torch.cummax(bin_hi.flip(1), dim=1).values.flip(1)[:, 1:])
        # empty sides carry inverted (+-inf) boxes: their weight is 0
        zero = torch.zeros_like(area_l)
        cost = (n_l * torch.where(n_l > 0, area_l, zero)
                + n_r * torch.where(n_r > 0, area_r, zero))
        k_best = torch.argmin(cost, dim=1)  # (n_seg,), first minimum

        # 4. rank split, clamped to the child slot capacity
        seg_cnt = cum[:, -1]
        target = cum.gather(1, k_best[:, None])[:, 0]
        target = torch.minimum(torch.maximum(target, (seg_cnt - cap_child).clamp(min=0)),
                               seg_cnt.clamp(max=cap_child))
        # stable two-pass argsort: order by (segment, bin, centroid)
        o1 = torch.argsort(c, stable=True)
        order = o1[torch.argsort(sb[o1], stable=True)]
        pos = torch.empty_like(seg)
        pos[order] = rows
        starts = torch.cumsum(seg_cnt, dim=0) - seg_cnt  # exclusive starts
        rank = pos - starts[seg]
        seg = 2 * seg + (rank >= target[seg]).long()

    # seg is now a unique leaf slot per primitive
    perm = torch.full((n_leaves,), -1, dtype=torch.int32, device=dev)
    perm[seg] = tri_ids
    return perm


@register_builder("sah")
def build_sah(tri: Triangle, depth: int | None = None,
              config: DatapathConfig | None = None, bins: int = BINS) -> BVH4:
    """Build a wide BVH with binned-SAH splits on the soup's device."""
    config = resolve_config(config)
    n = tri.a.shape[0]
    if depth is None:
        depth = bvh_depth(n, config.arity)
    boxes = aabb_of_triangles(tri)
    leaf_perm = sah_leaf_perm(boxes, depth, bins, config.arity)
    leaf_tri, leaf_lo, leaf_hi = leaf_arrays(leaf_perm, boxes,
                                             nondegenerate_mask(tri))
    node_lo, node_hi = fit_nodes(leaf_lo, leaf_hi, depth, config.arity)
    node_lo, node_hi = encode_nodes(node_lo, node_hi, depth, config)
    return BVH4(node_lo=node_lo, node_hi=node_hi, leaf_tri=leaf_tri,
                triangles=tri, leaf_perm=leaf_perm)
