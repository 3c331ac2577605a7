"""LBVH -> BVH4: the Morton-order builder, in PyTorch.

The port's counterpart of ``repro/core/build/lbvh.py``:

1. Morton-code the triangle centroids (30-bit, 10 bits per axis), in
   int64 with explicit ``& 0xFFFFFFFF`` masks standing in for the
   reference's uint32 wraparound.
2. Sort along the Z-order curve with a *stable* argsort (``jnp.argsort``
   is stable, and ties between equal codes must keep index order).
3. Lay the sorted leaves into the implicit complete 4-ary tree and fit the
   boxes bottom-up.

Every step is a tensor op on the triangles' device, so a scene whose
triangles are on the card is built on the card.
"""
from __future__ import annotations

import functools

import torch

from ..bvh import (BVH4, DatapathConfig, bvh_depth, fit_nodes, leaf_arrays,
                   nondegenerate_mask, resolve_config)
from ..types import Box, Triangle, aabb_of_triangles
from . import register_builder

_U32 = 0xFFFFFFFF


def _expand_bits(v: torch.Tensor) -> torch.Tensor:
    """Spread the low 10 bits of v so there are 2 zero bits between each."""
    v = ((v * 0x00010001) & _U32) & 0xFF0000FF
    v = ((v * 0x00000101) & _U32) & 0x0F00F00F
    v = ((v * 0x00000011) & _U32) & 0xC30C30C3
    v = ((v * 0x00000005) & _U32) & 0x49249249
    return v


@functools.lru_cache(maxsize=None)
def _spread_table(device: torch.device) -> torch.Tensor:
    """``_expand_bits`` of every 10-bit value, built once per device (no
    caller writes to it): a gather then spreads an axis in one op."""
    return _expand_bits(torch.arange(1024, dtype=torch.int64, device=device))


def morton3d(points01: torch.Tensor) -> torch.Tensor:
    """30-bit Morton codes (int64) for points in [0, 1]^3.  points01: (N, 3).
    Coordinates outside [0, 1] clamp; a NaN coordinate counts as 0."""
    scaled = torch.nan_to_num(points01 * 1024.0, nan=0.0).clamp(0.0, 1023.0).to(torch.int64)
    spread = _spread_table(scaled.device)[scaled]  # (N, 3)
    return (spread[:, 0] << 2) | (spread[:, 1] << 1) | spread[:, 2]


def lbvh_leaf_perm(boxes: Box, depth: int, arity: int = 4) -> torch.Tensor:
    """Morton-order leaf-slot assignment over per-primitive AABBs: the
    ``(arity**depth,)`` slot permutation (-1 = empty pad slot)."""
    n = boxes.lo.shape[0]
    n_leaves = arity**depth
    centroid = 0.5 * (boxes.lo + boxes.hi)
    scene_lo = boxes.lo.amin(dim=0)
    scene_hi = boxes.hi.amax(dim=0)
    diff = scene_hi - scene_lo
    extent = torch.where(diff > 1e-12, diff, torch.full_like(diff, 1e-12))
    codes = morton3d((centroid - scene_lo) / extent)
    order = torch.argsort(codes, stable=True).to(torch.int32)
    pad = torch.full((n_leaves - n,), -1, dtype=torch.int32,
                     device=order.device)
    return torch.cat([order, pad])


@register_builder("lbvh")
def build_bvh4(tri: Triangle, depth: int | None = None,
               config: DatapathConfig | None = None) -> BVH4:
    """Build a BVH4 over a triangle soup on the soup's device."""
    config = resolve_config(config)
    n = tri.a.shape[0]
    if depth is None:
        depth = bvh_depth(n, config.arity)
    boxes = aabb_of_triangles(tri)
    leaf_perm = lbvh_leaf_perm(boxes, depth, config.arity)
    leaf_tri, leaf_lo, leaf_hi = leaf_arrays(leaf_perm, boxes,
                                             nondegenerate_mask(tri))
    node_lo, node_hi = fit_nodes(leaf_lo, leaf_hi, depth, config.arity)
    return BVH4(node_lo=node_lo, node_hi=node_hi, leaf_tri=leaf_tri,
                triangles=tri, leaf_perm=leaf_perm)
