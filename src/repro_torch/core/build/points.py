"""Point-cloud acceleration structures: AABB-per-point leaves (RTNN).

The port's counterpart of ``repro/core/build/points.py``.  Every point is
wrapped in a degenerate AABB (lo == hi == the point), the triangle
builders' slot-assignment core lays those leaves into the usual implicit
BVH4, and the point is stored at all three ``triangles`` vertices so the
record stays a valid soup; the neighbour engines read the cloud back as
``bvh.triangles.a``.  There is no degenerate cull: a point's box is
zero-area by nature, so every point is live.

A moved cloud refits through :func:`refit_points`, the cull-free twin of
the triangle refit.  Only the LBVH core is ported; ``builder="sah"`` raises
``NotImplementedError`` until the SAH builder is.
"""
from __future__ import annotations

import torch

from ..bvh import (BVH4, DatapathConfig, bvh4_depth, depth_of, encode_nodes,
                   fit_nodes, leaf_arrays, resolve_config)
from ..types import Box, Triangle
from . import BuildResult
from .lbvh import lbvh_leaf_perm

# the slot-assignment cores shared with the triangle builders (the same
# names, so ``builder=`` means the same thing for both kinds of scene)
POINT_BUILDERS = {"lbvh": lbvh_leaf_perm}
_NOT_PORTED = ("sah",)


def point_boxes(points: torch.Tensor) -> Box:
    """Degenerate AABB per point (lo == hi == the point)."""
    return Box(lo=points, hi=points)


def _point_soup(points: torch.Tensor) -> Triangle:
    """Each point at all three vertices; neighbour engines read ``.a``."""
    return Triangle(points, points, points)


def _check_points(points: torch.Tensor, where: str) -> torch.Tensor:
    points = points.to(torch.float32)
    if points.ndim != 2 or points.shape[-1] != 3:
        raise ValueError(
            f"{where}: expected an (N, 3) point cloud, got "
            f"{tuple(points.shape)} (the tree path is the 3-D RTNN "
            "mapping; higher-dimensional data stays on the brute path)")
    return points


def _check_point_config(config, where: str) -> DatapathConfig:
    """Point clouds stay 4-wide: the neighbour engines traverse the quad-box
    datapath."""
    config = resolve_config(config)
    if config.arity != 4:
        raise ValueError(
            f"{where}: point-cloud trees are 4-wide (the neighbor engines "
            f"traverse the quad-box datapath); got arity={config.arity}")
    return config


def build_point_bvh(points: torch.Tensor, builder: str = "lbvh",
                    depth: int | None = None,
                    config: DatapathConfig | None = None) -> BuildResult:
    """Build a BVH4 over a point cloud on the cloud's device.  ``depth``
    defaults to the smallest depth whose ``4**depth`` leaf slots fit it."""
    points = _check_points(points, "build_point_bvh")
    config = _check_point_config(config, "build_point_bvh")
    n = points.shape[0]
    if builder in _NOT_PORTED:
        raise NotImplementedError(
            f"point builder {builder!r} is not ported yet (repro_torch has "
            f"{tuple(POINT_BUILDERS)})")
    if builder not in POINT_BUILDERS:
        raise ValueError(f"unknown point builder {builder!r} "
                         f"(registered: {tuple(POINT_BUILDERS)})")
    if depth is None:
        depth = bvh4_depth(n)
    if 4**depth < n:
        raise ValueError(
            f"depth={depth} gives {4**depth} leaf slots < {n} points")

    boxes = point_boxes(points)
    leaf_perm = POINT_BUILDERS[builder](boxes, depth)
    # every point is live: the triangle zero-area cull must not apply
    live = torch.ones((n,), dtype=torch.bool, device=points.device)
    leaf_tri, leaf_lo, leaf_hi = leaf_arrays(leaf_perm, boxes, live)
    node_lo, node_hi = fit_nodes(leaf_lo, leaf_hi, depth)
    node_lo, node_hi = encode_nodes(node_lo, node_hi, depth, config)
    bvh = BVH4(node_lo=node_lo, node_hi=node_hi, leaf_tri=leaf_tri,
               triangles=_point_soup(points), leaf_perm=leaf_perm)
    return BuildResult(bvh=bvh, builder=builder, depth=depth, config=config)


def refit_points(bvh: BVH4, points: torch.Tensor,
                 config: DatapathConfig | None = None) -> BVH4:
    """Topology-preserving refit of a moved cloud (same count, same order).
    The triangle refit re-evaluates the zero-area cull, which would cull
    every point, so clouds refit through this cull-free twin."""
    points = _check_points(points, "refit_points")
    config = _check_point_config(config, "refit_points")
    n_built = bvh.triangles.a.shape[0]
    if points.shape[0] != n_built:
        raise ValueError(
            f"refit_points needs the built cloud's {n_built} points, got "
            f"{points.shape[0]} (topology is preserved -- rebuild to "
            "change the cloud)")
    depth = depth_of(bvh)
    boxes = point_boxes(points)
    live = torch.ones((n_built,), dtype=torch.bool, device=points.device)
    leaf_tri, leaf_lo, leaf_hi = leaf_arrays(bvh.leaf_perm, boxes, live)
    node_lo, node_hi = fit_nodes(leaf_lo, leaf_hi, depth)
    node_lo, node_hi = encode_nodes(node_lo, node_hi, depth, config)
    return BVH4(node_lo=node_lo, node_hi=node_hi, leaf_tri=leaf_tri,
                triangles=_point_soup(points), leaf_perm=bvh.leaf_perm)
