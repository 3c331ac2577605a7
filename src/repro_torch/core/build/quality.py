"""Tree-quality metrics: SAH cost and measured datapath jobs per ray.

The port's counterpart of ``repro/core/build/quality.py``.  Two lenses on
how much datapath work a tree costs per query:

* :func:`sah_cost`, the model: the Surface Area Heuristic expectation
  (box-test and triangle-test terms weighted by surface area relative to
  the root), from the tree alone;
* :func:`mean_jobs_per_ray`, the measurement: trace a probe batch and read
  the per-ray ``quadbox_jobs`` / ``triangle_jobs`` counters.  The counts
  are integers, equal on every backend, so they are the portable quality
  metric; a refit user reads them to decide when a decayed tree should be
  rebuilt.

``Scene.stats()`` reports both as a :class:`TreeStats`.  The module also
keeps the port's own copy of ``clustered_soup``: the same numpy
construction, drawing the same numbers from the same generator.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..bvh import BVH4, DatapathConfig, depth_of, level_offset, resolve_config
from ..device import resolve_device
from ..types import Ray, Triangle, make_ray
from ..wavefront import trace_wavefront
from .sah import _half_area


class TreeStats(NamedTuple):
    """One builder's tree, summarised (``Scene.stats()``)."""

    builder: str
    n_triangles: int
    depth: int
    n_nodes: int
    n_leaves: int
    occupancy: float  # occupied fraction of the arity**depth leaf slots
    sah_cost: float  # model: SAH expectation relative to the root box
    mean_quadbox_jobs: float  # measured: box-test jobs per probe ray
    mean_triangle_jobs: float  # measured: OpTriangle jobs per probe ray
    mean_jobs: float  # quadbox + triangle
    arity: int  # BVH branching factor the tree was built at
    bytes_per_node: int  # node-box storage of the config's codec
    compression_ratio: float  # raw-f32 24 B/node over bytes_per_node
    mean_branching_factor: float  # mean live children per live internal node


def sah_cost(bvh: BVH4, c_box: float = 1.0, c_tri: float = 1.0,
             arity: int | None = None) -> float:
    """``sum_internal c_box A(n) / A(root) + sum_leaf c_tri A(l) / A(root)``,
    empty (inverted) nodes contributing zero; a leaf holds one triangle."""
    arity = 4 if arity is None else arity
    leaf_start = level_offset(depth_of(bvh, arity), arity)
    area = _half_area(bvh.node_lo, bvh.node_hi)
    valid = (bvh.node_hi >= bvh.node_lo).all(dim=-1)
    area = torch.where(valid, area, torch.zeros_like(area))
    root_area = area[0].clamp_min(1e-30)
    occupied = bvh.leaf_tri >= 0
    cost = (c_box * area[:leaf_start].sum()
            + c_tri * (area[leaf_start:] * occupied).sum()) / root_area
    return float(cost)


def probe_rays(bvh: BVH4, n: int = 256, seed: int = 0) -> Ray:
    """A deterministic probe batch (the reference's numpy draws): origins
    on a sphere outside the scene box, aimed at points inside it, so every
    probe enters the tree.  On the tree's device."""
    rng = np.random.default_rng(seed)
    lo = bvh.node_lo[0].cpu().numpy()
    hi = bvh.node_hi[0].cpu().numpy()
    center = 0.5 * (lo + hi)
    radius = 1.25 * float(np.linalg.norm(hi - lo)) + 1e-3
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.maximum(np.linalg.norm(d, axis=1, keepdims=True), 1e-12)
    org = (center + radius * d).astype(np.float32)
    tgt = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    return make_ray(org, tgt - org, device=bvh.node_lo.device)


def mean_jobs_per_ray(bvh: BVH4, rays: Ray | None = None, probes: int = 256,
                      config: DatapathConfig | None = None) -> tuple[float, float]:
    """Measured (mean box-test, mean OpTriangle) jobs per ray, traced by
    ``trace_wavefront`` on the tree's device; :func:`probe_rays` when no
    batch is given."""
    config = resolve_config(config)
    if rays is None:
        rays = probe_rays(bvh, probes)
    rec = trace_wavefront(bvh, rays, depth_of(bvh, config.arity), config=config)
    return (float(rec.quadbox_jobs.float().mean()),
            float(rec.triangle_jobs.float().mean()))


def mean_branching_factor(bvh: BVH4, arity: int = 4) -> float:
    """Mean live (non-empty-box) children per live internal node."""
    n_internal = level_offset(depth_of(bvh, arity), arity)
    valid = (bvh.node_hi >= bvh.node_lo).all(dim=-1)
    # children of internal node k are nodes arity*k+1 .. arity*k+arity
    child_live = valid[1:].reshape(n_internal, arity).sum(dim=1)
    live_internal = valid[:n_internal]
    denom = live_internal.sum().clamp_min(1)
    live_children = torch.where(live_internal, child_live,
                                torch.zeros_like(child_live)).sum()
    return float(live_children.float() / denom.float())


def tree_stats(bvh: BVH4, builder: str = "?", rays: Ray | None = None,
               probes: int = 256, config: DatapathConfig | None = None) -> TreeStats:
    """Everything :class:`TreeStats` reports, from one tree."""
    config = resolve_config(config)
    n_leaves = int(bvh.leaf_tri.shape[0])
    occupied = int((bvh.leaf_tri >= 0).sum())
    qb, tr = mean_jobs_per_ray(bvh, rays, probes, config)
    return TreeStats(
        builder=builder,
        n_triangles=int(bvh.triangles.a.shape[0]),
        depth=depth_of(bvh, config.arity),
        n_nodes=int(bvh.node_lo.shape[0]),
        n_leaves=n_leaves,
        occupancy=occupied / n_leaves,
        sah_cost=sah_cost(bvh, arity=config.arity),
        mean_quadbox_jobs=qb,
        mean_triangle_jobs=tr,
        mean_jobs=qb + tr,
        arity=config.arity,
        bytes_per_node=config.box_bytes_per_node,
        compression_ratio=24.0 / config.box_bytes_per_node,
        mean_branching_factor=mean_branching_factor(bvh, config.arity),
    )


def clustered_soup(rng: np.random.Generator, n_clusters: int = 8,
                   per_cluster: int = 40, *, device=None) -> Triangle:
    """Tight triangle clusters flung across a wide volume: centres uniform
    in [-4, 4]^3, vertices normal around them (scale 0.06, edges 0.03)."""
    centers = rng.uniform(-4, 4, (n_clusters, 3)).astype(np.float32)
    ctr = (np.repeat(centers, per_cluster, axis=0)
           + rng.normal(scale=0.06, size=(n_clusters * per_cluster, 3))
           ).astype(np.float32)
    d1 = rng.normal(scale=0.03, size=ctr.shape).astype(np.float32)
    d2 = rng.normal(scale=0.03, size=ctr.shape).astype(np.float32)
    device = resolve_device(device)
    return Triangle(*(torch.as_tensor(v, device=device)
                      for v in (ctr, ctr + d1, ctr + d2)))
