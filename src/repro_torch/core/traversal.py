"""The per-ray traversal oracle: one ray, one fixed-size stack.

The port's counterpart of ``repro/core/traversal.py``.  Each step pops a
node and issues the job the paper's datapath serves there: at an internal
node one box-test job on its ``arity`` children, whose sorted output
pushes the hit children farthest first (the nearest ends on top); at a
leaf parent ``arity`` OpTriangle jobs, with the divide ``t = t_num /
t_denom`` done outside the datapath.  A push past ``stack_size`` is
dropped and flags ``stack_overflow``, as in every engine.

:func:`trace_rays` is a loop of :func:`trace_ray` over the batch: the
oracle, independent of the batch-level ``trace_wavefront``.  The stack and
the loop live on the host; the box and triangle jobs are the datapath's
own plain functions, on the ray's device.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .bvh import BVH4, DatapathConfig, level_offset, resolve_config
from .datapath import ray_box_test, ray_triangle_test
from .types import Box, Ray, Triangle

STACK_SIZE = 64  # DatapathConfig default (DEFAULT_CONFIG.stack_size)


class HitRecord(NamedTuple):
    t: torch.Tensor  # (...,) f32  distance of the closest hit (inf = miss)
    tri_index: torch.Tensor  # (...,) i32  index into the soup, -1 = miss
    hit: torch.Tensor  # (...,) bool
    quadbox_jobs: torch.Tensor  # (...,) i32  box-test jobs issued
    triangle_jobs: torch.Tensor  # (...,) i32  OpTriangle jobs issued
    stack_overflow: torch.Tensor  # (...,) bool  a push was dropped at capacity


def trace_ray(bvh: BVH4, ray: Ray, depth: int,
              config: DatapathConfig | None = None) -> HitRecord:
    """Closest-hit traversal of a single ray (fields without a batch
    axis).  At a leaf parent only the triangle jobs' results are read and
    elsewhere only the box test's, as in the reference's masked loop.
    ``config`` sets the arity and the stack size (the codecs are in the
    tree's boxes already)."""
    config = resolve_config(config)
    arity, stack_size = config.arity, config.stack_size
    leaf_parent_offset = level_offset(depth - 1, arity)
    leaf_offset = level_offset(depth, arity)
    dev = ray.origin.device
    tiled = Ray(*[f.expand((arity,) + tuple(f.shape)) for f in ray])

    stack = [0] * stack_size  # root pre-pushed
    sp = 1
    t_best = float("inf")  # an f32 value, held exactly as a Python float
    best_tri = -1
    n_qb = n_tri = 0
    overflow = False
    while sp > 0:
        sp -= 1
        node = stack[sp]
        n_qb += 1
        if node >= leaf_parent_offset:
            n_tri += arity
            # a popped node is internal, so its children's leaf slots lie
            # in range: a slice stands for the reference's clipped gather
            pos = arity * node + 1 - leaf_offset
            tri_idx = bvh.leaf_tri[pos:pos + arity]  # -1 = padded leaf
            safe = tri_idx.clamp(min=0).long()
            tris = Triangle(*[v[safe] for v in bvh.triangles])
            tr = ray_triangle_test(tiled, tris)
            t = tr.t_num / tr.t_denom  # the external divide
            valid = tr.hit & (tri_idx >= 0) & (t < t_best) & (t <= ray.extent)
            t_masked = torch.where(valid, t, torch.full_like(t, float("inf")))
            # one transfer; float64 holds every f32 and int32 exactly
            cand, idx = torch.stack([t_masked.double(), tri_idx.double()]).tolist()
            j = cand.index(min(cand))  # first minimum
            if cand[j] < t_best:
                t_best, best_tri = cand[j], int(idx[j])
            continue
        lo = arity * node + 1  # the children's boxes, one box-test job
        qb = ray_box_test(ray, Box(bvh.node_lo[lo:lo + arity], bvh.node_hi[lo:lo + arity]))
        tmin, box_index, hit = torch.stack(
            [qb.tmin.double(), qb.box_index.double(), qb.is_intersect.double()]).tolist()
        for slot in range(arity - 1, -1, -1):  # farthest first, nearest on top
            if hit[slot] and tmin[slot] < t_best:
                if sp < stack_size:
                    stack[sp] = arity * node + 1 + int(box_index[slot])
                    sp += 1
                else:
                    overflow = True

    i32 = dict(dtype=torch.int32, device=dev)
    return HitRecord(t=torch.tensor(t_best, dtype=torch.float32, device=dev),
                     tri_index=torch.tensor(best_tri, **i32),
                     hit=torch.tensor(best_tri >= 0, device=dev),
                     quadbox_jobs=torch.tensor(n_qb, **i32),
                     triangle_jobs=torch.tensor(n_tri, **i32),
                     stack_overflow=torch.tensor(overflow, device=dev))


def trace_rays(bvh: BVH4, rays: Ray, depth: int,
               config: DatapathConfig | None = None) -> HitRecord:
    """:func:`trace_ray` over each ray of an ``(R,)`` batch, in turn."""
    n = rays.origin.shape[0]
    recs = [trace_ray(bvh, Ray(*[f[i] for f in rays]), depth, config)
            for i in range(n)]
    if not recs:
        dev = rays.origin.device
        z = torch.zeros((0,), dtype=torch.int32, device=dev)
        return HitRecord(t=torch.zeros((0,), device=dev), tri_index=z,
                         hit=z.bool(), quadbox_jobs=z, triangle_jobs=z,
                         stack_overflow=z.bool())
    return HitRecord(*[torch.stack(f) for f in zip(*recs)])
