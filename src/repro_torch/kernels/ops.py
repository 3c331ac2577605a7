"""Typed wrappers of the stage and distance kernels: records in, records
out.

The port's counterpart of ``repro/kernels/ops.py`` for OpQuadbox,
OpTriangle and the batched OpEuclidean / OpAngular.  User code speaks
``Ray`` / ``Box`` / ``Triangle``; the stage kernels speak rows-by-jobs.
The ``*_operands`` functions pack and pad the job count to a multiple of
:data:`~repro_torch.kernels.common.LANES` (padding jobs are benign: zero
boxes, unit inverse / shear); the ``*_kernel`` functions launch on those
operands and slice back.  The distance wrappers need no padding: unlike
the reference's ``_pad2d`` route, the distance and norm kernels mask the
ragged edges of M, N and D themselves (zero features would add exact
zeros, so the values are the same either way).
"""
from __future__ import annotations

import torch

from ..core.types import Box, QuadBoxResult, Ray, Triangle, TriangleResult
from .common import LANES, ceil_to, pad_cols
from .distance import distance_cuda, norms_cuda
from .raybox import raybox
from .raytri import raytri


def ray_box_operands(ray: Ray, boxes: Box) -> tuple:
    """The OpQuadbox kernel's operands (org, inv, neg, box_lo, box_hi) for
    N jobs, padded to whole lanes.  ray fields (N, ·); boxes (N, 4, 3)."""
    n = ray.origin.shape[0]
    n_pad = ceil_to(max(n, 1), LANES)
    org = pad_cols(ray.origin.T, n_pad).contiguous()
    inv = pad_cols(ray.inv.T, n_pad, 1.0).contiguous()
    neg = pad_cols(torch.signbit(ray.direction).to(torch.float32).T,
                   n_pad).contiguous()
    lo = pad_cols(boxes.lo.reshape(n, 12).T, n_pad).contiguous()
    hi = pad_cols(boxes.hi.reshape(n, 12).T, n_pad).contiguous()
    return org, inv, neg, lo, hi


def ray_box_kernel(ray: Ray, boxes: Box) -> QuadBoxResult:
    """Kernel-backed ray-vs-4-AABB test.  ray fields (N, ·); boxes (N, 4, 3)."""
    n = ray.origin.shape[0]
    tmin, idx, hit = raybox(*ray_box_operands(ray, boxes))
    return QuadBoxResult(tmin=tmin.T[:n], box_index=idx.T[:n],
                         is_intersect=hit.T[:n].bool())


def ray_triangle_operands(ray: Ray, tri: Triangle) -> tuple:
    """The OpTriangle kernel's operands (org, shear, k, va, vb, vc) for N
    jobs, padded to whole lanes.  All batched (N, ·)."""
    n = ray.origin.shape[0]
    n_pad = ceil_to(max(n, 1), LANES)
    org = pad_cols(ray.origin.T, n_pad).contiguous()
    shear = pad_cols(ray.shear.T, n_pad, 1.0).contiguous()
    k = pad_cols(torch.stack([ray.kx, ray.ky, ray.kz]).to(torch.int32),
                 n_pad, 0).contiguous()
    va = pad_cols(tri.a.T, n_pad).contiguous()
    vb = pad_cols(tri.b.T, n_pad).contiguous()
    vc = pad_cols(tri.c.T, n_pad).contiguous()
    return org, shear, k, va, vb, vc


def ray_triangle_kernel(ray: Ray, tri: Triangle) -> TriangleResult:
    """Kernel-backed watertight ray-triangle test.  All batched (N, ·)."""
    n = ray.origin.shape[0]
    t_num, t_denom, hit = raytri(*ray_triangle_operands(ray, tri))
    return TriangleResult(t_num=t_num[:n], t_denom=t_denom[:n],
                          hit=hit[:n].bool())


def euclidean_kernel(q: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Pairwise squared distances (M, D) x (N, D) -> (M, N), kernel-backed."""
    return distance_cuda(q.contiguous(), c.contiguous(), mode="euclidean")


def dot_kernel(q: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """OpAngular's dot products alone (M, N), kernel-backed: the distance
    backend's path, whose norms come precomputed with the index."""
    return distance_cuda(q.contiguous(), c.contiguous(), mode="angular")


def angular_kernel(q: torch.Tensor, c: torch.Tensor):
    """OpAngular batched: ((M, N) dots, (N,) norms), kernel-backed."""
    return dot_kernel(q, c), norms_cuda(c.contiguous())[0]
