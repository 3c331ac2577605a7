"""Typed wrappers of the stage and distance kernels: records in, records
out.

The port's counterpart of ``repro/kernels/ops.py`` for OpQuadbox,
OpTriangle, the batched OpEuclidean / OpAngular and the unified
mixed-opcode stream.  User code speaks
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
import torch.nn.functional as F

from ..core.stream import DatapathJob, DatapathOutput
from ..core.types import (
    OP_EUCLIDEAN,
    OP_TRIANGLE,
    Box,
    QuadBoxResult,
    Ray,
    Triangle,
    TriangleResult,
)
from .common import (
    LANES,
    N_OPERAND_ROWS,
    OUT_DOT,
    OUT_EUCLID,
    OUT_HIT,
    OUT_IDX,
    OUT_NORM,
    OUT_RESET,
    OUT_TDENOM,
    OUT_THIT,
    OUT_TMIN,
    OUT_TNUM,
    ROW_INV,
    ROW_MASK,
    ROW_NEG,
    ROW_ORG,
    ROW_RESET,
    ROW_VEC_A,
    ROW_VEC_B,
    ceil_to,
    pad_cols,
)
from .distance import distance_cuda, norms_cuda
from .raybox import raybox
from .raytri import raytri
from .unified import unified


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


# ---------------------------------------------------------------------------
# Unified mixed-opcode stream
# ---------------------------------------------------------------------------


def pack_unified(jobs: DatapathJob) -> tuple[torch.Tensor, torch.Tensor]:
    """Pack a (T, 128) job grid into (opcodes (T,) i32, operands (48, T*128)).

    Beat t of lane-stream l lives at column t*128 + l.  All lanes of a beat
    take lane 0's opcode (one opcode per beat, as the hardware takes one
    opcode per cycle).  INV/SHEAR and NEG/K share rows, picked per beat;
    the lane mask is packed as its count of live lanes.
    """
    t, l = jobs.opcode.shape
    if l != LANES:
        raise ValueError(f"lane axis must be {LANES}, got {l}")
    n = t * l
    operands = torch.zeros((N_OPERAND_ROWS, n), dtype=torch.float32,
                           device=jobs.opcode.device)

    def put(rows: torch.Tensor, r0: int):  # rows: (T, L, k) -> layout rows r0..
        operands[r0:r0 + rows.shape[-1]] = rows.reshape(n, -1).T

    put(jobs.ray.origin, ROW_ORG)
    is_tri = (jobs.opcode[:, :1] == OP_TRIANGLE)[..., None]  # (T, 1, 1)
    put(torch.where(is_tri, jobs.ray.shear, jobs.ray.inv), ROW_INV)
    kvec = torch.stack([jobs.ray.kx, jobs.ray.ky, jobs.ray.kz], -1).to(torch.float32)
    neg = torch.signbit(jobs.ray.direction).to(torch.float32)
    put(torch.where(is_tri, kvec, neg), ROW_NEG)

    is_vec = (jobs.opcode[:, :1] >= OP_EUCLIDEAN)[..., None]  # (T, 1, 1)
    box_lo = jobs.boxes.lo.reshape(t, l, 12)
    box_hi = jobs.boxes.hi.reshape(t, l, 12)
    tri_rows = F.pad(torch.cat([jobs.triangle.a, jobs.triangle.b, jobs.triangle.c],
                               -1), (0, 3))  # (T, L, 12)
    geo_lo = torch.where(is_tri, tri_rows, box_lo)
    # rows 9..24: box_lo(12)+pad / triangle(9)+pad / vec_a(16)
    put(torch.where(is_vec, jobs.vec_a, F.pad(geo_lo, (0, 4))), ROW_VEC_A)
    # rows 25..40: box_hi(12)+pad / vec_b(16)
    put(torch.where(is_vec, jobs.vec_b, F.pad(box_hi, (0, 4))), ROW_VEC_B)
    # the kernel keeps lanes i < count: a mask with holes packs as a prefix
    put(jobs.mask.to(torch.float32).sum(-1, keepdim=True), ROW_MASK)
    put(jobs.reset_accum.to(torch.float32)[..., None], ROW_RESET)
    return jobs.opcode[:, 0].to(torch.int32).contiguous(), operands


def unpack_unified(opcodes: torch.Tensor, out: torch.Tensor, t: int) -> DatapathOutput:
    """(16, T*128) kernel output -> :class:`DatapathOutput` with (T, 128)
    leaves; box indices come back through their f32 row, flags as > 0.5."""
    def row(r):
        return out[r].reshape(t, LANES)

    def rows4(r0):
        return out[r0:r0 + 4].T.reshape(t, LANES, 4)

    return DatapathOutput(
        opcode=opcodes[:, None].expand(t, LANES).to(torch.int32).contiguous(),
        tmin=rows4(OUT_TMIN), box_index=rows4(OUT_IDX).to(torch.int32),
        is_intersect=rows4(OUT_HIT) > 0.5,
        t_num=row(OUT_TNUM), t_denom=row(OUT_TDENOM),
        triangle_hit=row(OUT_THIT) > 0.5,
        euclidean_accumulator=row(OUT_EUCLID),
        angular_dot_product=row(OUT_DOT), angular_norm=row(OUT_NORM),
        reset_accum=row(OUT_RESET) > 0.5,
    )


def unified_datapath(jobs: DatapathJob) -> DatapathOutput:
    """Mixed-opcode stream through the unified kernel.

    jobs: every leaf shaped (T, 128, ...), T beats of 128 lane-streams;
    each beat carries one opcode (``jobs.opcode[:, 0]``).
    """
    opcodes, operands = pack_unified(jobs)
    return unpack_unified(opcodes, unified(opcodes, operands), jobs.opcode.shape[0])
