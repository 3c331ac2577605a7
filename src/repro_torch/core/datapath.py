"""The Ray Tracer Datapath's traversal stage units, in plain PyTorch.

The port's counterpart of ``repro/core/datapath.py`` (OpQuadbox,
OpTriangle and the point-box test of neighbour search).  Each stage is one eager elementwise op, and PyTorch rounds
every such op to f32, which is the paper's round-after-every-functional-
unit choice (§III-D).  These are the plain versions of the stage units of
the CUDA kernels (``csrc/datapath.cuh``): the CPU path runs them,
and the kernels are held bit-equal to them on the card.

Comparator semantics: min/max are compare-and-select
(``torch.where(a > b, a, b)``), never ``torch.maximum``/``torch.minimum``,
which propagate NaN.  A NaN slab (``0 * inf``) is thereby dropped, as the
hardware's comparators drop it.
"""
from __future__ import annotations

import torch

from .types import Box, PointBoxResult, QuadBoxResult, Ray, Triangle, TriangleResult


def cmp_select(a: torch.Tensor, b: torch.Tensor, lt: torch.Tensor | None = None):
    """Compare-and-swap: returns (min-ish, max-ish); a false compare (NaN,
    ties) passes the operands through swapped, like a comparator + mux."""
    if lt is None:
        lt = a < b
    return torch.where(lt, a, b), torch.where(lt, b, a)


def fmax(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """max via comparator: returns ``b`` when the compare is false."""
    return torch.where(a > b, a, b)


def fmin(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.where(a < b, a, b)


# Compare-exchange schedule of the paper's QuadSortRecFN network.
SORT_NETWORKS = {
    4: [(0, 1), (2, 3), (0, 2), (1, 3), (1, 2)],
}


def boxsort(keys: torch.Tensor, *payloads: torch.Tensor):
    """Fixed-width sorting network over the trailing axis (width 4)."""
    width = keys.shape[-1]
    if width not in SORT_NETWORKS:
        raise NotImplementedError(
            f"sort width {width}: the port supports {tuple(SORT_NETWORKS)}")
    cols = list(keys.unbind(-1))
    pl = [list(p.unbind(-1)) for p in payloads]
    for i, j in SORT_NETWORKS[width]:
        lt = cols[i] < cols[j]
        cols[i], cols[j] = (torch.where(lt, cols[i], cols[j]),
                            torch.where(lt, cols[j], cols[i]))
        for p in pl:
            p[i], p[j] = torch.where(lt, p[i], p[j]), torch.where(lt, p[j], p[i])
    return (torch.stack(cols, dim=-1), *(torch.stack(p, dim=-1) for p in pl))


def quadsort(keys: torch.Tensor, *payloads: torch.Tensor):
    """The paper's QuadSortRecFN: 5 compare-exchanges over ``(..., 4)``."""
    if keys.shape[-1] != 4:
        raise ValueError(f"quadsort needs (..., 4) keys, got {tuple(keys.shape)}")
    return boxsort(keys, *payloads)


def ray_box_test(ray: Ray, boxes: Box) -> QuadBoxResult:
    """Batched ray-vs-4-AABB test (OpQuadbox).  ray fields: (...,) batch;
    boxes: (..., 4, 3) lo/hi."""
    o = ray.origin.unsqueeze(-2)  # (..., 1, 3)
    inv = ray.inv.unsqueeze(-2)

    # stage 2: translate box planes into ray space; stage 3: slabs
    t_lo = (boxes.lo - o) * inv
    t_hi = (boxes.hi - o) * inv

    # stage 4: swap keyed on the sign bit (dir == -0.0 swaps too), then
    # comparator max/min trees clamped at [0, inf]: NaN slabs drop out
    neg = torch.signbit(ray.direction).unsqueeze(-2)
    t_near = torch.where(neg, t_hi, t_lo)
    t_far = torch.where(neg, t_lo, t_hi)
    zero = torch.zeros_like(t_near[..., 0])
    tmin = fmax(t_near[..., 2], fmax(t_near[..., 1], fmax(t_near[..., 0], zero)))
    inf = torch.full_like(tmin, float("inf"))
    tmax = fmin(t_far[..., 2], fmin(t_far[..., 1], fmin(t_far[..., 0], inf)))

    # stage 5: intersect; stage 10: sorting networks over tmin
    hit_i = (tmin <= tmax).to(torch.int32)
    width = boxes.lo.shape[-2]
    idx = torch.arange(width, dtype=torch.int32,
                       device=tmin.device).expand(tmin.shape)
    tmin_s, idx_s, hit_s = boxsort(tmin, idx, hit_i)
    return QuadBoxResult(tmin=tmin_s, box_index=idx_s,
                         is_intersect=hit_s.bool())


def point_box_test(point: torch.Tensor, boxes: Box) -> PointBoxResult:
    """Batched point-vs-4-AABB squared distance, the neighbour-query twin
    of :func:`ray_box_test`.  point: (..., 3); boxes: (..., 4, 3).  Per
    axis the gap is ``fmax(lo - p, fmax(p - hi, 0))``, so an inverted pad
    box gives +inf and sorts last; the quad-sort network orders the
    children near to far."""
    p = point.unsqueeze(-2)  # (..., 1, 3)
    below = boxes.lo - p  # stage 2: per-axis signed gaps to both faces
    above = p - boxes.hi
    gap = fmax(below, fmax(above, torch.zeros_like(below)))
    sq = gap * gap
    d2 = (sq[..., 0] + sq[..., 1]) + sq[..., 2]
    idx = torch.arange(4, dtype=torch.int32, device=d2.device).expand(d2.shape)
    d2_sorted, idx_sorted = quadsort(d2, idx)
    return PointBoxResult(dist_sq=d2_sorted, box_index=idx_sorted)


def _gather_dim(v: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    return torch.gather(v, -1, k.long().unsqueeze(-1)).squeeze(-1)


def ray_triangle_test(ray: Ray, tri: Triangle) -> TriangleResult:
    """Batched watertight ray-triangle test, backface-culling variant
    (OpTriangle).  Outputs ``t_num`` / ``t_denom``; the divide is left to
    the caller, as in the paper."""
    sx, sy, sz = ray.shear.unbind(-1)

    # stage 2: translate vertices by the ray origin (9 adders)
    a = tri.a - ray.origin
    b = tri.b - ray.origin
    c = tri.c - ray.origin

    a_kx, a_ky, a_kz = (_gather_dim(a, ray.kx), _gather_dim(a, ray.ky),
                        _gather_dim(a, ray.kz))
    b_kx, b_ky, b_kz = (_gather_dim(b, ray.kx), _gather_dim(b, ray.ky),
                        _gather_dim(b, ray.kz))
    c_kx, c_ky, c_kz = (_gather_dim(c, ray.kx), _gather_dim(c, ray.ky),
                        _gather_dim(c, ray.kz))

    # stage 3: shear products (9 multipliers)
    az = sz * a_kz
    bz = sz * b_kz
    cz = sz * c_kz

    # stage 4: shear-subtract (6 adders)
    ax = a_kx - sx * a_kz
    ay = a_ky - sy * a_kz
    bx = b_kx - sx * b_kz
    by = b_ky - sy * b_kz
    cx = c_kx - sx * c_kz
    cy = c_ky - sy * c_kz

    # stages 5-6: edge functions (6 multipliers, 3 adders)
    u = cx * by - cy * bx
    v = ax * cy - ay * cx
    w = bx * ay - by * ax

    # stages 7-9: scaled z products and the two sums
    t_denom = (u + v) + w
    t_num = (u * az + v * bz) + w * cz

    # stage 10: hit decision (5 comparators)
    hit = (t_num > 0.0) & (t_denom != 0.0) & (u >= 0.0) & (v >= 0.0) & (w >= 0.0)
    return TriangleResult(t_num=t_num, t_denom=t_denom, hit=hit)
