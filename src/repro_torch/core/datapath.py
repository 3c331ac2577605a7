"""The Ray Tracer Datapath's traversal stage units, in plain PyTorch.

The port's counterpart of ``repro/core/datapath.py`` (OpQuadbox,
OpTriangle, the point-box test of neighbour search, and the OpEuclidean /
OpAngular beats with their accumulators).  Each stage is one eager elementwise op, and PyTorch rounds
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

from .types import (
    ANGULAR_LANES,
    VECTOR_LANES,
    AngularResult,
    Box,
    DatapathState,
    EuclideanResult,
    PointBoxResult,
    QuadBoxResult,
    Ray,
    Triangle,
    TriangleResult,
)


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


# ---------------------------------------------------------------------------
# OpEuclidean / OpAngular (Table VII columns 3-4): masked lanes + adder tree
# ---------------------------------------------------------------------------


def _mask_lanes(x: torch.Tensor, mask: torch.Tensor | None, lanes: int) -> torch.Tensor:
    x = x[..., :lanes]
    if mask is not None:
        x = torch.where(mask[..., :lanes], x, 0.0)
    return x


def euclidean_partial(a: torch.Tensor, b: torch.Tensor,
                      mask: torch.Tensor | None = None) -> torch.Tensor:
    """One beat of OpEuclidean: sum over <=16 lanes of (a-b)^2, through the
    hardware's pairwise adder tree 16->8->4->2->1 in that order."""
    d = _mask_lanes(a, mask, VECTOR_LANES) - _mask_lanes(b, mask, VECTOR_LANES)  # stage 2
    d = d * d  # stage 3 (16 muls)
    d = d[..., :8] + d[..., 8:16]  # stage 4 (8 adds)
    d = d[..., :4] + d[..., 4:8]  # stage 6 (4 adds)
    d = d[..., :2] + d[..., 2:4]  # stage 8 (2 adds)
    return d[..., 0] + d[..., 1]  # stage 9 (1 add)


def angular_partial(q: torch.Tensor, c: torch.Tensor, mask: torch.Tensor | None = None):
    """One beat of OpAngular: (sum q*c, sum c*c) over <=8 lanes, two
    8->4->2->1 trees."""
    qm = _mask_lanes(q, mask, ANGULAR_LANES)
    cm = _mask_lanes(c, mask, ANGULAR_LANES)
    dot = qm * cm  # stage 3 (8 muls)
    nrm = cm * cm  # stage 3 (8 muls)
    dot = dot[..., :4] + dot[..., 4:8]  # stage 4
    nrm = nrm[..., :4] + nrm[..., 4:8]
    dot = dot[..., :2] + dot[..., 2:4]  # stage 6
    nrm = nrm[..., :2] + nrm[..., 2:4]
    return dot[..., 0] + dot[..., 1], nrm[..., 0] + nrm[..., 1]  # stage 8


def euclidean_beat(state: DatapathState, a, b, mask=None, reset=False):
    """Full OpEuclidean job incl. accumulator semantics (Table V):
    ``reset`` clears the Euclidean accumulator for this job; the angular
    accumulators are untouched (per-mode isolation).  On a reset the add
    still runs, with +0.0, so a -0.0 partial comes out +0.0."""
    partial = euclidean_partial(a, b, mask)
    reset = torch.as_tensor(reset, device=partial.device)
    out = partial + torch.where(reset, 0.0, state.euclid_accum)  # stage 10
    return state._replace(euclid_accum=out), EuclideanResult(out, reset)


def angular_beat(state: DatapathState, q, c, mask=None, reset=False):
    """Full OpAngular job incl. dual accumulators (dot product and norm)."""
    dot_p, nrm_p = angular_partial(q, c, mask)
    reset = torch.as_tensor(reset, device=dot_p.device)
    dot = dot_p + torch.where(reset, 0.0, state.dot_accum)  # stage 9 (2 adds)
    nrm = nrm_p + torch.where(reset, 0.0, state.norm_accum)
    return (state._replace(dot_accum=dot, norm_accum=nrm),
            AngularResult(dot, nrm, reset))


def euclidean_distance_sq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Any-dimension Euclidean distance**2 by multi-beat accumulation.

    a, b: (..., D).  D is padded to whole 16-lane beats with masked lanes
    and fed one beat at a time, as the hardware is fed; the first beat adds
    +0.0, each later one the running sum.
    """
    a, b, mask, beats = _beats(a, b, VECTOR_LANES)
    acc = torch.zeros(a.shape[1:-1], dtype=torch.float32, device=a.device)
    for j in range(beats):
        acc = euclidean_partial(a[j], b[j], mask[j]) + acc
    return acc


def angular_distance_parts(q: torch.Tensor, c: torch.Tensor):
    """Any-dimension (q . c, ||c||^2) by 8-lane beats."""
    q, c, mask, beats = _beats(q, c, ANGULAR_LANES)
    dot = torch.zeros(q.shape[1:-1], dtype=torch.float32, device=q.device)
    nrm = dot.clone()
    for j in range(beats):
        d, n = angular_partial(q[j], c[j], mask[j])
        dot, nrm = d + dot, n + nrm
    return dot, nrm


def _beats(a: torch.Tensor, b: torch.Tensor, lanes: int):
    """(..., D) pair -> (beats, ..., lanes) zero-padded beats and their
    lane masks (lanes past D are dead)."""
    d = a.shape[-1]
    beats = max(1, -(-d // lanes))
    pad = beats * lanes - d

    def to_beats(x):
        x = torch.nn.functional.pad(x.to(torch.float32), (0, pad))
        return x.reshape(x.shape[:-1] + (beats, lanes)).movedim(-2, 0)

    mask = torch.arange(beats * lanes, device=a.device) < d
    mask = mask.reshape(beats, *(1,) * (a.dim() - 1), lanes)
    return to_beats(a), to_beats(b), mask, beats
