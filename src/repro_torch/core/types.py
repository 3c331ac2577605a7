"""Data representations of the Ray Tracer Datapath (paper Tables I-IV).

The port's counterpart of ``repro/core/types.py``: the same ``NamedTuple``
records, holding ``torch`` tensors with an arbitrary batch prefix
``(...,)``.  :func:`make_ray` derives the paper's Table III convenience
fields exactly as the reference does (same ops, same rounding), so the
datapath stages downstream see bit-identical operands.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .device import resolve_device
from .knn import key_value, order_key

# Table V: 2-bit opcode
OP_TRIANGLE = 0
OP_QUADBOX = 1
OP_EUCLIDEAN = 2
OP_ANGULAR = 3

OPCODE_NAMES = {
    OP_TRIANGLE: "OpTriangle",
    OP_QUADBOX: "OpQuadbox",
    OP_EUCLIDEAN: "OpEuclidean",
    OP_ANGULAR: "OpAngular",
}

# Table IV: vector dimension is capped at 16 per beat; the angular mode
# processes half that many lanes per beat (each lane needs two multipliers).
VECTOR_LANES = 16
ANGULAR_LANES = VECTOR_LANES // 2

# Number of boxes per quad-box job (Table V: aabb_0..aabb_3).
QUAD = 4


class Box(NamedTuple):
    """An axis-aligned bounding box (Table I): minimum and maximum vertices."""

    lo: torch.Tensor  # (..., 3) f32
    hi: torch.Tensor  # (..., 3) f32


class Triangle(NamedTuple):
    """A triangle in 3D (Table II): three vertices."""

    a: torch.Tensor  # (..., 3) f32
    b: torch.Tensor  # (..., 3) f32
    c: torch.Tensor  # (..., 3) f32


class Ray(NamedTuple):
    """A ray plus the paper's precomputed convenience fields (Table III)."""

    origin: torch.Tensor  # (..., 3) f32
    direction: torch.Tensor  # (..., 3) f32
    inv: torch.Tensor  # (..., 3) f32   element-wise inverse of direction
    extent: torch.Tensor  # (...,)   f32   how far the ray travels
    kx: torch.Tensor  # (...,)   i32   \
    ky: torch.Tensor  # (...,)   i32    } permuted max-dimension indices
    kz: torch.Tensor  # (...,)   i32   /
    shear: torch.Tensor  # (..., 3) f32   [Sx, Sy, Sz]


class QuadBoxResult(NamedTuple):
    """Output of an OpQuadbox job: ``tmin`` sorted ascending, ``box_index``
    links each sorted slot to its input box, ``is_intersect`` its hit."""

    tmin: torch.Tensor  # (..., W) f32
    box_index: torch.Tensor  # (..., W) i32
    is_intersect: torch.Tensor  # (..., W) bool


class PointBoxResult(NamedTuple):
    """Output of a point/quad-box distance job, the neighbour-search twin
    of :class:`QuadBoxResult`: ``dist_sq`` from the query point to each box
    (0 inside, +inf for an inverted pad box), sorted ascending;
    ``box_index`` links each sorted slot to its input box."""

    dist_sq: torch.Tensor  # (..., 4) f32
    box_index: torch.Tensor  # (..., 4) i32


class TriangleResult(NamedTuple):
    """Output of an OpTriangle job: ``t = t_num / t_denom`` is external."""

    t_num: torch.Tensor  # (...,) f32
    t_denom: torch.Tensor  # (...,) f32
    hit: torch.Tensor  # (...,) bool


class EuclideanResult(NamedTuple):
    accumulator: torch.Tensor  # (...,) f32  running sum of squares
    reset_accum: torch.Tensor  # (...,) bool (propagated from input)


class AngularResult(NamedTuple):
    dot_product: torch.Tensor  # (...,) f32  running sum of products
    norm: torch.Tensor  # (...,) f32  running sum of candidate squares
    reset_accum: torch.Tensor  # (...,) bool (propagated from input)


class DatapathState(NamedTuple):
    """Internal accumulators (Table V: per-mode, isolated from each other),
    one per lane-stream of the batch shape."""

    euclid_accum: torch.Tensor  # batch shape, f32
    dot_accum: torch.Tensor
    norm_accum: torch.Tensor


def init_datapath_state(shape=(), *, device=None) -> DatapathState:
    """Accumulators at power-up (+0.0), of batch shape ``shape``.

    ``device=None`` puts them on CUDA (raising without a GPU); pass
    ``device="cpu"`` for the plain path.
    """
    z = torch.zeros(shape, dtype=torch.float32, device=resolve_device(device))
    return DatapathState(z, z.clone(), z.clone())


def as_f32(x, device: torch.device) -> torch.Tensor:
    """numpy array / tensor / scalar -> contiguous f32 tensor on ``device``."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32).contiguous()
    return torch.as_tensor(np.asarray(x, np.float32), device=device)


def _take(v: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """v: (..., 3), k: (...,) int -> v[..., k] over the batch."""
    return torch.gather(v, -1, k.long().unsqueeze(-1)).squeeze(-1)


def make_ray(origin, direction, extent=None, *, device=None) -> Ray:
    """Ray setup: derive inv / k-indices / shear per the Table III
    pseudocode, exactly as ``repro.core.types.make_ray``.

    ``device=None`` puts the ray on CUDA (raising without a GPU); pass
    ``device="cpu"`` for the plain path.
    """
    device = resolve_device(device)
    origin = as_f32(origin, device)
    direction = as_f32(direction, device)
    batch = origin.shape[:-1]
    if extent is None:
        extent = torch.full(batch, float("inf"), dtype=torch.float32,
                            device=device)
    else:
        extent = as_f32(extent, device).expand(batch).contiguous()

    inv = 1.0 / direction  # +-inf on +-0, as in hardware

    # strict '>' chain over |dir|: ties resolve to the earliest dimension
    dx, dy, dz = direction.abs().unbind(-1)
    max_ind = torch.zeros(dx.shape, dtype=torch.int32, device=device)
    max_val = dx
    one = torch.ones_like(max_ind)
    max_ind = torch.where(dy > max_val, one, max_ind)
    max_val = torch.where(dy > max_val, dy, max_val)
    max_ind = torch.where(dz > max_val, 2 * one, max_ind)

    kz = max_ind
    kx = (kz + 1) % 3
    ky = (kx + 1) % 3
    # if dir[kz] < 0 then swap(kx, ky): keeps the winding for the test
    dir_kz = _take(direction, kz)
    neg = dir_kz < 0.0
    kx, ky = torch.where(neg, ky, kx), torch.where(neg, kx, ky)

    dir_kx = _take(direction, kx)
    dir_ky = _take(direction, ky)
    shear = torch.stack([dir_kx / dir_kz, dir_ky / dir_kz, 1.0 / dir_kz],
                        dim=-1)
    return Ray(origin, direction, inv, extent, kx, ky, kz, shear)


def aabb_of_triangles(tri: Triangle) -> Box:
    """Tight AABB of each triangle (the builder's primitive boxes).  The
    reductions run on int32 order keys (:func:`~repro_torch.core.knn.order_key`),
    so -0.0 orders below +0.0 as in the reference's."""
    v = torch.stack([tri.a, tri.b, tri.c], dim=-2)  # (..., 3verts, 3)
    k = order_key(v)
    box = key_value(torch.stack([k.amin(dim=-2), k.amax(dim=-2)]))
    return Box(lo=box[0], hi=box[1])
