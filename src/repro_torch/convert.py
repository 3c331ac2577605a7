"""Carry state across from the reference package, through numpy.

The port imports nothing of ``repro``; a caller who holds a ``repro``
BVH, ray batch, vector index, point cloud or datapath job stream passes
its arrays as numpy and gets the port's objects back.  With these,
traversal parity can be tested apart from builder parity: both packages
traverse the very same tree.
"""
from __future__ import annotations

import numpy as np
import torch

from .core.bvh import BVH4, DEFAULT_CONFIG
from .core.device import resolve_device
from .core.session import PointCloudScene, VectorIndex
from .core.stream import DatapathJob
from .core.types import Box, DatapathState, Ray, Triangle


def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(np.array(x, dtype=np.float32), device=device)


def _i32(x, device) -> torch.Tensor:
    return torch.as_tensor(np.array(x, dtype=np.int32), device=device)


def bvh_from_numpy(node_lo, node_hi, leaf_tri, a, b, c, leaf_perm, *,
                   device=None) -> BVH4:
    """A ``repro`` ``BVH4``'s arrays (as numpy) -> the port's ``BVH4``."""
    device = resolve_device(device)
    return BVH4(node_lo=_f32(node_lo, device), node_hi=_f32(node_hi, device),
                leaf_tri=_i32(leaf_tri, device),
                triangles=Triangle(_f32(a, device), _f32(b, device),
                                   _f32(c, device)),
                leaf_perm=_i32(leaf_perm, device))


def rays_from_numpy(origin, direction, inv, extent, kx, ky, kz, shear, *,
                    device=None) -> Ray:
    """A ``repro`` ``Ray``'s fields (as numpy) -> the port's ``Ray``."""
    device = resolve_device(device)
    return Ray(origin=_f32(origin, device), direction=_f32(direction, device),
               inv=_f32(inv, device), extent=_f32(extent, device),
               kx=_i32(kx, device), ky=_i32(ky, device), kz=_i32(kz, device),
               shear=_f32(shear, device))


def index_from_numpy(database, sq_norms=None, *, device=None) -> VectorIndex:
    """A ``repro`` ``VectorIndex``'s database (and, optionally, its
    ``sq_norms``) as numpy -> the port's ``VectorIndex``."""
    device = resolve_device(device)
    return VectorIndex(_f32(database, device),
                       None if sq_norms is None else _f32(sq_norms, device),
                       device=device)


def point_cloud_from_numpy(node_lo, node_hi, leaf_tri, points, leaf_perm, depth,
                           *, device=None) -> PointCloudScene:
    """A ``repro`` point BVH's arrays (as numpy; ``points`` is its
    ``triangles.a``) -> the port's ``PointCloudScene`` over the same tree."""
    device = resolve_device(device)
    pts = _f32(points, device)
    bvh = BVH4(node_lo=_f32(node_lo, device), node_hi=_f32(node_hi, device),
               leaf_tri=_i32(leaf_tri, device), triangles=Triangle(pts, pts, pts),
               leaf_perm=_i32(leaf_perm, device))
    return PointCloudScene(bvh, int(depth), config=DEFAULT_CONFIG)


def jobs_from_numpy(jobs, *, device=None) -> DatapathJob:
    """A ``repro`` ``DatapathJob`` whose leaves are numpy arrays (for
    example ``jax.tree.map(np.asarray, jobs)``) -> the port's
    ``DatapathJob``, field by field."""
    device = resolve_device(device)
    r = jobs.ray
    return DatapathJob(
        opcode=_i32(jobs.opcode, device),
        ray=rays_from_numpy(r.origin, r.direction, r.inv, r.extent, r.kx, r.ky,
                            r.kz, r.shear, device=device),
        boxes=Box(_f32(jobs.boxes.lo, device), _f32(jobs.boxes.hi, device)),
        triangle=Triangle(*(_f32(v, device) for v in jobs.triangle)),
        vec_a=_f32(jobs.vec_a, device), vec_b=_f32(jobs.vec_b, device),
        mask=torch.as_tensor(np.array(jobs.mask, dtype=bool), device=device),
        reset_accum=torch.as_tensor(np.array(jobs.reset_accum, dtype=bool),
                                    device=device))


def datapath_state_from_numpy(state, *, device=None) -> DatapathState:
    """A ``repro`` ``DatapathState`` with numpy leaves -> the port's."""
    device = resolve_device(device)
    return DatapathState(*(_f32(x, device) for x in state))
