"""OpQuadbox kernel wrapper (``csrc/raybox.cu``) and its plain version.

The port's counterpart of ``repro/kernels/raybox.py``: the same
rows-by-jobs operands (one job per column), the same outputs.  On CUDA
tensors :func:`raybox` launches the hand-written kernel; on CPU tensors
it runs :func:`raybox_plain`, which is ``core.datapath.ray_box_test`` on
the same operands.
"""
from __future__ import annotations

import torch

from ..core.datapath import ray_box_test
from ..core.types import Box, Ray
from . import nvcc


def raybox_plain(org, inv, neg, box_lo, box_hi):
    """:func:`raybox` through ``ray_box_test`` (any device)."""
    n = org.shape[1]
    direction = torch.where(neg > 0.5, -1.0, 1.0).T  # carries the sign bit
    z = torch.zeros((n,), dtype=torch.int32, device=org.device)
    ray = Ray(origin=org.T, direction=direction, inv=inv.T,
              extent=torch.zeros((n,), device=org.device), kx=z, ky=z, kz=z,
              shear=inv.T)
    boxes = Box(lo=box_lo.T.reshape(n, 4, 3), hi=box_hi.T.reshape(n, 4, 3))
    res = ray_box_test(ray, boxes)
    return (res.tmin.T.contiguous(), res.box_index.T.contiguous(),
            res.is_intersect.T.to(torch.int32).contiguous())


def raybox(org, inv, neg, box_lo, box_hi):
    """org/inv/neg: (3, N) f32 (neg = 1.0 where the direction's sign bit is
    set); box_lo/hi: (12, N) f32, row ``3*box + dim``.  Returns tmin (4, N)
    f32 sorted ascending, idx (4, N) i32 and hit (4, N) i32."""
    if not org.is_cuda:
        return raybox_plain(org, inv, neg, box_lo, box_hi)
    n = org.shape[1]
    f32, dev = torch.float32, org.device
    ptrs = [nvcc.check_cuda("org", org, f32, (3, n)),
            nvcc.check_cuda("inv", inv, f32, (3, n), dev),
            nvcc.check_cuda("neg", neg, f32, (3, n), dev),
            nvcc.check_cuda("box_lo", box_lo, f32, (12, n), dev),
            nvcc.check_cuda("box_hi", box_hi, f32, (12, n), dev)]
    tmin = torch.empty((4, n), dtype=f32, device=dev)
    idx = torch.empty((4, n), dtype=torch.int32, device=dev)
    hit = torch.empty((4, n), dtype=torch.int32, device=dev)
    nvcc.launch("rayflex_raybox", dev, *ptrs, tmin.data_ptr(), idx.data_ptr(),
                hit.data_ptr(), n)
    return tmin, idx, hit
