"""OpTriangle kernel wrapper (``csrc/raytri.cu``) and its plain version.

The port's counterpart of ``repro/kernels/raytri.py``, with one change of
layout: ``k`` (kx, ky, kz) is an int32 operand rather than f32-encoded.
On CUDA tensors :func:`raytri` launches the hand-written kernel; on CPU
tensors it runs :func:`raytri_plain`, which is
``core.datapath.ray_triangle_test`` on the same operands.
"""
from __future__ import annotations

import torch

from ..core.datapath import ray_triangle_test
from ..core.types import Ray, Triangle
from . import nvcc


def raytri_plain(org, shear, k, va, vb, vc):
    """:func:`raytri` through ``ray_triangle_test`` (any device)."""
    n = org.shape[1]
    ray = Ray(origin=org.T, direction=shear.T, inv=shear.T,
              extent=torch.zeros((n,), device=org.device),
              kx=k[0], ky=k[1], kz=k[2], shear=shear.T)
    res = ray_triangle_test(ray, Triangle(va.T, vb.T, vc.T))
    return (res.t_num.contiguous(), res.t_denom.contiguous(),
            res.hit.to(torch.int32))


def raytri(org, shear, k, va, vb, vc):
    """org/shear/va/vb/vc: (3, N) f32; k: (3, N) i32.  Returns t_num (N,)
    f32, t_denom (N,) f32 and hit (N,) i32."""
    if not org.is_cuda:
        return raytri_plain(org, shear, k, va, vb, vc)
    n = org.shape[1]
    f32, dev = torch.float32, org.device
    ptrs = [nvcc.check_cuda("org", org, f32, (3, n)),
            nvcc.check_cuda("shear", shear, f32, (3, n), dev),
            nvcc.check_cuda("k", k, torch.int32, (3, n), dev),
            nvcc.check_cuda("va", va, f32, (3, n), dev),
            nvcc.check_cuda("vb", vb, f32, (3, n), dev),
            nvcc.check_cuda("vc", vc, f32, (3, n), dev)]
    t_num = torch.empty((n,), dtype=f32, device=dev)
    t_denom = torch.empty((n,), dtype=f32, device=dev)
    hit = torch.empty((n,), dtype=torch.int32, device=dev)
    nvcc.launch("rayflex_raytri", dev, *ptrs, t_num.data_ptr(), t_denom.data_ptr(),
                hit.data_ptr(), n)
    return t_num, t_denom, hit
