"""The port's CUDA kernels on the card, held against their plain versions.

A CUDA kernel has no CPU mode, so every test here needs a GPU; without one
each skips (decided inside the fixture, never at import).  On a GPU
machine:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Both sides round every op (the kernels are built with ``-fmad=false``
and explicit round-to-nearest intrinsics), so every field is bit-equal.
"""
import os

import numpy as np
import pytest
import torch

from repro_torch.api import RAY_TYPES, Scene, make_ray
from repro_torch.core.wavefront import trace_wavefront
from repro_torch.kernels import nvcc
from repro_torch.kernels.raybox import raybox, raybox_plain
from repro_torch.kernels.raytri import raytri, raytri_plain
from repro_torch.kernels.traverse import pack_bvh, traverse_packed

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _bits_equal(a, b):
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return torch.equal(a, b)


def _rays(rng, n):
    org = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    dirs = rng.normal(size=(n, 3)).astype(np.float32)
    dirs[rng.uniform(size=(n, 3)) < 0.1] = -0.0
    return make_ray(org, dirs, device="cuda")


@pytest.mark.parametrize("n", [1, 129, 4096])
def test_raybox_kernel_bit_equal_to_plain(cuda, n):
    rng = np.random.default_rng(n)
    ray = _rays(rng, n)
    lo = rng.uniform(-3, 2, (12, n)).astype(np.float32)
    hi = (lo + rng.uniform(0, 3, (12, n))).astype(np.float32)
    args = (ray.origin.T.contiguous(), ray.inv.T.contiguous(),
            torch.signbit(ray.direction).float().T.contiguous(),
            torch.as_tensor(lo, device=cuda), torch.as_tensor(hi, device=cuda))
    before = nvcc.launch_counts().get("raybox", 0)
    for k, p in zip(raybox(*args), raybox_plain(*args)):
        assert _bits_equal(k, p)
    assert nvcc.launch_counts()["raybox"] == before + 1


@pytest.mark.parametrize("n", [1, 129, 4096])
def test_raytri_kernel_bit_equal_to_plain(cuda, n):
    rng = np.random.default_rng(100 + n)
    ray = _rays(rng, n)
    verts = [torch.as_tensor(rng.normal(size=(3, n)).astype(np.float32),
                             device=cuda) for _ in range(3)]
    k = torch.stack([ray.kx, ray.ky, ray.kz]).contiguous()
    args = (ray.origin.T.contiguous(), ray.shear.T.contiguous(), k, *verts)
    for a, b in zip(raytri(*args), raytri_plain(*args)):
        assert _bits_equal(a, b)


@pytest.mark.parametrize("scene", ["tetra", "sheet", "cluster"])
def test_fused_kernel_and_cuda_backend_bit_equal_to_wavefront(cuda, scene):
    data = np.load(os.path.join(GOLDEN, f"{scene}.npz"))
    sc = Scene.from_triangles(data["tris"], device=cuda)
    rays = make_ray(data["ray_org"], data["ray_dir"], data["ray_extent"],
                    device=cuda)
    for ray_type in RAY_TYPES:
        want = trace_wavefront(sc.bvh, rays, sc.depth, ray_type=ray_type)
        for got in (traverse_packed(pack_bvh(sc.bvh), rays, sc.depth,
                                    ray_type=ray_type),
                    sc.engine().trace(rays, ray_type, chunk_size=16)):
            for f in want._fields:
                assert _bits_equal(getattr(got, f), getattr(want, f)), f


def test_wrappers_check_their_operands(cuda):
    x3 = torch.zeros((3, 8), device=cuda)
    x12 = torch.zeros((12, 8), device=cuda)
    with pytest.raises(ValueError, match="shape"):
        raybox(x3, x3, x3, x3, x12)
    with pytest.raises(ValueError, match="float32"):
        raybox(x3, x3, x3.double(), x12, x12)
    with pytest.raises(ValueError, match="contiguous"):
        raybox(x3, x3, x3, x12.T.contiguous().T, x12)
    with pytest.raises(ValueError, match="CUDA"):
        raytri(x3, x3.cpu(), x3.int(), x3, x3, x3)
