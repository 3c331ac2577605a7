"""Plain oracles for the stage kernels (the ``ref.py`` contract).

Each has the same signature as its wrapper in :mod:`.ops` and routes
through ``repro_torch.core.datapath``.
"""
from __future__ import annotations

from ..core.datapath import ray_box_test, ray_triangle_test
from ..core.types import Box, QuadBoxResult, Ray, Triangle, TriangleResult


def ray_box_ref(ray: Ray, boxes: Box) -> QuadBoxResult:
    return ray_box_test(ray, boxes)


def ray_triangle_ref(ray: Ray, tri: Triangle) -> TriangleResult:
    return ray_triangle_test(ray, tri)
