"""Plain oracles for the stage, distance and unified-stream kernels (the
``ref.py`` contract).

Each has the same signature as its wrapper in :mod:`.ops` and routes
through ``repro_torch.core.datapath``, ``repro_torch.core.knn`` or
``repro_torch.core.stream``.
"""
from __future__ import annotations

import torch

from ..core.datapath import ray_box_test, ray_triangle_test
from ..core.knn import angular_scores, euclidean_scores
from ..core.stream import DatapathJob, DatapathOutput, unified_stream
from ..core.types import Box, QuadBoxResult, Ray, Triangle, TriangleResult


def ray_box_ref(ray: Ray, boxes: Box) -> QuadBoxResult:
    return ray_box_test(ray, boxes)


def ray_triangle_ref(ray: Ray, tri: Triangle) -> TriangleResult:
    return ray_triangle_test(ray, tri)


def euclidean_ref(q: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """The matmul-form math of the kernel (norms expansion), (M, N) f32."""
    return euclidean_scores(q, c)


def euclidean_direct_ref(q: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """The paper's form: sum_k (q - c)^2 directly."""
    q, c = q.to(torch.float32), c.to(torch.float32)
    return ((q[:, None, :] - c[None, :, :]) ** 2).sum(-1)


def angular_ref(q: torch.Tensor, c: torch.Tensor):
    return angular_scores(q, c)


def unified_ref(jobs: DatapathJob) -> DatapathOutput:
    """Per-lane-stream oracle of :func:`.ops.unified_datapath`: jobs leaves
    (T, 128, ...), each lane an independent in-order stream of T jobs, run
    side by side by ``unified_stream`` with a (128,) state."""
    return unified_stream(jobs)[1]
