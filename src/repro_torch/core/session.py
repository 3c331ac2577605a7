"""Session query surface, trace half: build a :class:`Scene` once, query
its :class:`QueryEngine`.

The port's counterpart of the trace surface of ``repro/core/session.py``.
Trace backends are pluggable and return the same :class:`TraceResult`:

* ``"wavefront"`` -- the plain batch-level engine
  (``core/wavefront.trace_wavefront``), on any device;
* ``"cuda"`` -- the fused traversal kernel (``kernels/traverse.
  traverse_packed``; ``csrc/traverse.cu``), whose ``prepare`` hook packs
  the tree once per scene version and whose batches are padded to whole
  128-ray blocks;
* ``"auto"`` -- ``"cuda"`` for a scene on a CUDA device, ``"wavefront"``
  for a scene on the CPU.

Every query runs ``pad -> query -> unpad`` through ``core/dispatch``;
``chunk_size`` streams a batch through fixed-size blocks, and ``rounds``
reduces by max over blocks.  Not ported yet: ``refit``, ``stats``,
sharding and the ``per_ray`` oracle.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from ..kernels.common import LANES
from .build import build as build_structure
from .bvh import BVH4, DatapathConfig, resolve_config
from .device import resolve_device
from .dispatch import check_count, check_shards, concat_rows, make_plan, split_blocks
from .types import Ray, Triangle
from .wavefront import RAY_TYPES, default_t_min, trace_wavefront


class TraceResult(NamedTuple):
    """Traversal result: identical fields for every trace backend."""

    t: torch.Tensor  # (R,) f32  hit distance (inf = miss)
    tri_index: torch.Tensor  # (R,) i32  index into the soup, -1 = miss
    hit: torch.Tensor  # (R,) bool
    quadbox_jobs: torch.Tensor  # (R,) i32  per-ray box-test jobs issued
    triangle_jobs: torch.Tensor  # (R,) i32  per-ray OpTriangle jobs issued
    stack_overflow: torch.Tensor  # (R,) bool  a push was dropped at capacity
    rounds: torch.Tensor  # ()   i32  batch-level rounds (= max per-ray jobs)


#: padding multiple of every batch (the cuda backend raises it to LANES)
DEFAULT_PAD_MULTIPLE = 8

# name -> (supported ray types,
#          build(scene, ray_type, t_min, max_rounds) -> fn(ctx, rays),
#          row multiple the backend wants, or None,
#          optional prepare(scene) -> fn(bvh) -> ctx, run once per version)
_TRACE_BACKENDS: dict[str, tuple] = {}


def register_trace_backend(name: str, ray_types=RAY_TYPES,
                           lane_multiple: int | None = None,
                           prepare: Callable | None = None):
    """Register a traversal backend under ``name``.  ``build(scene,
    ray_type, t_min, max_rounds)`` returns ``fn(ctx, rays) -> TraceResult``;
    ``ctx`` is the BVH, or ``prepare(scene)(bvh)`` when a prepare hook is
    given (computed once per scene version)."""
    def deco(build):
        _TRACE_BACKENDS[name] = (tuple(ray_types), build, lane_multiple, prepare)
        return build
    return deco


def trace_backends() -> tuple[str, ...]:
    return tuple(_TRACE_BACKENDS)


def trace_backend_ray_types(name: str) -> tuple[str, ...]:
    if name not in _TRACE_BACKENDS:
        raise ValueError(f"unknown trace backend {name!r} "
                         f"(registered: {trace_backends()})")
    return _TRACE_BACKENDS[name][0]


@register_trace_backend("wavefront", ray_types=RAY_TYPES)
def _build_wavefront(scene: "Scene", ray_type: str, t_min: float, max_rounds):
    """The plain batch-level frontier loop, on the scene's device."""
    def run(bvh, rays):
        return TraceResult(*trace_wavefront(
            bvh, rays, scene.depth, ray_type=ray_type, t_min=t_min,
            max_rounds=max_rounds, config=scene.config))
    return run


def _prepare_cuda_trace(scene: "Scene"):
    from ..kernels.traverse import pack_bvh
    return lambda bvh: pack_bvh(bvh, scene.config)


@register_trace_backend("cuda", ray_types=RAY_TYPES, lane_multiple=LANES,
                        prepare=_prepare_cuda_trace)
def _build_cuda_trace(scene: "Scene", ray_type: str, t_min: float, max_rounds):
    """The fused CUDA traversal kernel on the packed tree."""
    from ..kernels.traverse import traverse_packed

    def run(ctx, rays):
        return TraceResult(*traverse_packed(
            ctx, rays, scene.depth, ray_type=ray_type, t_min=t_min,
            max_rounds=max_rounds, config=scene.config))
    return run


def _as_triangles(triangles, device: torch.device) -> Triangle:
    """A :class:`Triangle` soup or an ``(N, 3, 3)`` vertex array -> f32
    tensors on ``device``."""
    if isinstance(triangles, Triangle):
        return Triangle(*[torch.as_tensor(v).to(device=device,
                                                dtype=torch.float32).contiguous()
                          for v in triangles])
    arr = torch.as_tensor(np.asarray(triangles, np.float32)
                          if not isinstance(triangles, torch.Tensor)
                          else triangles).to(device=device, dtype=torch.float32)
    if arr.ndim != 3 or tuple(arr.shape[1:]) != (3, 3):
        raise ValueError(f"expected Triangle or (N, 3, 3) vertices, "
                         f"got {tuple(arr.shape)}")
    return Triangle(*[arr[:, i].contiguous() for i in range(3)])


def _validate_finite(tri: Triangle, where: str) -> None:
    if not bool(torch.isfinite(torch.stack(list(tri))).all()):
        raise ValueError(f"{where}: triangle vertices must be finite (no "
                         "NaN/inf); one bad vertex poisons the scene bounds")


class Scene:
    """A prepared triangle scene: ``BVH4`` + its static traversal depth,
    on one device."""

    def __init__(self, bvh: BVH4, depth: int, builder: str = "lbvh",
                 config: DatapathConfig | None = None):
        self.bvh = bvh
        self.depth = int(depth)
        self.builder = builder
        self.config = resolve_config(config)
        #: bumped when the geometry changes; engines re-prepare on it
        self.version = 0

    @classmethod
    def from_triangles(cls, triangles, depth: int | None = None, device=None,
                       builder: str = "lbvh",
                       config: DatapathConfig | None = None) -> "Scene":
        """Build from a :class:`Triangle` soup or an ``(N, 3, 3)`` array with
        the named builder, on ``device`` (default CUDA, raising without a
        GPU; pass ``device="cpu"`` for the plain path)."""
        tri = _as_triangles(triangles, resolve_device(device))
        _validate_finite(tri, "Scene.from_triangles")
        res = build_structure(tri, builder, depth, config=config)
        return cls(res.bvh, res.depth, builder=res.builder, config=res.config)

    @property
    def device(self) -> torch.device:
        return self.bvh.node_lo.device

    @property
    def num_triangles(self) -> int:
        return int(self.bvh.triangles.a.shape[0])

    def engine(self, **kwargs) -> "QueryEngine":
        return QueryEngine(scene=self, **kwargs)

    def __repr__(self):
        return (f"Scene(num_triangles={self.num_triangles}, depth={self.depth}, "
                f"builder={self.builder!r}, device={str(self.device)!r})")


class QueryEngine:
    """Query session over a :class:`Scene`.

    ``backend="auto"`` picks ``"cuda"`` for a scene on a CUDA device and
    ``"wavefront"`` on the CPU.  ``chunk_size`` (engine-wide or per call)
    streams a batch through fixed-size blocks; ``shard`` must be 1 (or
    None) until sharding is ported.  Zero-row batches return a typed empty
    result without launching anything.
    """

    def __init__(self, scene: Scene, *, backend: str = "auto",
                 pad_multiple: int | None = None, shard=None,
                 chunk_size: int | None = None):
        self.scene = scene
        self.default_backend = backend
        check_shards(shard)
        self.default_chunk_size = check_count("chunk_size", chunk_size)
        self.pad_multiple = (DEFAULT_PAD_MULTIPLE if pad_multiple is None
                             else max(1, int(pad_multiple)))
        self._ctx: dict = {}  # (backend, scene version) -> prepared ctx

    def resolve_trace_backend(self) -> str:
        return "cuda" if self.scene.device.type == "cuda" else "wavefront"

    def _trace_ctx(self, name: str, prepare):
        if prepare is None:
            return self.scene.bvh
        key = (name, self.scene.version)
        if key not in self._ctx:
            self._ctx = {k: v for k, v in self._ctx.items() if k[0] != name}
            self._ctx[key] = prepare(self.scene)(self.scene.bvh)
        return self._ctx[key]

    def trace(self, rays: Ray, ray_type: str = "closest", *,
              backend: str | None = None, t_min: float | None = None,
              max_rounds: int | None = None, shard=None,
              chunk_size: int | None = None) -> TraceResult:
        """Traverse a ray batch: ``ray_type`` is ``"closest"`` | ``"any"`` |
        ``"shadow"``.  Results are bit-identical whatever ``chunk_size``."""
        if ray_type not in RAY_TYPES:
            raise ValueError(f"ray_type must be one of {RAY_TYPES}, got {ray_type!r}")
        if t_min is None:
            t_min = default_t_min(ray_type)
        t_min = float(t_min)
        check_shards(shard)
        chunk_size = check_count("chunk_size", chunk_size)
        if chunk_size is None:
            chunk_size = self.default_chunk_size
        name = backend or self.default_backend
        if name == "auto":
            name = self.resolve_trace_backend()
        if name not in _TRACE_BACKENDS:
            raise ValueError(f"unknown trace backend {name!r} "
                             f"(registered: {trace_backends()})")
        supported, build, lane_multiple, prepare = _TRACE_BACKENDS[name]
        if ray_type not in supported:
            raise ValueError(f"backend {name!r} supports ray types {supported}, "
                             f"got {ray_type!r}")
        if rays.origin.device != self.scene.device:
            raise ValueError(f"rays on {rays.origin.device}, scene on "
                             f"{self.scene.device}")
        n = rays.origin.shape[0]
        dev = self.scene.device
        if n == 0:  # empty guard: typed empty result, nothing launched
            z = torch.zeros((0,), dtype=torch.int32, device=dev)
            return TraceResult(t=torch.zeros((0,), device=dev), tri_index=z,
                               hit=z.bool(), quadbox_jobs=z, triangle_jobs=z,
                               stack_overflow=z.bool(),
                               rounds=torch.zeros((), dtype=torch.int32,
                                                  device=dev))

        plan = make_plan(n, pad_multiple=self.pad_multiple,
                         chunk_size=chunk_size, lane_multiple=lane_multiple)
        run = build(self.scene, ray_type, t_min, max_rounds)
        ctx = self._trace_ctx(name, prepare)
        outs = [run(ctx, block) for block in split_blocks(rays, plan)]
        rounds = torch.stack([o.rounds for o in outs]).max()
        rows = concat_rows([o[:-1] for o in outs], n)
        return TraceResult(*rows, rounds=rounds)

    def __repr__(self):
        return f"QueryEngine(scene={self.scene!r}, backend={self.default_backend!r})"
