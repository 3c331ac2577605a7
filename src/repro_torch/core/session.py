"""Session query surface: build a :class:`Scene`, :class:`VectorIndex` or
:class:`PointCloudScene` once, query its :class:`QueryEngine`.

The port's counterpart of ``repro/core/session.py``.  Backends are
pluggable, and every backend of a kind returns the same record.

Trace backends (:class:`TraceResult`):

* ``"per_ray"`` -- the oracle (``core/traversal.trace_rays``): one ray at a
  time on a host-side stack, closest hits only;
* ``"wavefront"`` -- the plain batch-level engine
  (``core/wavefront.trace_wavefront``), on any device;
* ``"cuda"`` -- the fused traversal kernel (``kernels/traverse.
  traverse_packed``; ``csrc/traverse.cu``), whose ``prepare`` hook packs
  the tree once per scene version and whose batches are padded to whole
  128-ray blocks.

Distance backends (scores for ``nearest`` / ``within`` / ``count_within``
/ ``scores``):

* ``"mxu"`` -- the plain matmul form with the index's ``||c||^2``
  (``core/knn.pairwise_scores``, TF32 off), on any device;
* ``"cuda"`` -- the distance kernel (``kernels/ops``; ``csrc/
  distance.cu``), cosine normalised by the index's precomputed norms.

Neighbour backends (tree search over a point cloud, :class:`NeighborRecord`):

* ``"tree_wavefront"`` -- the plain batch-level engine
  (``core/neighbor.neighbor_wavefront``), on any device;
* ``"tree_cuda"`` -- the fused neighbour kernel (``kernels/traverse.
  neighbor_packed``; ``csrc/neighbor.cu``), packed once per cloud version,
  batches padded to whole 128-query blocks; on a CPU cloud it is the
  kernel's plain version, ``tree_wavefront``.

``"auto"`` picks the kernel backend for data on a CUDA device and the
plain one on the CPU; neighbour queries also choose tree or brute force
by cloud size and selectivity (:meth:`QueryEngine.resolve_neighbor_backend`).

Every query runs ``pad -> query -> unpad`` through ``core/dispatch``;
``chunk_size`` streams a batch through fixed-size blocks, and ``rounds``
reduces by max over blocks.  ``shard="auto"`` resolves to one shard on
one card (:func:`~repro_torch.core.dispatch.resolve_shards`).  The engine
counts the run functions it builds per (query, backend, static
parameters, plan, row signature), keyed as the reference keys its
compiled functions (:meth:`QueryEngine.cache_info`), and prepares each
backend's context once per scene or cloud version, so an animated scene
(:meth:`Scene.refit`, :meth:`PointCloudScene.refit`) misses no key per
frame and re-packs once.  Every :class:`~repro_torch.core.bvh.DatapathConfig`
(arity 4 or 8, any stack size, the bf16 and compressed node codecs) and
both builders (``"lbvh"``, ``"sah"``) serve every backend.  Not ported
yet: the fan-out over several cards.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple

import numpy as np
import torch

from ..kernels.common import LANES
from .build import build as build_structure
from .build import refit as refit_bvh
from .build import tree_stats
from .build.points import build_point_bvh, refit_points
from .build.quality import TreeStats
from .bvh import BVH4, DatapathConfig, resolve_config
from .device import resolve_device
from .dispatch import (ExecPlan, check_count, concat_rows, make_plan, resolve_shards,
                       split_blocks)
from .knn import (METRICS, RADIUS_METRICS, angular_scores, check_k, check_radius,
                  cosine_epilogue, cosine_similarity, count_within_scores, knn,
                  pairwise_scores, radius_count, radius_search, select_topk,
                  select_within)
from .neighbor import (NeighborRecord, empty_neighbors, neighbor_wavefront,
                       point_queries, point_sq_norms)
from .traversal import trace_rays
from .types import Ray, Triangle, as_f32
from .wavefront import RAY_TYPES, SHADOW_T_MIN, default_t_min, trace_wavefront


class TraceResult(NamedTuple):
    """Traversal result: identical fields for every trace backend."""

    t: torch.Tensor  # (R,) f32  hit distance (inf = miss)
    tri_index: torch.Tensor  # (R,) i32  index into the soup, -1 = miss
    hit: torch.Tensor  # (R,) bool
    quadbox_jobs: torch.Tensor  # (R,) i32  per-ray box-test jobs issued
    triangle_jobs: torch.Tensor  # (R,) i32  per-ray OpTriangle jobs issued
    stack_overflow: torch.Tensor  # (R,) bool  a push was dropped at capacity
    rounds: torch.Tensor  # ()   i32  batch-level rounds (= max per-ray jobs)


class NearestResult(NamedTuple):
    """k-nearest result: scores ascending (euclidean) / descending (angular,
    cosine), indices into the database.  ``k`` clamps to the database
    size; the excess slots carry inf / -inf, index -1 and ``valid`` False."""

    scores: torch.Tensor  # (M, k) f32
    indices: torch.Tensor  # (M, k) i32
    valid: torch.Tensor  # (M, k) bool  which slots hold real neighbours


class WithinResult(NamedTuple):
    """Fixed-radius result: top-k by proximity with an in-radius mask."""

    scores: torch.Tensor  # (M, k) f32
    indices: torch.Tensor  # (M, k) i32
    within: torch.Tensor  # (M, k) bool  which of the k slots are in range


class CacheInfo(NamedTuple):
    hits: int
    misses: int
    entries: int


#: padding multiple of every batch (the kernel backends raise it to LANES)
DEFAULT_PAD_MULTIPLE = 8


def _elem_key(tree) -> tuple:
    """Per-row signature: each leaf's trailing shape and dtype."""
    return tuple((tuple(x.shape[1:]), str(x.dtype)) for x in tree)

# name -> (supported ray types,
#          build(scene, ray_type, t_min, max_rounds) -> fn(ctx, rays),
#          row multiple the backend wants, or None,
#          optional prepare(scene) -> fn(bvh) -> ctx, run once per version)
_TRACE_BACKENDS: dict[str, tuple] = {}

# name -> build(index, metric) -> fn(queries) -> (M, N) scores (squared
# distances for euclidean, similarities otherwise)
_DISTANCE_BACKENDS: dict[str, Callable] = {}

# name -> (build(cloud, mode, k) -> fn(ctx, rays) -> NeighborRecord,
#          row multiple the backend wants, or None,
#          prepare(cloud) -> fn(bvh) -> ctx, run once per cloud version)
_NEIGHBOR_BACKENDS: dict[str, tuple] = {}


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


def register_distance_backend(name: str):
    """Register a distance backend: ``build(index, metric)`` returns
    ``fn(queries) -> (M, N) scores``."""
    def deco(build):
        _DISTANCE_BACKENDS[name] = build
        return build
    return deco


def register_neighbor_backend(name: str, lane_multiple: int | None = None,
                              prepare: Callable | None = None):
    """Register a tree-backed neighbour backend: ``build(cloud, mode, k)``
    returns ``fn(ctx, rays) -> NeighborRecord``, where the rays are
    :func:`~repro_torch.core.neighbor.point_queries` bundles and ``ctx`` is
    ``prepare(cloud)(bvh)`` (the BVH itself without a prepare hook)."""
    def deco(build):
        _NEIGHBOR_BACKENDS[name] = (build, lane_multiple, prepare)
        return build
    return deco


def trace_backends() -> tuple[str, ...]:
    return tuple(_TRACE_BACKENDS)


def distance_backends() -> tuple[str, ...]:
    return tuple(_DISTANCE_BACKENDS)


def neighbor_backends() -> tuple[str, ...]:
    return tuple(_NEIGHBOR_BACKENDS)


def trace_backend_ray_types(name: str) -> tuple[str, ...]:
    if name not in _TRACE_BACKENDS:
        raise ValueError(f"unknown trace backend {name!r} "
                         f"(registered: {trace_backends()})")
    return _TRACE_BACKENDS[name][0]


@register_trace_backend("per_ray", ray_types=("closest",))
def _build_per_ray(scene: "Scene", ray_type: str, t_min: float, max_rounds):
    """The per-ray oracle (closest hits only), on the scene's device."""
    if t_min:
        raise ValueError("per_ray backend has no t_min support; "
                         "use backend='wavefront'")
    if max_rounds is not None:
        raise ValueError("per_ray backend has no max_rounds support; "
                         "use backend='wavefront'")

    def run(bvh, rays):
        rec = trace_rays(bvh, rays, scene.depth, scene.config)
        # a ray is active for exactly quadbox_jobs consecutive rounds, so
        # the batch-level round count is the max per-ray job count
        return TraceResult(*rec, rounds=rec.quadbox_jobs.max())
    return run


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


@register_distance_backend("mxu")
def _build_mxu_scores(index: "VectorIndex", metric: str):
    """The plain matmul form with the index's precomputed ||c||^2."""
    db, c2 = index.database, index.sq_norms
    return lambda q: pairwise_scores(q, db, metric, c_sq_norms=c2)


@register_distance_backend("cuda")
def _build_cuda_scores(index: "VectorIndex", metric: str):
    """The distance kernel; cosine divides the kernel's dots by the
    index's precomputed norms (OpAngular's second output, computed once
    with the index)."""
    from ..kernels import ops as kops

    db = index.database
    if metric == "euclidean":
        return lambda q: kops.euclidean_kernel(q, db)
    if metric == "angular":
        return lambda q: kops.dot_kernel(q, db)
    if metric == "cosine":
        c2 = index.sq_norms
        return lambda q: cosine_epilogue(kops.dot_kernel(q, db), c2, q)
    raise ValueError(f"unknown metric: {metric} (want one of {METRICS})")


def _prepare_tree_wavefront(cloud: "PointCloudScene"):
    """The plain engine's ctx: the BVH and its points' ||c||^2, derived
    from the array the tree holds."""
    return lambda bvh: (bvh, point_sq_norms(bvh.triangles.a))


@register_neighbor_backend("tree_wavefront", prepare=_prepare_tree_wavefront)
def _build_tree_wavefront(cloud: "PointCloudScene", mode: str, k: int):
    """The plain batch-level neighbour loop, on the cloud's device."""
    def run(ctx, rays):
        bvh, sq = ctx
        return neighbor_wavefront(bvh, sq, rays, cloud.depth, k=k, mode=mode)
    return run


def _prepare_tree_cuda(cloud: "PointCloudScene"):
    if cloud.device.type != "cuda":
        return _prepare_tree_wavefront(cloud)
    from ..kernels.traverse import pack_point_bvh
    return pack_point_bvh


@register_neighbor_backend("tree_cuda", lane_multiple=LANES,
                           prepare=_prepare_tree_cuda)
def _build_tree_cuda(cloud: "PointCloudScene", mode: str, k: int):
    """The fused CUDA neighbour kernel on the packed cloud (its plain
    version on a CPU cloud)."""
    if cloud.device.type != "cuda":
        return _build_tree_wavefront(cloud, mode, k)
    from ..kernels.traverse import neighbor_packed

    def run(ctx, rays):
        return neighbor_packed(ctx, rays, cloud.depth, k, mode=mode)
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

    def refit(self, triangles) -> "Scene":
        """Move the scene's geometry in place, keeping its topology: the
        same soup (same count, same order) with moved vertices.  Re-sweeps
        the boxes (``core/build/refit.refit``), bumps :attr:`version` so
        engines re-prepare once, and returns ``self``."""
        tri = _as_triangles(triangles, self.device)
        _validate_finite(tri, "Scene.refit")
        self.bvh = refit_bvh(self.bvh, tri, self.config)
        self.version += 1
        return self

    def stats(self, rays: Ray | None = None, probes: int = 256) -> TreeStats:
        """Tree quality: SAH cost plus mean datapath jobs per ray measured
        on ``rays`` (or a deterministic probe batch) on the scene's
        device."""
        return tree_stats(self.bvh, self.builder, rays=rays, probes=probes,
                          config=self.config)

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
                f"builder={self.builder!r}, config={self.config.tag!r}, "
                f"device={str(self.device)!r})")


def _validate_points_finite(points: torch.Tensor, where: str) -> None:
    if not bool(torch.isfinite(points).all()):
        raise ValueError(f"{where}: points must be finite (no NaN/inf); one "
                         "bad point poisons the cloud bounds")


def _on_device(x, device: torch.device, what: str) -> torch.Tensor:
    """A query batch as f32 on ``device``: numpy goes there, a tensor must
    already be there."""
    if isinstance(x, torch.Tensor):
        if x.device != device:
            raise ValueError(f"{what} on {x.device}, data on {device}")
        return x.to(torch.float32).contiguous()
    return as_f32(x, device)


class VectorIndex:
    """A prepared vector database: the candidate matrix and its ||c||^2.

    The norms are OpAngular's second output, computed once at build time
    (by the norm kernel for a database on a CUDA device, by its plain
    version on the CPU) and reused by every query."""

    def __init__(self, database, sq_norms=None, device=None):
        device = resolve_device(device)
        self.database = as_f32(database, device)
        if self.database.ndim != 2:
            raise ValueError(f"expected an (N, D) database, got "
                             f"{tuple(self.database.shape)}")
        if sq_norms is None:
            from ..kernels.distance import norms_cuda
            sq_norms = norms_cuda(self.database)[0]
        self.sq_norms = as_f32(sq_norms, device)

    @classmethod
    def from_database(cls, database, device=None) -> "VectorIndex":
        """Build on ``device`` (default CUDA, raising without a GPU; pass
        ``device="cpu"`` for the plain path)."""
        return cls(database, device=device)

    @property
    def device(self) -> torch.device:
        return self.database.device

    @property
    def size(self) -> int:
        return int(self.database.shape[0])

    @property
    def dim(self) -> int:
        return int(self.database.shape[-1])

    def _q(self, queries) -> torch.Tensor:
        return _on_device(queries, self.device, "queries")

    def dots(self, queries) -> torch.Tensor:
        """OpAngular dot products only.  (M, D) -> (M, N)."""
        return angular_scores(self._q(queries), self.database,
                              c_sq_norms=self.sq_norms)[0]

    def cosine_similarity(self, queries) -> torch.Tensor:
        return cosine_similarity(self._q(queries), self.database,
                                 c_sq_norms=self.sq_norms)

    def knn(self, queries, k: int, metric: str = "euclidean"):
        return knn(self._q(queries), self.database, k, metric,
                   c_sq_norms=self.sq_norms)

    def radius_search(self, queries, radius: float, k: int,
                      metric: str = "euclidean"):
        return radius_search(self._q(queries), self.database, radius, k, metric,
                             c_sq_norms=self.sq_norms)

    def radius_count(self, queries, radius: float, metric: str = "euclidean"):
        return radius_count(self._q(queries), self.database, radius, metric,
                            c_sq_norms=self.sq_norms)

    def engine(self, **kwargs) -> "QueryEngine":
        return QueryEngine(index=self, **kwargs)

    def __repr__(self):
        return (f"VectorIndex(size={self.size}, dim={self.dim}, "
                f"device={str(self.device)!r})")


class PointCloudScene:
    """A prepared point cloud: a BVH4 over AABB-per-point leaves plus the
    :class:`VectorIndex` over the same points, so one engine serves the
    tree backends and the brute-force distance backends."""

    def __init__(self, bvh: BVH4, depth: int, builder: str = "lbvh",
                 config: DatapathConfig | None = None):
        self.bvh = bvh
        self.depth = int(depth)
        self.builder = builder
        self.config = resolve_config(config)
        #: bumped when the points change; engines re-prepare on it
        self.version = 0
        self.index = VectorIndex(bvh.triangles.a, device=bvh.node_lo.device)
        self._root_vol: float | None = None

    @classmethod
    def from_points(cls, points, depth: int | None = None, device=None,
                    builder: str = "lbvh",
                    config: DatapathConfig | None = None) -> "PointCloudScene":
        """Build from an ``(N, 3)`` point array with the named builder core
        (``"lbvh"`` or ``"sah"``) on ``device`` (default CUDA, raising
        without a GPU; pass ``device="cpu"`` for the plain path).  ``config``
        may pick a node-box codec; point trees stay 4-wide."""
        points = as_f32(points, resolve_device(device))
        _validate_points_finite(points, "PointCloudScene.from_points")
        res = build_point_bvh(points, builder, depth, config=config)
        return cls(res.bvh, res.depth, builder=res.builder, config=res.config)

    def refit(self, points) -> "PointCloudScene":
        """Move the cloud's points in place, keeping its topology (same
        count, same order): the cull-free refit, then the index rebuilt so
        its norms are re-derived, and :attr:`version` bumped so engines
        re-prepare once.  Returns ``self``."""
        points = as_f32(points, self.device)
        _validate_points_finite(points, "PointCloudScene.refit")
        self.bvh = refit_points(self.bvh, points, self.config)
        self.index = VectorIndex(self.bvh.triangles.a, device=self.device)
        self.version += 1
        self._root_vol = None
        return self

    @property
    def device(self) -> torch.device:
        return self.bvh.node_lo.device

    @property
    def points(self) -> torch.Tensor:
        return self.bvh.triangles.a

    @property
    def size(self) -> int:
        return int(self.bvh.triangles.a.shape[0])

    def root_volume(self) -> float:
        """Volume of the root AABB: the denominator of the auto policy's
        radius-selectivity estimate."""
        if self._root_vol is None:
            ext = (self.bvh.node_hi[0] - self.bvh.node_lo[0]).clamp_min(0.0)
            self._root_vol = float(ext[0] * ext[1] * ext[2])
        return self._root_vol

    def engine(self, **kwargs) -> "QueryEngine":
        return QueryEngine(cloud=self, **kwargs)

    def __repr__(self):
        return (f"PointCloudScene(size={self.size}, depth={self.depth}, "
                f"builder={self.builder!r}, device={str(self.device)!r})")


class QueryEngine:
    """Query session over a :class:`Scene`, a :class:`VectorIndex` and/or
    a :class:`PointCloudScene`.

    ``backend="auto"`` picks the kernel backend for data on a CUDA device
    and the plain one on the CPU (see the ``resolve_*`` methods).
    ``chunk_size`` (engine-wide or per call) streams a batch through
    fixed-size blocks; ``shard="auto" | int`` resolves through
    :func:`~repro_torch.core.dispatch.resolve_shards` on the data's device
    (one shard on one card).  Each (query, backend, static parameters,
    plan, row signature) key counts one miss at its first use and a hit
    after (:meth:`cache_info`), and each backend's prepared context is
    built once per scene or cloud version (:attr:`prepares` counts those
    runs).
    Zero-row batches return a typed empty result without launching
    anything.
    """

    #: below this cloud size "auto" keeps neighbour queries on the brute
    #: path: one small matrix product beats any traversal
    AUTO_TREE_MIN_POINTS = 4096

    #: "auto" takes the tree only while a query's expected selectivity
    #: (k/N for nearest, ball volume / root volume for radius queries)
    #: stays under this
    AUTO_TREE_MAX_SELECTIVITY = 0.05

    #: the query methods a serving layer coalesces (one bucket space each)
    SERVABLE_METHODS = ("trace", "nearest", "within", "count_within", "scores")

    def __init__(self, scene: Scene | None = None,
                 index: VectorIndex | None = None,
                 cloud: PointCloudScene | None = None, *,
                 backend: str = "auto", pad_multiple: int | None = None,
                 shard: str | int | None = "auto", chunk_size: int | None = None):
        self.scene = scene
        self._index = index
        self.cloud = cloud
        self.default_backend = backend
        if shard not in (None, "auto"):
            check_count("shard", shard)
        self.default_shard = shard
        self.default_chunk_size = check_count("chunk_size", chunk_size)
        self.pad_multiple = (DEFAULT_PAD_MULTIPLE if pad_multiple is None
                             else max(1, int(pad_multiple)))
        self._seen: dict = {}  # key -> the data version it was last built for
        self._ctx: dict = {}  # (kind, backend, version) -> prepared ctx
        self._hits = 0
        self._misses = 0
        #: how many times a backend's prepare hook ran (once per backend
        #: and scene / cloud version)
        self.prepares = 0

    @property
    def index(self) -> VectorIndex | None:
        """The explicit index, else the cloud's twin index."""
        if self._index is None and self.cloud is not None:
            return self.cloud.index
        return self._index

    def _index_version(self) -> int:
        """Version of the index data: a cloud refit swaps the brute path's
        database, so run functions built over it must re-key."""
        if self._index is None and self.cloud is not None:
            return self.cloud.version
        return 0

    # -- cache -------------------------------------------------------------

    def cache_info(self) -> CacheInfo:
        return CacheInfo(self._hits, self._misses, len(self._seen))

    def cache_clear(self) -> None:
        """Forget the seen keys and drop the prepared contexts."""
        self._seen.clear()
        self._ctx.clear()
        self._hits = self._misses = 0

    def _cached_run(self, key, build, version: int = 0):
        """``build()``, counted as a hit if ``key`` was built before for
        data ``version`` and as a miss otherwise.  A run function here is
        a closure with no compile behind it, so it is built anew on every
        call: one kept would hold its index's tensors after a cloud
        refit.  A key keeps only its newest version, so an animated cloud
        adds no entry per frame."""
        if self._seen.get(key) == version:
            self._hits += 1
        else:
            self._misses += 1
            self._seen[key] = version
        return build()

    def _prepared(self, kind: str, name: str, owner, prepare):
        """``prepare(owner)(owner.bvh)``, once per (backend, version)."""
        if prepare is None:
            return owner.bvh
        key = (kind, name, owner.version)
        if key not in self._ctx:
            self._ctx = {k: v for k, v in self._ctx.items() if k[:2] != key[:2]}
            fn = self._cached_run(("prepare", name), lambda: prepare(owner))
            self._ctx[key] = fn(owner.bvh)
            self.prepares += 1
        return self._ctx[key]

    # -- backend resolution ----------------------------------------------

    def _need_scene(self) -> Scene:
        if self.scene is None:
            raise ValueError("QueryEngine has no Scene; construct with "
                             "QueryEngine(scene=...) or Scene.engine()")
        return self.scene

    def _need_index(self) -> VectorIndex:
        if self.index is None:
            raise ValueError("QueryEngine has no VectorIndex; construct with "
                             "QueryEngine(index=...) or VectorIndex.engine()")
        return self.index

    def resolve_trace_backend(self) -> str:
        """The fused kernel for a scene on a CUDA device, the wavefront
        engine on the CPU.  Unlike the reference's, "auto" never picks the
        per-ray oracle for a tiny batch: its loop runs on the host here,
        one ray at a time, and never beats a batch engine."""
        return "cuda" if self._need_scene().device.type == "cuda" else "wavefront"

    def resolve_distance_backend(self) -> str:
        """The distance kernel for an index on a CUDA device, the plain
        matmul form on the CPU."""
        return "cuda" if self._need_index().device.type == "cuda" else "mxu"

    def _tree_backend(self) -> str:
        # The card has no counterpart of the TPU's VMEM budget
        # (AUTO_PALLAS_SCENE_BYTES): the fused kernel reads the tree from
        # device memory, so it takes every query the tree takes at all.
        return "tree_cuda" if self.cloud.device.type == "cuda" else "tree_wavefront"

    def resolve_neighbor_backend(self, kind: str, metric: str,
                                 k: int | None = None,
                                 radius: float | None = None) -> str:
        """The backend "auto" picks for ``nearest`` / ``within`` /
        ``count_within``: the tree for a euclidean query on a cloud of at
        least :data:`AUTO_TREE_MIN_POINTS` points whose expected
        selectivity stays under :data:`AUTO_TREE_MAX_SELECTIVITY`, the
        distance backends otherwise.  Every route returns the same
        in-radius sets and neighbour ranks."""
        if self.cloud is None or metric != "euclidean":
            return self.resolve_distance_backend()
        n = self.cloud.size
        if n < self.AUTO_TREE_MIN_POINTS:
            return self.resolve_distance_backend()
        if kind == "nearest":
            selectivity = (1 if k is None else int(k)) / n
        else:
            r = float(radius)
            ball = 4.0 / 3.0 * math.pi * r**3
            vol = self.cloud.root_volume()
            selectivity = ball / vol if (vol > 0.0 and math.isfinite(ball)) else 1.0
        if selectivity > self.AUTO_TREE_MAX_SELECTIVITY:
            return self.resolve_distance_backend()
        return self._tree_backend()

    # -- execution planning ------------------------------------------------

    def _resolve_shards(self, shard, n: int, device: torch.device) -> int:
        return resolve_shards(self.default_shard if shard is None else shard,
                              n, device)

    def _plan(self, n: int, shards: int, chunk_size,
              lane_multiple: int | None = None) -> ExecPlan:
        if chunk_size is None:
            chunk_size = self.default_chunk_size
        return make_plan(n, pad_multiple=self.pad_multiple, shards=shards,
                         chunk_size=chunk_size, lane_multiple=lane_multiple)

    def _method_lane_multiple(self, method: str, backend: str | None, *,
                              metric: str = "euclidean", k: int | None = None,
                              radius: float | None = None) -> int | None:
        """The row multiple a ``method`` query's backend declares (None:
        only the pad multiple applies), resolving "auto" as the query
        would."""
        name = backend or self.default_backend
        if method == "trace":
            if name == "auto":
                name = self.resolve_trace_backend()
            if name not in _TRACE_BACKENDS:
                raise ValueError(f"unknown trace backend {name!r} "
                                 f"(registered: {trace_backends()})")
            return _TRACE_BACKENDS[name][2]
        if method in ("nearest", "within", "count_within", "scores"):
            if name == "auto":
                if method == "scores" or (method != "nearest" and radius is None):
                    # scores is brute-only; a radius query asked about
                    # without its radius cannot be routed by selectivity
                    name = self.resolve_distance_backend()
                else:
                    name = self.resolve_neighbor_backend(method, metric, k=k,
                                                         radius=radius)
            if name in _NEIGHBOR_BACKENDS:
                return _NEIGHBOR_BACKENDS[name][1]
            if name in _DISTANCE_BACKENDS:
                return None
            raise ValueError(
                f"unknown distance/neighbor backend {name!r} (registered: "
                f"{distance_backends() + neighbor_backends()})")
        raise ValueError(f"unknown query method {method!r} "
                         f"(servable: {self.SERVABLE_METHODS})")

    def _method_device(self, method: str) -> torch.device:
        if method == "trace":
            return self._need_scene().device
        return (self.cloud.device if self.cloud is not None
                else self._need_index().device)

    def batch_multiple(self, method: str = "trace", backend: str | None = None, *,
                       ray_type: str = "closest", metric: str = "euclidean",
                       k: int | None = None, radius: float | None = None) -> int:
        """The row multiple ``method`` queries are padded to:
        ``max(pad_multiple, the backend's row multiple)``.  A serving
        coalescer sizes its batches by it.  ``ray_type`` is accepted for
        the reference's signature; every trace backend pads alike."""
        lane = self._method_lane_multiple(method, backend, metric=metric, k=k,
                                          radius=radius)
        return max(self.pad_multiple, lane or 1)

    def plan_for(self, method: str, n: int, *, backend: str | None = None,
                 ray_type: str = "closest", metric: str = "euclidean",
                 k: int | None = None, radius: float | None = None, shard=None,
                 chunk_size: int | None = None) -> ExecPlan:
        """The :class:`~repro_torch.core.dispatch.ExecPlan` an ``n``-row
        ``method`` query would run under, without running anything: the
        plan the query path itself builds."""
        if n < 1:
            raise ValueError(f"plan_for needs n >= 1, got {n}")
        shards = self._resolve_shards(shard, n, self._method_device(method))
        chunk_size = check_count("chunk_size", chunk_size)
        lane = self._method_lane_multiple(method, backend, metric=metric, k=k,
                                          radius=radius)
        return self._plan(n, shards, chunk_size, lane_multiple=lane)

    # -- traversal queries -------------------------------------------------

    def trace(self, rays: Ray, ray_type: str = "closest", *,
              backend: str | None = None, t_min: float | None = None,
              max_rounds: int | None = None, shard=None,
              chunk_size: int | None = None) -> TraceResult:
        """Traverse a ray batch: ``ray_type`` is ``"closest"`` | ``"any"`` |
        ``"shadow"``.  Results are bit-identical whatever ``chunk_size``."""
        scene = self._need_scene()
        if ray_type not in RAY_TYPES:
            raise ValueError(f"ray_type must be one of {RAY_TYPES}, got {ray_type!r}")
        if t_min is None:
            t_min = default_t_min(ray_type)
        t_min = float(t_min)
        n = rays.origin.shape[0]
        dev = scene.device
        shards = self._resolve_shards(shard, n, dev)
        chunk_size = check_count("chunk_size", chunk_size)
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
        if rays.origin.device != dev:
            raise ValueError(f"rays on {rays.origin.device}, scene on {dev}")
        if n == 0:  # empty guard: typed empty result, nothing launched
            z = torch.zeros((0,), dtype=torch.int32, device=dev)
            return TraceResult(t=torch.zeros((0,), device=dev), tri_index=z,
                               hit=z.bool(), quadbox_jobs=z, triangle_jobs=z,
                               stack_overflow=z.bool(),
                               rounds=torch.zeros((), dtype=torch.int32,
                                                  device=dev))

        plan = self._plan(n, shards, chunk_size, lane_multiple=lane_multiple)
        key = (("trace", name, ray_type, t_min, max_rounds, scene.config.tag)
               + plan.key + _elem_key(rays))
        run = self._cached_run(key, lambda: build(scene, ray_type, t_min, max_rounds))
        ctx = self._prepared("trace", name, scene, prepare)
        outs = [run(ctx, block) for block in split_blocks(rays, plan)]
        rounds = torch.stack([o.rounds for o in outs]).max()
        rows = concat_rows([o[:-1] for o in outs], n)
        return TraceResult(*rows, rounds=rounds)

    def occluded(self, rays: Ray, *, t_min: float = SHADOW_T_MIN,
                 backend: str | None = None, shard=None,
                 chunk_size: int | None = None) -> torch.Tensor:
        """Is anything hit within each ray's extent?  The ``hit`` of a
        shadow trace."""
        return self.trace(rays, "shadow", t_min=t_min, backend=backend,
                          shard=shard, chunk_size=chunk_size).hit

    # -- distance queries --------------------------------------------------

    def _distance_fn(self, kind: str, queries, metric: str, backend: str | None,
                     statics: tuple, epilogue, empty, shard=None,
                     chunk_size: int | None = None):
        """Brute-force scores per block of queries, each block's scores
        reduced by ``epilogue`` to a tuple of per-row results."""
        index = self._need_index()
        name = backend or self.default_backend
        if name == "auto":
            name = self.resolve_distance_backend()
        if name not in _DISTANCE_BACKENDS:
            raise ValueError(f"unknown distance backend {name!r} "
                             f"(registered: {distance_backends()})")
        q = _on_device(queries, index.device, "queries")
        n = q.shape[0]
        shards = self._resolve_shards(shard, n, index.device)
        chunk_size = check_count("chunk_size", chunk_size)
        if n == 0:  # empty guard: typed empty result, nothing launched
            return empty()
        plan = self._plan(n, shards, chunk_size)
        key = (kind, name, metric) + statics + plan.key + _elem_key((q,))

        def build():
            score_fn = _DISTANCE_BACKENDS[name](index, metric)
            return lambda block: epilogue(score_fn(block))

        run = self._cached_run(key, build, self._index_version())
        return concat_rows([run(block) for (block,) in split_blocks((q,), plan)], n)

    def _tree_neighbor(self, kind: str, queries, k: int, radius, name: str,
                       shard=None, chunk_size: int | None = None) -> NeighborRecord:
        """A neighbour query through a registered tree backend: the queries
        ride as :func:`point_queries` rays, padded and chunked like a trace."""
        if self.cloud is None:
            raise ValueError(
                f"backend {name!r} needs a PointCloudScene; construct with "
                "QueryEngine(cloud=...) or PointCloudScene.engine()")
        cloud = self.cloud
        mode = "nearest" if kind == "nearest" else "within"
        build, lane_multiple, prepare = _NEIGHBOR_BACKENDS[name]
        dev = cloud.device
        q = _on_device(queries, dev, "queries")
        if q.ndim != 2 or q.shape[-1] != 3:
            raise ValueError(f"tree-backed {kind} expects (M, 3) queries, got "
                             f"{tuple(q.shape)}")
        kk = max(1, min(int(k), cloud.size))  # k > N pads below
        n = q.shape[0]
        shards = self._resolve_shards(shard, n, dev)
        chunk_size = check_count("chunk_size", chunk_size)
        if n == 0:  # empty guard: typed empty result, nothing launched
            return empty_neighbors(k, dev)
        rays = point_queries(q, radius, device=dev)
        plan = self._plan(n, shards, chunk_size, lane_multiple=lane_multiple)
        key = ("neighbor", name, mode, kk) + plan.key + _elem_key(rays)
        run = self._cached_run(key, lambda: build(cloud, mode, kk))
        ctx = self._prepared("neighbor", name, cloud, prepare)
        outs = [run(ctx, block) for block in split_blocks(rays, plan)]
        rounds = torch.stack([o.rounds for o in outs]).max()
        rec = NeighborRecord(*concat_rows([o[:-1] for o in outs], n), rounds=rounds)
        if kk < k:  # pad the clamped top-k axis back out
            pad = k - kk
            rec = rec._replace(
                dist_sq=torch.cat([rec.dist_sq, torch.full(
                    (n, pad), float("inf"), device=dev)], dim=1),
                index=torch.cat([rec.index, torch.full(
                    (n, pad), -1, dtype=torch.int32, device=dev)], dim=1),
                valid=torch.cat([rec.valid, torch.zeros(
                    (n, pad), dtype=torch.bool, device=dev)], dim=1))
        return rec

    def _resolve_neighbor_name(self, kind: str, metric: str, backend,
                               k=None, radius=None) -> str:
        name = backend or self.default_backend
        if name == "auto":
            name = self.resolve_neighbor_backend(kind, metric, k=k, radius=radius)
        if name in _NEIGHBOR_BACKENDS and metric != "euclidean":
            raise ValueError(
                f"tree backend {name!r} supports metric='euclidean' only, got "
                f"{metric!r} (use the mxu/cuda brute backends for "
                "angular/cosine)")
        return name

    def neighbor_search(self, queries, k: int, radius=None, *,
                        mode: str = "within", backend: str | None = None,
                        shard=None, chunk_size: int | None = None) -> NeighborRecord:
        """Tree-backed neighbour query returning the whole
        :class:`~repro_torch.core.neighbor.NeighborRecord` (distances,
        indices, exact in-radius counts and per-query job counters)."""
        k = check_k(k)
        if radius is not None:
            radius = check_radius(radius, "euclidean")
        name = backend or self.default_backend
        if name == "auto":
            if self.cloud is None:
                raise ValueError("neighbor_search needs a PointCloudScene")
            name = self._tree_backend()
        if name not in _NEIGHBOR_BACKENDS:
            raise ValueError(f"unknown neighbor backend {name!r} "
                             f"(registered: {neighbor_backends()})")
        kind = "nearest" if mode == "nearest" else "within"
        return self._tree_neighbor(kind, queries, k, radius, name,
                                   shard=shard, chunk_size=chunk_size)

    def _empty(self, k: int):
        dev = self.index.device
        return lambda: (torch.zeros((0, k), dtype=torch.float32, device=dev),
                        torch.zeros((0, k), dtype=torch.int32, device=dev),
                        torch.zeros((0, k), dtype=torch.bool, device=dev))

    def nearest(self, queries, k: int, metric: str = "euclidean", *,
                backend: str | None = None, shard=None,
                chunk_size: int | None = None) -> NearestResult:
        """Exact k nearest neighbours.  ``k`` is validated eagerly and
        clamped to the database size (excess slots pad: inf / -inf score,
        index -1, ``valid`` False).  On a :class:`PointCloudScene`,
        ``backend="auto"`` routes euclidean queries through the tree when
        it wins."""
        if metric not in METRICS:
            raise ValueError(f"unknown metric: {metric}")
        k = check_k(k)
        name = self._resolve_neighbor_name("nearest", metric, backend, k=k)
        if name in _NEIGHBOR_BACKENDS:
            rec = self._tree_neighbor("nearest", queries, k, None, name,
                                      shard=shard, chunk_size=chunk_size)
            return NearestResult(rec.dist_sq, rec.index, rec.valid)

        def topk(s):
            scores, idx = select_topk(s, k, metric)
            return scores, idx, idx >= 0

        return NearestResult(*self._distance_fn(
            "nearest", queries, metric, name, (k,), topk, self._empty(k),
            shard=shard, chunk_size=chunk_size))

    def within(self, queries, radius: float, k: int, metric: str = "euclidean",
               *, backend: str | None = None, shard=None,
               chunk_size: int | None = None) -> WithinResult:
        """Fixed-radius query: the best ``k`` in-range neighbours.  NaN or
        negative euclidean radii and ``k <= 0`` raise; ``k > N`` pads."""
        if metric not in RADIUS_METRICS:
            raise ValueError(f"unknown radius metric: {metric}")
        radius = check_radius(radius, metric)
        k = check_k(k)
        name = self._resolve_neighbor_name("within", metric, backend, k=k,
                                           radius=radius)
        if name in _NEIGHBOR_BACKENDS:
            rec = self._tree_neighbor("within", queries, k, radius, name,
                                      shard=shard, chunk_size=chunk_size)
            return WithinResult(rec.dist_sq, rec.index, rec.valid)
        return WithinResult(*self._distance_fn(
            "within", queries, metric, name, (radius, k),
            lambda s: select_within(s, radius, k, metric), self._empty(k),
            shard=shard, chunk_size=chunk_size))

    def count_within(self, queries, radius: float, metric: str = "euclidean",
                     *, backend: str | None = None, shard=None,
                     chunk_size: int | None = None) -> torch.Tensor:
        """How many database points fall within ``radius`` of each query
        (exact on the tree too: the traversal counts every in-radius leaf)."""
        if metric not in RADIUS_METRICS:
            raise ValueError(f"unknown radius metric: {metric}")
        radius = check_radius(radius, metric)
        name = self._resolve_neighbor_name("count_within", metric, backend,
                                           radius=radius)
        if name in _NEIGHBOR_BACKENDS:
            return self._tree_neighbor("count_within", queries, 1, radius, name,
                                       shard=shard, chunk_size=chunk_size).count
        return self._distance_fn(
            "count_within", queries, metric, name, (radius,),
            lambda s: (count_within_scores(s, radius, metric),),
            lambda: (torch.zeros((0,), dtype=torch.int32,
                                 device=self.index.device),),
            shard=shard, chunk_size=chunk_size)[0]

    def scores(self, queries, metric: str = "euclidean", *,
               backend: str | None = None, shard=None,
               chunk_size: int | None = None) -> torch.Tensor:
        """The raw (M, N) score matrix (squared distances / similarities)."""
        if metric not in METRICS:
            raise ValueError(f"unknown metric: {metric}")
        return self._distance_fn(
            "scores", queries, metric, backend, (), lambda s: (s,),
            lambda: (torch.zeros((0, self.index.size), dtype=torch.float32,
                                 device=self.index.device),),
            shard=shard, chunk_size=chunk_size)[0]

    def similarity(self, queries, *, backend: str | None = None, shard=None,
                   chunk_size: int | None = None) -> torch.Tensor:
        """Full cosine-similarity matrix (external-divider epilogue)."""
        return self.scores(queries, "cosine", backend=backend, shard=shard,
                           chunk_size=chunk_size)

    def __repr__(self):
        return (f"QueryEngine(scene={self.scene!r}, index={self.index!r}, "
                f"cloud={self.cloud!r}, backend={self.default_backend!r}, "
                f"pad_multiple={self.pad_multiple}, shard={self.default_shard!r}, "
                f"chunk_size={self.default_chunk_size}, cache={self.cache_info()})")
