"""``repro_torch.api`` -- the port's public query surface.

    from repro_torch.api import Scene, make_ray

    scene = Scene.from_triangles(vertices)           # LBVH on the card
    engine = scene.engine()
    hits = engine.trace(make_ray(origins, directions))       # closest-hit
    shadowed = engine.occluded(shadow_rays)          # the shadow trace's hit
    scene.refit(moved_vertices)                      # animate: same topology,
    hits = engine.trace(rays)                        # one re-pack, nothing rebuilt
    print(scene.stats())                             # SAH cost + jobs per ray

    index = VectorIndex.from_database(embeddings)    # ||c||^2 on the card
    near = index.engine(chunk_size=1024).nearest(queries, k=10, metric="cosine")

    cloud = PointCloudScene.from_points(points)      # BVH4 of point leaves
    engine = cloud.engine()
    knn = engine.nearest(queries, k=16)              # tree or brute, auto
    counts = engine.count_within(queries, radius=0.1)
    cloud.refit(moved_points)                        # animate the cloud

    cfg = get_config("phi3.5-moe-42b-a6.6b")         # or get_smoke(...)
    params = init_params(0, cfg)                     # seeded, on the card
    tokens = Engine(cfg, params, max_len=192).generate(prompts, 32)

Entry points run on CUDA unless the caller passes ``device="cpu"``.
"""
from .core.build import (  # noqa: F401
    BuildResult,
    TreeStats,
    builders,
    refit,
    refit_points,
    register_builder,
)
from .core.bvh import BVH4, DEFAULT_CONFIG, DatapathConfig  # noqa: F401
from .core.knn import METRICS, RADIUS_METRICS  # noqa: F401
from .core.neighbor import NEIGHBOR_MODES, NeighborRecord  # noqa: F401
from .core.session import (  # noqa: F401
    CacheInfo,
    NearestResult,
    PointCloudScene,
    QueryEngine,
    Scene,
    TraceResult,
    VectorIndex,
    WithinResult,
    distance_backends,
    neighbor_backends,
    register_distance_backend,
    register_neighbor_backend,
    register_trace_backend,
    trace_backend_ray_types,
    trace_backends,
)
from .core.types import Box, Ray, Triangle, make_ray  # noqa: F401
from .core.wavefront import RAY_TYPES, SHADOW_T_MIN  # noqa: F401
from .configs import ARCH_IDS, get_config, get_smoke  # noqa: F401
from .models import (  # noqa: F401
    ModelConfig,
    cache_shapes,
    count_active_params,
    count_params,
    decode_step,
    init_cache,
    init_params,
    prefill,
)
from .serving.engine import Engine  # noqa: F401

__all__ = [
    "ARCH_IDS",
    "BVH4",
    "Box",
    "BuildResult",
    "CacheInfo",
    "DEFAULT_CONFIG",
    "DatapathConfig",
    "Engine",
    "METRICS",
    "ModelConfig",
    "NEIGHBOR_MODES",
    "NearestResult",
    "NeighborRecord",
    "PointCloudScene",
    "QueryEngine",
    "RADIUS_METRICS",
    "RAY_TYPES",
    "Ray",
    "SHADOW_T_MIN",
    "Scene",
    "TraceResult",
    "TreeStats",
    "Triangle",
    "VectorIndex",
    "WithinResult",
    "builders",
    "cache_shapes",
    "count_active_params",
    "count_params",
    "decode_step",
    "distance_backends",
    "get_config",
    "get_smoke",
    "init_cache",
    "init_params",
    "make_ray",
    "neighbor_backends",
    "prefill",
    "refit",
    "refit_points",
    "register_builder",
    "register_distance_backend",
    "register_neighbor_backend",
    "register_trace_backend",
    "trace_backend_ray_types",
    "trace_backends",
]
