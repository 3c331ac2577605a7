"""``repro_torch.api`` -- the port's public query surface.

    from repro_torch.api import Scene, make_ray

    scene = Scene.from_triangles(vertices)           # LBVH on the card
    engine = scene.engine()
    hits = engine.trace(make_ray(origins, directions))       # closest-hit
    shadowed = engine.trace(shadow_rays, ray_type="shadow").hit

Entry points run on CUDA unless the caller passes ``device="cpu"``.
"""
from .core.build import BuildResult, builders, register_builder  # noqa: F401
from .core.bvh import BVH4, DEFAULT_CONFIG, DatapathConfig  # noqa: F401
from .core.session import (  # noqa: F401
    QueryEngine,
    Scene,
    TraceResult,
    register_trace_backend,
    trace_backend_ray_types,
    trace_backends,
)
from .core.types import Box, Ray, Triangle, make_ray  # noqa: F401
from .core.wavefront import RAY_TYPES, SHADOW_T_MIN  # noqa: F401

__all__ = [
    "BVH4",
    "Box",
    "BuildResult",
    "DEFAULT_CONFIG",
    "DatapathConfig",
    "QueryEngine",
    "RAY_TYPES",
    "Ray",
    "SHADOW_T_MIN",
    "Scene",
    "TraceResult",
    "Triangle",
    "builders",
    "make_ray",
    "register_builder",
    "register_trace_backend",
    "trace_backend_ray_types",
    "trace_backends",
]
