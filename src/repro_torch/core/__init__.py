"""Core of the port: the datapath, the BVH, traversal and the session
layer.  The counterpart of ``repro/core/__init__.py``, with the same names
but two: the free functions ``build`` and ``knn`` stay in their modules,
so that ``repro_torch.core.build`` and ``repro_torch.core.knn`` name the
modules."""
from .types import (  # noqa: F401
    ANGULAR_LANES,
    OP_ANGULAR,
    OP_EUCLIDEAN,
    OP_QUADBOX,
    OP_TRIANGLE,
    OPCODE_NAMES,
    QUAD,
    VECTOR_LANES,
    AngularResult,
    Box,
    DatapathState,
    EuclideanResult,
    PointBoxResult,
    QuadBoxResult,
    Ray,
    Triangle,
    TriangleResult,
    aabb_of_triangles,
    init_datapath_state,
    make_ray,
)
from .datapath import (  # noqa: F401
    angular_beat,
    angular_distance_parts,
    angular_partial,
    euclidean_beat,
    euclidean_distance_sq,
    euclidean_partial,
    point_box_test,
    quadsort,
    ray_box_test,
    ray_triangle_test,
)
from .stream import DatapathJob, DatapathOutput, make_jobs, unified_stream  # noqa: F401
from .bvh import BVH4, bvh4_depth, child_boxes, fit_nodes  # noqa: F401
from .traversal import HitRecord, trace_ray, trace_rays  # noqa: F401
from .wavefront import (  # noqa: F401
    RAY_TYPES,
    WavefrontRecord,
    occlusion_test,
    trace_wavefront,
)
from .build import (  # noqa: F401
    BuildResult,
    TreeStats,
    build_bvh4,
    build_point_bvh,
    builders,
    get_builder,
    mean_jobs_per_ray,
    point_boxes,
    refit,
    refit_points,
    register_builder,
    sah_cost,
    tree_stats,
)
from .knn import (  # noqa: F401
    angular_scores,
    check_k,
    check_radius,
    cosine_similarity,
    count_within_scores,
    euclidean_scores,
    pairwise_scores,
    radius_count,
    radius_search,
    select_topk,
    select_within,
    squared_norms,
)
from .neighbor import (  # noqa: F401
    NEIGHBOR_MODES,
    NeighborRecord,
    neighbor_wavefront,
    point_queries,
)
from .session import (  # noqa: F401
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
    trace_backends,
)
