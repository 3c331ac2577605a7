"""Acceleration-structure construction: the builder registry.

The port's counterpart of ``repro/core/build/__init__.py``.  Builders
register under a name and all emit the same implicit :class:`BVH4`
layout: ``"lbvh"`` (Morton order) and ``"sah"`` (binned SAH), each at
any :class:`~repro_torch.core.bvh.DatapathConfig`.  The package also
holds the point-cloud builder (``points``), the refit of a moved soup
(``refit``) and the tree-quality metrics (``quality``).
"""
from __future__ import annotations

from typing import Callable, NamedTuple

from ..bvh import BVH4, DEFAULT_CONFIG, DatapathConfig, bvh_depth, resolve_config
from ..types import Triangle

# name -> builder(tri: Triangle, depth: int, config: DatapathConfig) -> BVH4
_BUILDERS: dict[str, Callable] = {}


class BuildResult(NamedTuple):
    """What every registered builder hands the session layer."""

    bvh: BVH4
    builder: str
    depth: int
    config: DatapathConfig = DEFAULT_CONFIG


def register_builder(name: str):
    """Register an acceleration-structure builder under ``name``; it gets
    ``(triangles, depth, config)`` and returns a :class:`BVH4`."""
    def deco(fn):
        _BUILDERS[name] = fn
        return fn
    return deco


def builders() -> tuple[str, ...]:
    return tuple(_BUILDERS)


def get_builder(name: str) -> Callable:
    if name not in _BUILDERS:
        raise ValueError(f"unknown builder {name!r} (registered: {builders()})")
    return _BUILDERS[name]


def build(triangles: Triangle, builder: str = "lbvh", depth: int | None = None,
          config: DatapathConfig | None = None) -> BuildResult:
    """Build an acceleration structure with a registered builder.  ``depth``
    defaults to the smallest depth whose ``config.arity**depth`` leaf slots
    fit the soup; ``config`` picks the arity and the node-box codec.  The
    tree lives on the device of ``triangles``."""
    fn = get_builder(builder)
    config = resolve_config(config)
    n = triangles.a.shape[0]
    if depth is None:
        depth = bvh_depth(n, config.arity)
    if config.arity**depth < n:
        raise ValueError(f"depth={depth} gives {config.arity**depth} leaf "
                         f"slots < {n} triangles")
    return BuildResult(bvh=fn(triangles, depth, config), builder=builder,
                       depth=depth, config=config)


# builder modules self-register on import
from . import lbvh, sah  # noqa: E402,F401
from .lbvh import build_bvh4  # noqa: E402,F401
from .points import build_point_bvh, point_boxes, refit_points  # noqa: E402,F401
from .quality import (  # noqa: E402,F401
    TreeStats,
    clustered_soup,
    mean_branching_factor,
    mean_jobs_per_ray,
    probe_rays,
    sah_cost,
    tree_stats,
)
from .refit import refit  # noqa: E402,F401
