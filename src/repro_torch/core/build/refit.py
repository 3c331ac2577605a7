"""Refit: the AABB update of a dynamic scene, topology kept.

The port's counterpart of ``repro/core/build/refit.py``.  A refit keeps
the builder's triangle-to-leaf assignment (``leaf_perm``) and re-sweeps
only the boxes bottom-up: ``depth`` 4-to-1 reductions, the same
:func:`~repro_torch.core.bvh.fit_nodes` every builder ends with.  With the
build's own triangles the result is bit-equal to the build; under motion
the boxes stay exactly fitted (each frame recomputes them from scratch),
and only the topology's quality decays.

The degenerate cull is re-evaluated on the current vertices every frame:
a triangle that collapses under motion drops out exactly as a rebuild
would cull it, and one that was degenerate at build time comes back when
motion gives it area.
"""
from __future__ import annotations

from ..bvh import (BVH4, DatapathConfig, depth_of, encode_nodes, fit_nodes,
                   leaf_arrays, nondegenerate_mask, resolve_config)
from ..types import Triangle, aabb_of_triangles


def refit(bvh: BVH4, triangles: Triangle,
          config: DatapathConfig | None = None) -> BVH4:
    """Re-fit ``bvh``'s boxes around ``triangles`` (the built soup with
    moved vertices: same count, same order), keeping its topology.  A soup
    of another size raises ``ValueError``."""
    config = resolve_config(config)
    n = triangles.a.shape[0]
    n_built = bvh.triangles.a.shape[0]
    if n != n_built:
        raise ValueError(
            f"refit needs the built soup's {n_built} triangles, got {n} "
            "(topology is preserved -- rebuild to change the soup)")
    depth = depth_of(bvh, config.arity)
    leaf_tri, leaf_lo, leaf_hi = leaf_arrays(
        bvh.leaf_perm, aabb_of_triangles(triangles), nondegenerate_mask(triangles))
    node_lo, node_hi = fit_nodes(leaf_lo, leaf_hi, depth, config.arity)
    node_lo, node_hi = encode_nodes(node_lo, node_hi, depth, config)
    return BVH4(node_lo=node_lo, node_hi=node_hi, leaf_tri=leaf_tri,
                triangles=triangles, leaf_perm=bvh.leaf_perm)
