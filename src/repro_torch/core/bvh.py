"""BVH4: the implicit wide acceleration structure the datapath traverses.

The port's counterpart of ``repro/core/bvh.py``, default-config subset:
the :class:`BVH4` record, the implicit-layout helpers and the shared
bottom-up fit.  For arity ``A``, node ``k`` has children ``A*k+1 ..
A*k+A``; level ``l`` starts at offset ``(A^l - 1) / (A - 1)``.  Empty
(padded) leaves carry inverted boxes (lo=+inf, hi=-inf), which never
intersect, so traversal needs no validity bitmap.

Only :data:`DEFAULT_CONFIG` (BVH4 / stack 64 / fp32 boxes / fp32 nodes)
is ported so far; every other :class:`DatapathConfig` raises
``NotImplementedError``.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .types import Box, Triangle


class DatapathConfig(NamedTuple):
    """Static datapath configuration (see ``repro.core.bvh``)."""

    arity: int = 4
    stack_size: int = 64
    precision: str = "fp32"
    node_format: str = "fp32"

    @property
    def tag(self) -> str:
        """Stable id used in golden keys."""
        return (f"bvh{self.arity}_s{self.stack_size}"
                f"_{self.precision}_{self.node_format}")

    @property
    def box_bytes_per_node(self) -> int:
        """Node-box storage (lo + hi, 3 axes) per node: 24 B for the fp32
        boxes of :data:`DEFAULT_CONFIG`, the only config ported so far."""
        resolve_config(self)
        return 24


DEFAULT_CONFIG = DatapathConfig()


def resolve_config(config: DatapathConfig | None) -> DatapathConfig:
    """``None`` -> :data:`DEFAULT_CONFIG`; other configs are not ported yet."""
    if config is None:
        return DEFAULT_CONFIG
    if tuple(config) != tuple(DEFAULT_CONFIG):
        raise NotImplementedError(
            f"DatapathConfig {config} is not ported yet; repro_torch "
            f"supports only {DEFAULT_CONFIG.tag}")
    return DEFAULT_CONFIG


class BVH4(NamedTuple):
    node_lo: torch.Tensor  # (num_nodes, 3) f32 -- implicit 4-ary heap, root first
    node_hi: torch.Tensor  # (num_nodes, 3) f32
    leaf_tri: torch.Tensor  # (4**depth,) i32 -- triangle per leaf, -1 = pad
    triangles: Triangle  # the original (unsorted) soup, (N, 3) each
    leaf_perm: torch.Tensor  # (4**depth,) i32 -- slot assignment before the
    # degenerate cull (-1 = empty pad slot)


def bvh_depth(n_triangles: int, arity: int = 4) -> int:
    """Static tree depth: smallest D with arity**D >= n (min 1)."""
    return max(1, math.ceil(math.log(max(n_triangles, 2), arity)))


def bvh4_depth(n_triangles: int) -> int:
    """Static tree depth: smallest D with 4**D >= n (min 1)."""
    return bvh_depth(n_triangles, 4)


def depth_of(bvh: BVH4, arity: int = 4) -> int:
    """Recover the static depth from the leaf array length (arity**depth)."""
    return bvh_depth(bvh.leaf_tri.shape[0], arity)


def level_offset(level: int, arity: int = 4) -> int:
    return (arity**level - 1) // (arity - 1)


def num_nodes(depth: int, arity: int = 4) -> int:
    return level_offset(depth + 1, arity)


def fit_nodes(leaf_lo: torch.Tensor, leaf_hi: torch.Tensor, depth: int,
              arity: int = 4) -> tuple[torch.Tensor, torch.Tensor]:
    """Bottom-up AABB fit: ``depth`` ``arity``-to-1 reductions from the
    ``(arity**depth, 3)`` leaf boxes to ``(num_nodes, 3)``, root first.
    Inverted (empty) leaves propagate as inverted internal boxes."""
    levels_lo, levels_hi = [leaf_lo], [leaf_hi]
    cur_lo, cur_hi = leaf_lo, leaf_hi
    for _ in range(depth):
        cur_lo = cur_lo.reshape(-1, arity, 3).amin(dim=1)
        cur_hi = cur_hi.reshape(-1, arity, 3).amax(dim=1)
        levels_lo.append(cur_lo)
        levels_hi.append(cur_hi)
    return torch.cat(levels_lo[::-1], dim=0), torch.cat(levels_hi[::-1], dim=0)


def encode_nodes(node_lo: torch.Tensor, node_hi: torch.Tensor, depth: int,
                 config: DatapathConfig | None) -> tuple[torch.Tensor, torch.Tensor]:
    """The config's node-box codec after :func:`fit_nodes`: the identity
    for :data:`DEFAULT_CONFIG`, the only config ported so far."""
    resolve_config(config)
    return node_lo, node_hi


def nondegenerate_mask(tri: Triangle) -> torch.Tensor:
    """Which triangles have exactly nonzero area (``(b-a) x (c-a) != 0``).

    The cross product is written as separate eager ops, so each product
    and difference rounds on its own on every device (a fused
    ``torch.linalg.cross`` kernel could be contracted into FMAs by the
    CUDA compiler)."""
    e1 = tri.b - tri.a
    e2 = tri.c - tri.a
    x1, y1, z1 = e1.unbind(-1)
    x2, y2, z2 = e2.unbind(-1)
    cx = y1 * z2 - z1 * y2
    cy = z1 * x2 - x1 * z2
    cz = x1 * y2 - y1 * x2
    return (cx != 0.0) | (cy != 0.0) | (cz != 0.0)


def leaf_arrays(leaf_perm: torch.Tensor, boxes: Box, nondegen: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(leaf_tri, leaf_lo, leaf_hi)`` from a builder's slot assignment,
    with the degenerate cull applied (culled and pad slots: tri -1 and an
    inverted box)."""
    safe = leaf_perm.clamp(min=0).long()
    live = (leaf_perm >= 0) & nondegen[safe]
    leaf_tri = torch.where(live, leaf_perm, torch.full_like(leaf_perm, -1))
    inf = float("inf")
    lo = boxes.lo[safe]
    hi = boxes.hi[safe]
    leaf_lo = torch.where(live[:, None], lo, torch.full_like(lo, inf))
    leaf_hi = torch.where(live[:, None], hi, torch.full_like(hi, -inf))
    return leaf_tri, leaf_lo, leaf_hi


def child_boxes(bvh: BVH4, node_idx: torch.Tensor, arity: int = 4) -> Box:
    """The ``arity`` child AABBs of internal nodes -- one box-test job each."""
    base = arity * node_idx.long() + 1
    idx = base[..., None] + torch.arange(arity, device=base.device)
    return Box(lo=bvh.node_lo[idx], hi=bvh.node_hi[idx])
