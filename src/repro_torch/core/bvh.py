"""BVH4/BVH8: the implicit wide acceleration structure the datapath
traverses.

The port's counterpart of ``repro/core/bvh.py``: the :class:`BVH4`
record, the implicit-layout helpers, the shared bottom-up fit,
:class:`DatapathConfig` (arity 4 or 8, any stack size, fp32 or bf16 box
precision, fp32 or compressed node format) and the conservative node-box
codecs.  For arity ``A``, node ``k`` has children ``A*k+1 .. A*k+A``;
level ``l`` starts at offset ``(A^l - 1) / (A - 1)``.  Empty (padded)
leaves carry inverted boxes (lo=+inf, hi=-inf), which never intersect, so
traversal needs no validity bitmap.

The codecs decode at build: a tree always carries f32 node arrays, and
under a narrow config every bound lies on the bf16 grid, widened (lo
down, hi up), so a ray that hits nothing visits a superset of the exact
tree's nodes, and every ray commits the same closest hit and ``t``.  The fused kernel's packer stores those
rows as genuine bf16, a lossless cast.

Every op of a codec is one eager tensor op, rounded on its own on every
device (the reference's build runs eagerly too), and each division is by
a tensor: a CUDA divide by a Python scalar is a multiply by its
reciprocal, which rounds differently.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .knn import key_value, order_key
from .types import Box, Triangle


BOX_PRECISIONS = ("fp32", "bf16")
NODE_FORMATS = ("fp32", "compressed")


class DatapathConfig(NamedTuple):
    """Static datapath configuration (hashable: Python scalars only).

    * ``arity``: BVH branching factor (4 or 8); one box-test job covers
      ``arity`` child boxes.
    * ``stack_size``: per-ray traversal stack slots; a push past capacity
      is dropped and flags ``stack_overflow``.
    * ``precision``: box storage, ``"fp32"`` (exact) or ``"bf16"`` (boxes
      widened onto the bf16 grid).
    * ``node_format``: ``"fp32"`` or ``"compressed"`` (parent-relative
      8-bit child boxes, decoded at build onto the bf16 grid; 6 analytic
      bytes a node against 24).
    """

    arity: int = 4
    stack_size: int = 64
    precision: str = "fp32"
    node_format: str = "fp32"

    @property
    def tag(self) -> str:
        """Stable id used in golden keys, cache keys and chip rows."""
        return (f"bvh{self.arity}_s{self.stack_size}"
                f"_{self.precision}_{self.node_format}")

    @property
    def exact_boxes(self) -> bool:
        """True iff node boxes are bit-exact f32 (no conservative widening)."""
        return self.precision == "fp32" and self.node_format == "fp32"

    @property
    def packed_box_dtype(self) -> torch.dtype:
        """Element type of the fused kernel's node-box rows: bf16 for the
        narrow configs, whose boxes lie on the bf16 grid (a lossless cast)."""
        return torch.float32 if self.exact_boxes else torch.bfloat16

    @property
    def box_bytes_per_node(self) -> int:
        """Analytic node-box storage (lo + hi, 3 axes) per node."""
        if self.node_format == "compressed":
            return 6  # u8 per axis per bound
        return 12 if self.precision == "bf16" else 24

    def validate(self) -> "DatapathConfig":
        if self.arity not in (4, 8):
            raise ValueError(f"arity must be 4 or 8, got {self.arity}")
        if self.stack_size < 1:
            raise ValueError(f"stack_size must be >= 1, got {self.stack_size}")
        if self.precision not in BOX_PRECISIONS:
            raise ValueError(f"precision must be one of {BOX_PRECISIONS}, "
                             f"got {self.precision!r}")
        if self.node_format not in NODE_FORMATS:
            raise ValueError(f"node_format must be one of {NODE_FORMATS}, "
                             f"got {self.node_format!r}")
        return self


DEFAULT_CONFIG = DatapathConfig()


def resolve_config(config: DatapathConfig | None) -> DatapathConfig:
    """``None`` -> :data:`DEFAULT_CONFIG` (BVH4 / stack 64 / fp32 / fp32);
    any other config is validated."""
    if config is None:
        return DEFAULT_CONFIG
    return config.validate()


class BVH4(NamedTuple):
    node_lo: torch.Tensor  # (num_nodes, 3) f32 -- implicit A-ary heap, root first
    node_hi: torch.Tensor  # (num_nodes, 3) f32
    leaf_tri: torch.Tensor  # (A**depth,) i32 -- triangle per leaf, -1 = pad
    triangles: Triangle  # the original (unsorted) soup, (N, 3) each
    leaf_perm: torch.Tensor  # (A**depth,) i32 -- slot assignment before the
    # degenerate cull (-1 = empty pad slot)


def bvh_depth(n_triangles: int, arity: int = 4) -> int:
    """A build's default depth, computed as the reference computes it:
    ``ceil(log_arity(n))`` in floating point (min 1).  That is the smallest
    D with arity**D >= n except at some exact powers of 8 (8**7 gives 8),
    where the reference builds one level deeper, and so does the port."""
    return max(1, math.ceil(math.log(max(n_triangles, 2), arity)))


def bvh4_depth(n_triangles: int) -> int:
    """Static tree depth: smallest D with 4**D >= n (min 1)."""
    return bvh_depth(n_triangles, 4)


def leaf_depth(n_leaves: int, arity: int = 4) -> int:
    """The depth of a complete tree with ``n_leaves`` leaf slots: the
    smallest D >= 1 with arity**D >= n_leaves, in integers (the floating
    log of :func:`bvh_depth` gives 8 for the 8**7 slots of a depth-7 BVH8)."""
    depth = 1
    while arity**depth < n_leaves:
        depth += 1
    return depth


def depth_of(bvh: BVH4, arity: int = 4) -> int:
    """Recover the static depth from the leaf array length (arity**depth)."""
    return leaf_depth(bvh.leaf_tri.shape[0], arity)


def level_offset(level: int, arity: int = 4) -> int:
    return (arity**level - 1) // (arity - 1)


def num_nodes(depth: int, arity: int = 4) -> int:
    return level_offset(depth + 1, arity)


def fit_nodes(leaf_lo: torch.Tensor, leaf_hi: torch.Tensor, depth: int,
              arity: int = 4) -> tuple[torch.Tensor, torch.Tensor]:
    """Bottom-up AABB fit: ``depth`` ``arity``-to-1 reductions from the
    ``(arity**depth, 3)`` leaf boxes to ``(num_nodes, 3)``, root first.
    Inverted (empty) leaves propagate as inverted internal boxes.  The
    sweeps run on :func:`~repro_torch.core.knn.order_key` keys, so -0.0
    orders below +0.0 as in the reference's reductions; lo and hi sweep
    as one min tree, hi as its keys' complements (``~key(x)`` is the key
    of ``-x``), one reduction a level."""
    keys = order_key(torch.stack([leaf_lo, leaf_hi]))  # (2, leaves, 3)
    keys[1].bitwise_not_()
    levels = [keys]
    for _ in range(depth):
        levels.append(levels[-1].reshape(2, -1, arity, 3).amin(dim=2))
    nodes = torch.cat(levels[::-1], dim=1)
    nodes[1].bitwise_not_()
    node_lo, node_hi = key_value(nodes)
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


# ---------------------------------------------------------------------------
# Conservative node-box codecs (DatapathConfig.precision / .node_format):
# lo only ever moves down and hi up, so a decoded box holds the exact one.
# ---------------------------------------------------------------------------

_BF16_REL = 2.0**-7  # widening bias; dominates the bf16 half-ulp of 2^-9
_BF16_ABS = 1e-30  # absolute floor, so exact-zero bounds move too


def _bf16_snap(widened: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Round ``widened`` to the nearest bf16 (ties to even, as XLA's cast)
    and back; non-finite ``x`` (the inverted pad boxes) passes unchanged."""
    snapped = widened.to(torch.bfloat16).to(torch.float32)
    return torch.where(torch.isfinite(x), snapped, x)


def _bf16_down(x: torch.Tensor) -> torch.Tensor:
    """A bf16-grid value <= x: widen by 2^-7 |x| + 1e-30, then round (the
    bias dominates the cast's half-ulp, so the result stays below x)."""
    return _bf16_snap(x - _BF16_REL * x.abs() - _BF16_ABS, x)


def _bf16_up(x: torch.Tensor) -> torch.Tensor:
    """A bf16-grid value >= x (mirror of :func:`_bf16_down`)."""
    return _bf16_snap(x + _BF16_REL * x.abs() + _BF16_ABS, x)


def quantize_boxes_bf16(lo: torch.Tensor, hi: torch.Tensor
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Conservatively widen boxes onto the bf16 grid (lo down, hi up)."""
    return _bf16_down(lo), _bf16_up(hi)


def compress_nodes(node_lo: torch.Tensor, node_hi: torch.Tensor, depth: int,
                   arity: int = 4) -> tuple[torch.Tensor, torch.Tensor]:
    """Parent-relative 8-bit child-box quantization, decoded at build.

    Top down, level by level: the root keeps its f32 box; every other
    node's bounds snap to a 256-step grid over its decoded parent's box,
    with a one-step conservative fixup, and then onto the bf16 grid.  A
    zero-extent parent passes its children's bounds through, and so does
    an empty (inverted) one.
    """
    out_lo, out_hi = [node_lo[:1]], [node_hi[:1]]  # the root stays exact
    for level in range(1, depth + 1):
        start, stop = level_offset(level, arity), level_offset(level + 1, arity)
        lo, hi = node_lo[start:stop], node_hi[start:stop]
        # the decoded parents' boxes, repeated over each parent's children
        p_lo = out_lo[-1].repeat_interleave(arity, dim=0)
        p_hi = out_hi[-1].repeat_interleave(arity, dim=0)
        step = (p_hi - p_lo) / torch.full_like(p_lo, 255.0)
        safe = torch.where(step > 0.0, step, torch.ones_like(step))
        q_lo = torch.floor((lo - p_lo) / safe).clamp(0.0, 255.0)
        q_hi = torch.ceil((hi - p_lo) / safe).clamp(0.0, 255.0)
        d_lo = p_lo + q_lo * safe
        d_hi = p_lo + q_hi * safe
        # one-step fixup where the divide's rounding fell a step short,
        # then clamp to the parent box
        d_lo = torch.maximum(p_lo, torch.where(d_lo > lo, d_lo - safe, d_lo))
        d_hi = torch.minimum(p_hi, torch.where(d_hi < hi, d_hi + safe, d_hi))
        d_lo = torch.where((step > 0.0) & torch.isfinite(lo), d_lo, lo)
        d_hi = torch.where((step > 0.0) & torch.isfinite(hi), d_hi, hi)
        out_lo.append(_bf16_down(d_lo))
        out_hi.append(_bf16_up(d_hi))
    return torch.cat(out_lo, dim=0), torch.cat(out_hi, dim=0)


def encode_nodes(node_lo: torch.Tensor, node_hi: torch.Tensor, depth: int,
                 config: DatapathConfig | None) -> tuple[torch.Tensor, torch.Tensor]:
    """The config's node-box codec after :func:`fit_nodes`: the one hook
    every builder and refit calls, so a refit encodes as a build does."""
    config = resolve_config(config)
    if config.node_format == "compressed":
        return compress_nodes(node_lo, node_hi, depth, config.arity)
    if config.precision == "bf16":
        return quantize_boxes_bf16(node_lo, node_hi)
    return node_lo, node_hi
