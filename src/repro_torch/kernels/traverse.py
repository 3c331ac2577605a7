"""Fused traversal and neighbour kernel wrappers (``csrc/traverse.cu``,
``csrc/neighbor.cu``) and their packing.

The port's counterpart of ``repro/kernels/traverse.py``.  Host side,
:func:`pack_rays` builds the reference's ``(16, n_pad)`` union of ray
rows; :func:`pack_bvh_rows` the reference's tree operands (node boxes as
rows-by-nodes, the leaf table, the triangle soup as 9 vertex rows, each
padded to a multiple of :data:`~repro_torch.kernels.common.LANES`), which
the tests hold against the reference's; :func:`pack_bvh` lays a tree out
for the traversal kernel's vector loads (:class:`PackedBVH`), and
:func:`pack_point_bvh` for the neighbour kernel's.  :func:`traverse_packed`
and :func:`neighbor_packed` launch the CUDA kernels on CUDA operands, one
thread per ray or query; the traversal kernel serves its rays in the
caller's order, the neighbour kernel its queries in :func:`query_order`'s
and picks its variant by :func:`neighbor_variant`.  On CPU operands
:func:`traverse_packed` runs its kernel's plain version,
``core.wavefront.trace_wavefront``, on the tree :func:`unpack_bvh` gives
back; :func:`neighbor_packed` raises, and :func:`neighbor_fused` runs
``core.neighbor.neighbor_wavefront`` on the CPU tree it was given.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core.build.lbvh import morton3d
from ..core.bvh import (BVH4, DatapathConfig, depth_of, level_offset, num_nodes,
                        resolve_config)
from ..core.neighbor import (PRUNE_SLACK, NeighborRecord, check_neighbor_args,
                             empty_neighbors, neighbor_wavefront, point_sq_norms)
from ..core.types import Ray, Triangle
from ..core.wavefront import (RAY_TYPES, WavefrontRecord, default_t_min,
                              trace_wavefront)
from . import nvcc
from .common import LANES, ceil_to, pad_cols

#: the deepest stack the traversal kernel keeps in a thread-local array
#: (``csrc/traverse.cu``); a deeper one lives in per-ray device scratch
LOCAL_STACK = 64

# Ray operand row layout: one (N_RAY_ROWS, n_pad) union bundle.
ROW_T_ORG = 0  # rows 0..2   origin
ROW_T_DIR = 3  # rows 3..5   direction (sign bits drive the slab swap)
ROW_T_INV = 6  # rows 6..8   inverse direction
ROW_T_SHEAR = 9  # rows 9..11  shear constants Sx, Sy, Sz
ROW_T_K = 12  # rows 12..14 kx, ky, kz as f32
ROW_T_EXT = 15  # row 15      extent
N_RAY_ROWS = 16

#: words of a leaf slot in :class:`PackedBVH`: a.xyz | b.xyz | c.xyz as
#: f32, the triangle index as i32 bits, 2 words of padding (48 B)
SLOT_WORDS = 12
SLOT_INDEX = 9


class BVHRows(NamedTuple):
    """The reference's traversal operands (see :func:`pack_bvh_rows`)."""

    nlo: torch.Tensor  # (3, nodes_pad) f32 or bf16, padding columns +inf
    nhi: torch.Tensor  # (3, nodes_pad) f32 or bf16, padding columns -inf
    leaf: torch.Tensor  # (1, leaf_pad) i32, padding -1
    tris: torch.Tensor  # (9, tri_pad) f32: rows a.xyz | b.xyz | c.xyz


class PackedBVH(NamedTuple):
    """The traversal kernel's tree operands (see :func:`pack_bvh`)."""

    kids: torch.Tensor  # (level_offset(depth - 1), 6 * arity) f32 or bf16
    slots: torch.Tensor  # (arity**depth, SLOT_WORDS) f32, index word as i32 bits


def _pad_cols_repeat(x: torch.Tensor, n_to: int) -> torch.Tensor:
    """Pad the last axis to ``n_to`` by repeating column 0 (a valid ray)."""
    pad = n_to - x.shape[-1]
    if pad == 0:
        return x
    return torch.cat([x, x[..., :1].expand(x.shape[:-1] + (pad,))], dim=-1)


def pack_rays(rays: Ray, n_pad: int) -> torch.Tensor:
    """(R,)-batched rays -> one (N_RAY_ROWS, n_pad) union operand, columns
    past R repeating ray 0."""
    k = torch.stack([rays.kx, rays.ky, rays.kz]).to(torch.float32)
    op = torch.cat([rays.origin.T, rays.direction.T, rays.inv.T,
                    rays.shear.T, k, rays.extent[None, :]], dim=0)
    return _pad_cols_repeat(op, n_pad).contiguous()


def unpack_rays(op: torch.Tensor, n: int) -> Ray:
    """Inverse of :func:`pack_rays` for the first ``n`` columns."""
    op = op[:, :n]
    k = op[ROW_T_K:ROW_T_K + 3].to(torch.int32)
    return Ray(origin=op[ROW_T_ORG:ROW_T_ORG + 3].T,
               direction=op[ROW_T_DIR:ROW_T_DIR + 3].T,
               inv=op[ROW_T_INV:ROW_T_INV + 3].T, extent=op[ROW_T_EXT],
               kx=k[0], ky=k[1], kz=k[2],
               shear=op[ROW_T_SHEAR:ROW_T_SHEAR + 3].T)


def pack_bvh_rows(bvh: BVH4, config: DatapathConfig | None = None) -> BVHRows:
    """BVH -> the reference's operands (``repro.kernels.traverse.pack_bvh``),
    each column-padded to a lane multiple.  Padded node columns carry
    inverted boxes; padded leaf slots carry -1.  The narrow configs store
    the node rows as genuine bf16 (``config.packed_box_dtype``): their
    codecs put every bound a box test reads on the bf16 grid (all but the
    root's own box), so the cast is lossless there."""
    config = resolve_config(config)
    nodes_pad = ceil_to(bvh.node_lo.shape[0], LANES)
    inf = float("inf")
    box_dtype = config.packed_box_dtype
    nlo = pad_cols(bvh.node_lo.T, nodes_pad, inf).to(box_dtype).contiguous()
    nhi = pad_cols(bvh.node_hi.T, nodes_pad, -inf).to(box_dtype).contiguous()
    leaf_pad = ceil_to(bvh.leaf_tri.shape[0], LANES)
    leaf = pad_cols(bvh.leaf_tri[None, :].to(torch.int32), leaf_pad, -1)
    tri = bvh.triangles
    tri_pad = ceil_to(tri.a.shape[0], LANES)
    tris = pad_cols(torch.cat([tri.a.T, tri.b.T, tri.c.T], dim=0), tri_pad)
    return BVHRows(nlo, nhi, leaf.contiguous(), tris.contiguous())


def pack_bvh(bvh: BVH4, config: DatapathConfig | None = None) -> PackedBVH:
    """BVH -> the traversal kernel's operands; the session's ``cuda``
    backend calls it once per scene version.  Each node above the leaf
    parents gets one record of its ``arity`` children's boxes, rows
    lo.x | lo.y | lo.z | hi.x | hi.y | hi.z of ``arity`` bounds in
    ``config.packed_box_dtype``, as :func:`pack_bvh_rows` casts them (a box
    test reads a record with 16 B loads); no leaf box is kept (no record
    depends on a leaf parent's box test), nor the root's own box (the root
    is pre-pushed, never tested).  Each leaf slot gets its triangle's 9
    vertex floats and its index (zeros and -1 in an empty slot), in
    leaf-slot order."""
    config = resolve_config(config)
    arity = config.arity
    depth = depth_of(bvh, arity)
    n_inner = level_offset(depth - 1, arity)
    n_slots = arity**depth
    box_dtype = config.packed_box_dtype
    child = [b[1:1 + arity * n_inner].to(box_dtype).reshape(n_inner, arity, 3).transpose(1, 2)
             for b in (bvh.node_lo, bvh.node_hi)]
    kids = torch.cat(child, dim=1).reshape(n_inner, 6 * arity)
    idx = bvh.leaf_tri[:n_slots].to(torch.int32)
    tri = bvh.triangles
    # gathered as vertex rows, then transposed: on the H100 twice as fast
    # as gathering the (n, 9) soup's rows
    verts = torch.cat([tri.a.T, tri.b.T, tri.c.T]).index_select(1, idx.clamp(min=0))
    verts = torch.where(idx >= 0, verts, torch.zeros((), dtype=verts.dtype, device=verts.device))
    pad = torch.zeros((SLOT_WORDS - SLOT_INDEX - 1, n_slots), dtype=verts.dtype,
                      device=verts.device)
    slots = torch.cat([verts, idx.view(torch.float32)[None], pad]).T
    return PackedBVH(kids.contiguous(), slots.contiguous())


def unpack_bvh(packed: PackedBVH, depth: int, arity: int = 4) -> BVH4:
    """The traversal-relevant part of a :class:`BVH4` back from the kernel's
    layout, node boxes as f32: every inner node's children's boxes; the
    root's and the leaves' boxes, which are not stored, NaN.  The soup has
    a row per leaf slot, each triangle a slot holds at its index, NaN
    elsewhere (``leaf_perm`` is not packed; the leaf table stands in)."""
    n_inner = level_offset(depth - 1, arity)
    f32 = torch.float32
    device = packed.slots.device
    nan = torch.full((num_nodes(depth, arity), 3), float("nan"), dtype=f32, device=device)
    node_lo, node_hi = nan.clone(), nan
    kids = packed.kids.to(f32).reshape(n_inner, 2, 3, arity).permute(1, 0, 3, 2)
    for box, child in ((node_lo, kids[0]), (node_hi, kids[1])):
        box[1:1 + arity * n_inner] = child.reshape(arity * n_inner, 3)
    leaf = packed.slots.view(torch.int32)[:, SLOT_INDEX].contiguous()
    soup = torch.full((leaf.shape[0], 9), float("nan"), dtype=f32, device=device)
    filled = leaf >= 0
    soup[leaf[filled].long()] = packed.slots[filled, :SLOT_INDEX]
    return BVH4(node_lo=node_lo, node_hi=node_hi, leaf_tri=leaf,
                triangles=Triangle(soup[:, 0:3], soup[:, 3:6], soup[:, 6:9]),
                leaf_perm=leaf)


def _empty_record(device) -> WavefrontRecord:
    z = torch.zeros((0,), dtype=torch.int32, device=device)
    return WavefrontRecord(t=torch.zeros((0,), device=device), tri_index=z,
                           hit=z.bool(), quadbox_jobs=z, triangle_jobs=z,
                           stack_overflow=z.bool(),
                           rounds=torch.zeros((), dtype=torch.int32,
                                              device=device))


def traverse_packed(packed: PackedBVH, rays: Ray, depth: int, *,
                    ray_type: str = "closest", t_min: float | None = None,
                    max_rounds: int | None = None,
                    config: DatapathConfig | None = None) -> WavefrontRecord:
    """Traverse a ray batch through the fused kernel on pre-packed tree
    operands (:func:`pack_bvh` under the same ``config``).  Same contract
    as ``trace_wavefront``, whose record it returns bit for bit, at every
    arity, box dtype and stack size.  The rays run in the caller's order:
    a Z-order schedule, its sort included, was slower for every ray type
    on the H100."""
    if ray_type not in RAY_TYPES:
        raise ValueError(f"ray_type must be one of {RAY_TYPES}, got {ray_type!r}")
    config = resolve_config(config)
    arity = config.arity
    if t_min is None:
        t_min = default_t_min(ray_type)
    if max_rounds is None:
        max_rounds = level_offset(depth, arity)
    n = rays.origin.shape[0]
    device = rays.origin.device
    if n == 0:
        return _empty_record(device)
    n_pad = ceil_to(n, LANES)
    ray_op = pack_rays(rays, n_pad)
    if not ray_op.is_cuda:
        return trace_wavefront(unpack_bvh(packed, depth, arity), unpack_rays(ray_op, n),
                               depth, ray_type=ray_type, t_min=t_min,
                               max_rounds=max_rounds, config=config)

    f32, i32 = torch.float32, torch.int32
    n_inner = level_offset(depth - 1, arity)
    ptr_rays = nvcc.check_cuda("rays", ray_op, f32, (N_RAY_ROWS, n_pad))
    ptr_kids = nvcc.check_cuda("kids", packed.kids, config.packed_box_dtype,
                               (n_inner, 6 * arity), device)
    ptr_slots = nvcc.check_cuda("slots", packed.slots, f32, (arity**depth, SLOT_WORDS),
                                device)
    if ptr_kids % 16 or ptr_slots % 16:
        raise ValueError("the packed tree's operands must be 16-byte aligned")
    t = torch.empty((n,), dtype=f32, device=device)
    tri = torch.empty((n,), dtype=i32, device=device)
    qb = torch.empty((n,), dtype=i32, device=device)
    ntri = torch.empty((n,), dtype=i32, device=device)
    ovf = torch.empty((n,), dtype=i32, device=device)
    # a stack deeper than the kernel's local array lives in device scratch
    scratch = (torch.empty((config.stack_size, n), dtype=i32, device=device)
               if config.stack_size > LOCAL_STACK else None)
    nvcc.launch("rayflex_traverse", device, ptr_rays, n_pad, n, ptr_kids, ptr_slots, n_inner,
                int(max_rounds), int(ray_type != "closest"), float(t_min),
                config.stack_size, arity, int(config.packed_box_dtype == torch.bfloat16),
                0 if scratch is None else scratch.data_ptr(),
                t.data_ptr(), tri.data_ptr(), qb.data_ptr(), ntri.data_ptr(),
                ovf.data_ptr())
    # rounds: a ray is active from round 0 for exactly quadbox_jobs rounds
    return WavefrontRecord(t=t, tri_index=tri, hit=tri >= 0, quadbox_jobs=qb,
                           triangle_jobs=ntri, stack_overflow=ovf > 0,
                           rounds=qb.max())


def traverse_fused(bvh: BVH4, rays: Ray, depth: int, *,
                   ray_type: str = "closest", t_min: float | None = None,
                   max_rounds: int | None = None,
                   config: DatapathConfig | None = None) -> WavefrontRecord:
    """:func:`traverse_packed` that packs the tree per call; repeated queries
    on one scene should go through the session engine, which packs once
    per scene version."""
    return traverse_packed(pack_bvh(bvh, config), rays, depth,
                           ray_type=ray_type, t_min=t_min,
                           max_rounds=max_rounds, config=config)


# ---------------------------------------------------------------------------
# Fused neighbour traversal: kNN / radius queries over a point BVH4
# ---------------------------------------------------------------------------


class PackedPointBVH(NamedTuple):
    """The neighbour kernel's tree operands (see :func:`pack_point_bvh`)."""

    kids: torch.Tensor  # (level_offset(depth - 1), 24) f32 child boxes
    leaf: torch.Tensor  # (4**depth,) i32 leaf slots, -1 = empty
    pts: torch.Tensor  # (4**depth, 4) f32: x | y | z | ||c||^2 per slot
    root: torch.Tensor  # (2, 3) f32 root box lo, hi


def pack_point_bvh(bvh: BVH4) -> PackedPointBVH:
    """Point BVH4 -> the neighbour kernel's operands, laid out for vector
    loads.  Each node above the leaf parents holds its 4 children's boxes
    as 24 contiguous floats, rows lo.x | lo.y | lo.z | hi.x | hi.y | hi.z
    of 4 (the kernel never reads a leaf's box); each leaf slot holds its
    point and the point's squared norm, derived here from the same array
    the tree holds (zeros in an empty slot, which the kernel skips).  The
    root box sets the query schedule's Z-order curve."""
    depth = depth_of(bvh)
    n_inner = level_offset(depth - 1)
    lo = bvh.node_lo[1:4 * n_inner + 1].reshape(n_inner, 4, 3).transpose(1, 2)
    hi = bvh.node_hi[1:4 * n_inner + 1].reshape(n_inner, 4, 3).transpose(1, 2)
    kids = torch.cat([lo, hi], dim=1).reshape(n_inner, 24).contiguous()
    leaf = bvh.leaf_tri.to(torch.int32).clone()
    pts = bvh.triangles.a
    rows = torch.cat([pts, point_sq_norms(pts)[:, None]], dim=1)
    slots = torch.where((leaf >= 0)[:, None], rows[leaf.clamp(min=0).long()],
                        torch.zeros((), dtype=rows.dtype, device=rows.device))
    root = torch.stack([bvh.node_lo[0], bvh.node_hi[0]])
    return PackedPointBVH(kids, leaf, slots.contiguous(), root.contiguous())


#: register-list capacities of the neighbour kernel's variants
#: (``csrc/neighbor.cu``); a larger k takes the general variant, whose list
#: lives in device memory
NEIGHBOR_CAPACITIES = (1, 2, 4, 8, 16, 32)


def neighbor_variant(k: int) -> int | str:
    """The neighbour kernel variant that serves ``k``: the smallest
    register-list capacity that holds it, else ``"global"`` (the list in
    device memory, any k)."""
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    return next((cap for cap in NEIGHBOR_CAPACITIES if k <= cap), "global")


def query_order(points: torch.Tensor, lo: torch.Tensor,
                hi: torch.Tensor) -> torch.Tensor:
    """The neighbour kernel's query schedule: the (n,) i32 permutation that
    sorts ``points`` along the 30-bit Z-order curve of the box ``lo`` ..
    ``hi`` (the tree's root box), stably, so ties keep the caller's order.
    Points outside the box clamp to its faces; a NaN coordinate counts as
    the box's low face."""
    diff = hi - lo
    extent = torch.where(diff > 1e-12, diff, torch.full_like(diff, 1e-12))
    codes = morton3d((points - lo) / extent)
    # 30-bit codes: an int32 key halves the radix sort's passes
    return torch.argsort(codes.to(torch.int32), stable=True).to(torch.int32)


def neighbor_packed(packed: PackedPointBVH, queries: Ray, depth: int, k: int,
                    *, mode: str = "within",
                    max_rounds: int | None = None) -> NeighborRecord:
    """Neighbour-search a query batch through the fused kernel on
    pre-packed point-BVH operands, which must lie on a CUDA device (the
    CPU route is :func:`neighbor_fused`'s, or the ``tree_wavefront``
    backend's).  Same contract as ``neighbor_wavefront`` (its plain
    version, whose record it returns bit for bit), for every k >= 1.  The
    queries run in :func:`query_order`'s schedule; each query's loop is its
    own, so the order changes no field."""
    check_neighbor_args(k, mode)
    n = queries.origin.shape[0]
    device = queries.origin.device
    if not (device.type == "cuda" and packed.pts.is_cuda):
        raise ValueError(f"neighbor_packed runs the CUDA kernel: expected CUDA "
                         f"operands, got queries on {device} and the tree on "
                         f"{packed.pts.device}")
    if n == 0:
        return empty_neighbors(k, device)
    order = query_order(queries.origin, packed.root[0], packed.root[1])
    return neighbor_launch(packed, pack_rays(queries, ceil_to(n, LANES)), order,
                           n, depth, k, mode=mode, max_rounds=max_rounds)


def neighbor_launch(packed: PackedPointBVH, ray_op: torch.Tensor,
                    order: torch.Tensor | None, n: int, depth: int, k: int, *,
                    mode: str = "within",
                    max_rounds: int | None = None) -> NeighborRecord:
    """One launch of the neighbour kernel on packed CUDA operands: ``n``
    queries in the ``(16, n_pad)`` operand ``ray_op``, served in ``order``
    (None: the caller's), by :func:`neighbor_variant`'s variant for ``k``.
    ``rounds`` is ``max(box_jobs)``: a query is active from round 0 for
    exactly ``box_jobs`` consecutive rounds."""
    check_neighbor_args(k, mode)
    if max_rounds is None:
        max_rounds = level_offset(depth)
    variant = neighbor_variant(k)
    capacity = 0 if variant == "global" else variant
    f32, i32 = torch.float32, torch.int32
    n_pad, n_leaf = ceil_to(n, LANES), 4**depth
    device = ray_op.device
    ptrs = [nvcc.check_cuda("rays", ray_op, f32, (N_RAY_ROWS, n_pad)),
            0 if order is None else nvcc.check_cuda("order", order, i32, (n,), device),
            nvcc.check_cuda("kids", packed.kids, f32, (level_offset(depth - 1), 24),
                            device),
            nvcc.check_cuda("leaf", packed.leaf, i32, (n_leaf,), device),
            nvcc.check_cuda("pts", packed.pts, f32, (n_leaf, 4), device)]
    if any(p % 16 for p in ptrs[2:]):
        raise ValueError("the packed tree's operands must be 16-byte aligned")
    dist = torch.empty((k, n), dtype=f32, device=device)
    index = torch.empty((k, n), dtype=i32, device=device)
    count = torch.empty((n,), dtype=i32, device=device)
    box = torch.empty((n,), dtype=i32, device=device)
    pt = torch.empty((n,), dtype=i32, device=device)
    # the general list's scratch rows (the register variants need none)
    lists = ((torch.empty((k, n), dtype=f32, device=device),
              torch.empty((k, n), dtype=i32, device=device))
             if capacity == 0 else None)
    # the plain version's two pruning constants, rounded to f32 as it
    # rounds them (a Python float against an f32 tensor)
    slack_mul = float(np.float32(1.0 + PRUNE_SLACK))
    slack_add = float(np.float32(PRUNE_SLACK))
    nvcc.launch("rayflex_neighbor", device, ptrs[0], n_pad, n, ptrs[1], *ptrs[2:],
                level_offset(depth - 1), int(max_rounds), int(k),
                int(mode == "nearest"), slack_mul, slack_add, capacity,
                dist.data_ptr(), index.data_ptr(), count.data_ptr(),
                box.data_ptr(), pt.data_ptr(),
                *((0, 0) if lists is None else (t.data_ptr() for t in lists)))
    return NeighborRecord(dist_sq=dist.T, index=index.T, valid=index.T >= 0,
                          count=count, box_jobs=box, point_jobs=pt,
                          rounds=box.max())


def neighbor_fused(bvh: BVH4, queries: Ray, depth: int, k: int, *,
                   mode: str = "within",
                   max_rounds: int | None = None) -> NeighborRecord:
    """:func:`neighbor_packed` that packs the tree per call; repeated
    queries on one cloud should go through the session engine, which packs
    once per cloud version.  On a CPU tree it runs the kernel's plain
    version, ``neighbor_wavefront``."""
    if not bvh.node_lo.is_cuda:
        return neighbor_wavefront(bvh, point_sq_norms(bvh.triangles.a), queries,
                                  depth, k, mode=mode, max_rounds=max_rounds)
    return neighbor_packed(pack_point_bvh(bvh), queries, depth, k, mode=mode,
                           max_rounds=max_rounds)
