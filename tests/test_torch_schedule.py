"""The neighbour kernel's schedule and variant choice, on the CPU.

The CUDA kernel (``csrc/neighbor.cu``) serves its queries in
``query_order``'s Z-order and keeps its top-k list in registers up to a
capacity, in device memory above it (``neighbor_variant``).  Neither can
change a record, because each query's loop is its own; these tests hold
the host side of that claim: the order is a deterministic, stable
permutation that takes any coordinates, and ``neighbor_wavefront`` (the
kernel's plain version) run in that order and scattered back gives the
unpermuted record bit for bit, ``rounds`` included.
"""
import numpy as np
import pytest
import torch

from repro_torch.api import PointCloudScene
from repro_torch.core.build.lbvh import _U32, _expand_bits, morton3d
from repro_torch.core.neighbor import neighbor_wavefront, point_queries, point_sq_norms
from repro_torch.kernels.traverse import (NEIGHBOR_CAPACITIES, neighbor_variant,
                                          pack_point_bvh, query_order)
from test_torch_models import one_torch_thread  # noqa: F401  (autouse fixture)


def _clustered(n, seed):
    rng = np.random.default_rng(seed)
    centres = rng.uniform(-4, 4, (n // 100, 3))
    return (np.repeat(centres, 100, axis=0)
            + rng.normal(scale=0.06, size=(n, 3))).astype(np.float32)


@pytest.fixture(scope="module")
def cloud():
    pts = _clustered(3000, 21)
    return pts, PointCloudScene.from_points(pts, device="cpu")


def _bitwise_morton(points01):
    """morton3d as the per-call bit spreading of the LBVH builder: the
    form its 1024-entry table replaces."""
    scaled = torch.clamp(points01 * 1024.0, 0.0, 1023.0).to(torch.int64)
    x, y, z = (_expand_bits(scaled[:, a]) for a in range(3))
    return ((x << 2) | (y << 1) | z) & _U32


def test_morton3d_table_matches_the_bitwise_form():
    """Every 10-bit value on every axis (at a cell's low edge, middle and
    top), the faces, points outside [0, 1] and +-inf give the bitwise
    form's codes; a NaN coordinate gives the code of 0 there."""
    cells = torch.arange(1024, dtype=torch.float32)
    axis = torch.cat([(cells + f) / 1024.0 for f in (0.0, 0.5, 0.999)]
                     + [torch.tensor([0.0, 1.0, -0.25, 1.5, 7.0, -3.0,
                                      float("inf"), float("-inf")])])
    n = axis.shape[0]
    pts = torch.stack([axis, axis.roll(n // 3), axis.flip(0)], dim=1)
    got = morton3d(pts)
    assert got.dtype == torch.int64
    assert torch.equal(got, _bitwise_morton(pts))
    assert int(got.max()) < 2**30
    nan = pts[:50].clone()
    nan[::2, 0] = float("nan")
    nan[1::3, 2] = float("nan")
    assert torch.equal(morton3d(nan), _bitwise_morton(torch.nan_to_num(nan, nan=0.0)))


def test_query_order_is_a_stable_permutation():
    rng = np.random.default_rng(22)
    pts = rng.uniform(-1, 1, (500, 3)).astype(np.float32)
    pts[100:140] = pts[0]  # ties: equal codes keep the caller's order
    pts[200] = [5.0, -7.0, 0.5]  # outside the box
    pts[201] = [np.inf, -np.inf, 0.0]
    pts[202:205, 1] = np.nan
    lo, hi = torch.full((3,), -1.0), torch.full((3,), 1.0)
    q = torch.as_tensor(pts)
    order = query_order(q, lo, hi)
    assert order.dtype == torch.int32 and order.shape == (500,)
    assert sorted(order.tolist()) == list(range(500))
    assert torch.equal(order, query_order(q, lo, hi))
    # the codes along the order never fall, and equal codes keep index order
    codes = morton3d((q - lo) / (hi - lo))[order.long()]
    assert bool((codes[1:] >= codes[:-1]).all())
    tie = codes[1:] == codes[:-1]
    assert bool((order[1:][tie] > order[:-1][tie]).all())
    pos = {int(i): r for r, i in enumerate(order.tolist())}
    assert [pos[i] for i in (0, *range(100, 140))] == sorted(pos[i] for i in (0, *range(100, 140)))
    # out-of-box points clamp to the faces; NaN counts as the low face
    clamped = torch.tensor([[1.0, -1.0, 0.5], [1.0, -1.0, 0.0]])
    assert torch.equal(morton3d((q[200:202] - lo) / (hi - lo)),
                       morton3d((clamped - lo) / (hi - lo)))
    nan_rows = q[202:205].clone()
    nan_rows[:, 1] = -1.0
    assert torch.equal(codes[[pos[i] for i in (202, 203, 204)]],
                       morton3d((nan_rows - lo) / (hi - lo)))


@pytest.mark.parametrize("mode,k,radius", [("nearest", 1, None), ("nearest", 16, None),
                                           ("nearest", 65, None), ("within", 8, 0.1)])
def test_permuted_queries_give_the_same_record(cloud, mode, k, radius):
    pts, c = cloud
    rng = np.random.default_rng(23)
    queries = np.concatenate([pts[rng.permutation(3000)[:300]],
                              rng.normal(size=(20, 3)).astype(np.float32) * 3])
    sq = point_sq_norms(c.points)
    rays = point_queries(queries, radius, device="cpu")
    want = neighbor_wavefront(c.bvh, sq, rays, c.depth, k, mode)
    packed = pack_point_bvh(c.bvh)
    order = query_order(rays.origin, packed.root[0], packed.root[1]).long()
    assert not torch.equal(order, torch.arange(order.shape[0]))
    got = neighbor_wavefront(c.bvh, sq, point_queries(queries[order.numpy()], radius,
                                                      device="cpu"), c.depth, k, mode)
    for f in want._fields:
        g = getattr(got, f)
        if g.ndim:  # scatter each row back to the caller's position
            g = torch.empty_like(g).index_copy_(0, order, g)
        if g.dtype == torch.float32:
            g, w = g.view(torch.int32), getattr(want, f).view(torch.int32)
        else:
            w = getattr(want, f)
        assert torch.equal(g, w), f


def test_neighbor_variant_takes_every_k():
    assert NEIGHBOR_CAPACITIES == tuple(sorted(NEIGHBOR_CAPACITIES))
    for k in range(1, 301):
        v = neighbor_variant(k)
        if v == "global":
            assert k > NEIGHBOR_CAPACITIES[-1]
        else:
            assert v in NEIGHBOR_CAPACITIES and k <= v
            assert all(cap < k for cap in NEIGHBOR_CAPACITIES if cap < v)
    for k in (0, -3):
        with pytest.raises(ValueError, match="k must be"):
            neighbor_variant(k)


def test_pack_point_bvh_layout(cloud):
    """The kernel's operands hold the tree's own values: each node above
    the leaf parents its children's boxes as rows of 4, each leaf slot its
    point and squared norm (zeros where the slot is empty)."""
    pts, c = cloud
    packed = pack_point_bvh(c.bvh)
    n_inner = packed.kids.shape[0]
    assert n_inner == (4 ** (c.depth - 1) - 1) // 3
    boxes = packed.kids.view(n_inner, 2, 3, 4)
    kids_lo = c.bvh.node_lo[1:4 * n_inner + 1].view(n_inner, 4, 3)
    kids_hi = c.bvh.node_hi[1:4 * n_inner + 1].view(n_inner, 4, 3)
    assert torch.equal(boxes[:, 0], kids_lo.transpose(1, 2))
    assert torch.equal(boxes[:, 1], kids_hi.transpose(1, 2))
    leaf = c.bvh.leaf_tri
    assert torch.equal(packed.leaf, leaf.to(torch.int32))
    full = leaf >= 0
    assert torch.equal(packed.pts[full, :3], c.points[leaf[full].long()])
    assert torch.equal(packed.pts[full, 3], point_sq_norms(c.points)[leaf[full].long()])
    assert not packed.pts[~full].any()
    assert torch.equal(packed.root, torch.stack([c.bvh.node_lo[0], c.bvh.node_hi[0]]))
