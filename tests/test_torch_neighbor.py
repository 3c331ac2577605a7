"""The port's tree neighbour search held against the JAX reference.

Builder parity and traversal parity are tested apart: ``repro`` builds a
point BVH, ``repro_torch.convert.point_cloud_from_numpy`` carries it
across through numpy, and both packages traverse the very same tree.
Tolerances, and why:

* ``point_box_test``, ``insert_sorted``, ``leaf_dist_sq``,
  ``prune_bound`` and ``build_point_bvh`` are **bit-equal** to the
  reference's eager functions, where every op rounds on its own as the
  port's do.
* ``neighbor_wavefront`` against the reference's jitted loop and its
  Pallas kernel (interpret mode): ``index``, ``valid``, ``count``,
  ``box_jobs``, ``point_jobs`` and ``rounds`` are **exact**; ``dist_sq``
  differs, because XLA on the CPU contracts the products of
  ``(|q|^2 - 2 q.c) + |c|^2`` into FMAs inside the jitted loop.  Every
  distance the port keeps is bit-equal to the reference's eager
  ``leaf_dist_sq`` for that (query, point) pair, and within 12 u
  (|q|^2 + |c|^2) of the jitted one (u = 2^-24: each value lies within
  6 u of the exact one, at most 6 roundings on terms no larger than that
  sum).
* Tree against brute force: equal sets and counts outside the reference's
  own boundary band ``|d^2 - r^2| <= 1e-5 (1 + r^2)``
  (``tests/test_fuzz_backends.py``), and nearest rank-equivalent through
  the brute scores.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import PointCloudScene as JCloud
from repro.core import Box as JBox
from repro.core.build.points import build_point_bvh as jbuild_point_bvh
from repro.core.datapath import point_box_test as jpoint_box_test
from repro.core.knn import squared_norms as jsquared_norms
from repro.kernels.traverse import neighbor_fused as jneighbor_fused
from repro_torch.api import DatapathConfig, PointCloudScene, neighbor_backends
from repro_torch.convert import point_cloud_from_numpy
from repro_torch.core import neighbor as tn
from repro_torch.core.build.points import build_point_bvh
from repro_torch.core.build.quality import clustered_soup
from repro_torch.core.datapath import point_box_test
from repro_torch.core.types import Box
from repro_torch.kernels.traverse import neighbor_fused, neighbor_packed, pack_point_bvh
from test_torch_models import one_torch_thread  # noqa: F401  (autouse fixture)

jn = importlib.import_module("repro.core.neighbor")

FIELDS = ("index", "valid", "count", "box_jobs", "point_jobs", "rounds")
U = 2.0 ** -24


def _pts(n, seed=0):
    return np.random.default_rng(seed).normal(size=(n, 3)).astype(np.float32)


def _t(x):
    return torch.as_tensor(np.array(x))


def _bits(x):
    x = np.asarray(x)
    return x.view(np.int32) if x.dtype == np.float32 else x


def _carried(pts):
    """``repro``'s point BVH, and the port's cloud over the same tree."""
    res = jbuild_point_bvh(jnp.asarray(pts))
    b = res.bvh
    cloud = point_cloud_from_numpy(b.node_lo, b.node_hi, b.leaf_tri, b.triangles.a,
                                   b.leaf_perm, res.depth, device="cpu")
    return res, cloud


def _jref(res, pts, queries, k, mode, radius):
    return jn.neighbor_wavefront(res.bvh, jsquared_norms(jnp.asarray(pts)),
                                 jn.point_queries(jnp.asarray(queries), radius),
                                 res.depth, k, mode)


def _port(cloud, queries, k, mode, radius):
    return tn.neighbor_wavefront(cloud.bvh, tn.point_sq_norms(cloud.points),
                                 tn.point_queries(queries, radius, device="cpu"),
                                 cloud.depth, k, mode)


def _assert_record(got, want, pts, queries):
    for f in FIELDS:
        np.testing.assert_array_equal(_bits(getattr(got, f)), _bits(getattr(want, f)),
                                      err_msg=f)
    g, w = got.dist_sq.numpy(), np.asarray(want.dist_sq)
    idx = np.maximum(np.asarray(want.index), 0)
    p64, q64 = pts.astype(np.float64), queries.astype(np.float64)
    scale = (q64 * q64).sum(1)[:, None] + (p64 * p64).sum(1)[idx]
    fin = np.isfinite(w)
    np.testing.assert_array_equal(np.isfinite(g), fin)
    assert (np.abs(g[fin] - w[fin]) <= 12 * U * scale[fin]).all()


# ---------------------------------------------------------------------------
# stage units
# ---------------------------------------------------------------------------


def test_point_box_test_hand_values():
    boxes = Box(lo=torch.tensor([[-1.0, -1, -1], [1, 2, 0], [-3, -3, -3], [0, 0, 2]]),
                hi=torch.tensor([[1.0, 1, 1], [2, 3, 1], [-2, -2, -2], [1, 1, 3]]))
    res = point_box_test(torch.zeros(3), boxes)
    assert res.dist_sq.tolist() == [0.0, 4.0, 5.0, 12.0]
    assert res.box_index.tolist() == [0, 3, 1, 2]


def test_point_box_test_bit_equal_to_reference():
    rng = np.random.default_rng(3)
    p = rng.normal(size=(300, 3)).astype(np.float32)
    lo = rng.uniform(-2, 0.5, (300, 4, 3)).astype(np.float32)
    hi = (lo + rng.uniform(0, 2, (300, 4, 3))).astype(np.float32)
    lo[::7, 2], hi[::7, 2] = np.inf, -np.inf  # inverted pad boxes
    lo[::5, 1] = hi[::5, 1] = p[::5]  # degenerate point boxes, distance 0
    want = jpoint_box_test(jnp.asarray(p), JBox(jnp.asarray(lo), jnp.asarray(hi)))
    got = point_box_test(_t(p), Box(_t(lo), _t(hi)))
    np.testing.assert_array_equal(_bits(got.dist_sq), _bits(want.dist_sq))
    np.testing.assert_array_equal(got.box_index.numpy(), np.asarray(want.box_index))
    assert torch.isinf(got.dist_sq[::7, -1]).all()


def test_insert_sorted_keeps_the_earlier_of_equal_distances():
    best_d = torch.full((3, 2), float("inf"))
    best_i = torch.full((3, 2), -1, dtype=torch.int32)
    for d, i in ((2.0, 7), (1.0, 8), (2.0, 9), (0.5, 10)):
        best_d, best_i = tn.insert_sorted(best_d, best_i, torch.tensor([d, d]),
                                          torch.tensor([i, i], dtype=torch.int32),
                                          torch.tensor([True, False]))
    assert best_d[:, 0].tolist() == [0.5, 1.0, 2.0]
    assert best_i[:, 0].tolist() == [10, 8, 7]  # 9 tied with 7 and lost
    assert best_i[:, 1].tolist() == [-1, -1, -1]


def test_stage_helpers_bit_equal_to_reference():
    rng = np.random.default_rng(4)
    k, lanes = 5, 64
    best_d = np.full((k, lanes), np.inf, np.float32)
    best_i = np.full((k, lanes), -1, np.int32)
    jd, ji, td, ti = jnp.asarray(best_d), jnp.asarray(best_i), _t(best_d), _t(best_i)
    for step in range(12):
        d = rng.integers(0, 6, lanes).astype(np.float32)  # many ties
        i = np.full(lanes, step, np.int32)
        acc = rng.uniform(size=lanes) < 0.8
        jd, ji = jn.insert_sorted(jd, ji, jnp.asarray(d), jnp.asarray(i), jnp.asarray(acc))
        td, ti = tn.insert_sorted(td, ti, _t(d), _t(i), _t(acc))
    np.testing.assert_array_equal(_bits(td), _bits(jd))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))

    p = rng.normal(size=(64, 3)).astype(np.float32)
    c = rng.normal(size=(64, 4, 3)).astype(np.float32)
    c2 = np.asarray(jsquared_norms(jnp.asarray(c)))
    np.testing.assert_array_equal(_bits(tn.point_sq_norms(_t(c))), _bits(c2))
    np.testing.assert_array_equal(
        _bits(tn.leaf_dist_sq(_t(p), _t(c), _t(c2))),
        _bits(jn.leaf_dist_sq(jnp.asarray(p), jnp.asarray(c), jnp.asarray(c2))))
    r_sq = rng.uniform(0, 2, 64).astype(np.float32)
    r_sq[::9] = np.inf
    kth = rng.uniform(0, 2, 64).astype(np.float32)
    q_sq = (p * p).sum(1).astype(np.float32)
    for mode in tn.NEIGHBOR_MODES:
        np.testing.assert_array_equal(
            _bits(tn.prune_bound(_t(r_sq), _t(kth), _t(q_sq), mode)),
            _bits(jn.prune_bound(jnp.asarray(r_sq), jnp.asarray(kth),
                                 jnp.asarray(q_sq), mode)))


# ---------------------------------------------------------------------------
# builder
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cloud", ["normal", "clustered"])
def test_build_point_bvh_bit_equal_to_reference(cloud):
    if cloud == "normal":
        pts = _pts(250)
    else:
        pts = clustered_soup(np.random.default_rng(9), 6, 50, device="cpu").a.numpy()
    for depth in (None,) if cloud == "normal" else (5,):
        want = jbuild_point_bvh(jnp.asarray(pts), depth=depth)
        got = build_point_bvh(_t(pts), depth=depth)
        assert got.depth == want.depth and got.builder == "lbvh"
        for f in ("node_lo", "node_hi", "leaf_tri", "leaf_perm"):
            np.testing.assert_array_equal(_bits(getattr(got.bvh, f)),
                                          _bits(getattr(want.bvh, f)), err_msg=f)
        assert torch.equal(got.bvh.triangles.a, got.bvh.triangles.c)


def test_build_point_bvh_rejects():
    # "sah" is a registered core now; a wider tree is what clouds refuse
    assert build_point_bvh(_t(_pts(10)), builder="sah").builder == "sah"
    with pytest.raises(ValueError, match="4-wide"):
        build_point_bvh(_t(_pts(10)), config=DatapathConfig(arity=8))
    with pytest.raises(ValueError, match="unknown point builder"):
        build_point_bvh(_t(_pts(10)), builder="median")
    with pytest.raises(ValueError, match=r"\(N, 3\)"):
        build_point_bvh(torch.zeros((10, 4)))
    with pytest.raises(ValueError, match="leaf slots"):
        build_point_bvh(_t(_pts(20)), depth=2)


# ---------------------------------------------------------------------------
# the plain engine, and the packed path, against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode,k,radius", [("within", 8, 0.6), ("nearest", 5, 0.3),
                                           ("nearest", 70, 0.9)])
def test_neighbor_wavefront_matches_jitted_reference(mode, k, radius):
    pts, queries = _pts(250, 5), _pts(48, 6)
    queries[:8] = pts[:8]  # self-queries: distance ~0 under cancellation
    res, cloud = _carried(pts)
    got = _port(cloud, queries, k, mode, radius)
    _assert_record(got, _jref(res, pts, queries, k, mode, radius), pts, queries)
    # every distance the port kept is the reference's op-by-op value for
    # that (query, point) pair, bit for bit
    idx = np.maximum(got.index.numpy(), 0)
    want = jn.leaf_dist_sq(jnp.asarray(queries), jnp.asarray(pts[idx]),
                           jsquared_norms(jnp.asarray(pts))[idx])
    ok = got.valid.numpy()
    np.testing.assert_array_equal(_bits(got.dist_sq.numpy()[ok]),
                                  _bits(np.asarray(want)[ok]))


@pytest.mark.parametrize("mode,k,radius", [("within", 6, 0.9), ("nearest", 70, 0.9)])
def test_neighbor_matches_reference_pallas_kernel(mode, k, radius):
    pts, queries = _pts(64, 7), _pts(32, 8)
    res, cloud = _carried(pts)
    want = jneighbor_fused(res.bvh, jn.point_queries(jnp.asarray(queries), radius),
                           res.depth, k, mode=mode, interpret=True)
    _assert_record(_port(cloud, queries, k, mode, radius), want, pts, queries)


def test_clamped_push_matches_reference_at_a_tiny_stack(monkeypatch):
    """At stack 2 the push overwrites the top slot while sp keeps counting,
    and the pop reads the clamped slot, as in the reference."""
    monkeypatch.setattr(jn, "STACK_SIZE", 2)
    monkeypatch.setattr(tn, "STACK_SIZE", 2)
    pts, queries = _pts(250, 10), _pts(20, 11)
    res, cloud = _carried(pts)
    got = _port(cloud, queries, 4, "within", 1.0)
    _assert_record(got, _jref(res, pts, queries, 4, "within", 1.0), pts, queries)
    assert int(got.count.sum()) < int(_port_full(cloud, queries).count.sum())


def _port_full(cloud, queries):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tn, "STACK_SIZE", 64)
        return _port(cloud, queries, 4, "within", 1.0)


def test_neighbor_fused_cpu_path_is_the_plain_version():
    """On a CPU tree the wrapper runs ``neighbor_wavefront``; the packed
    launcher takes CUDA operands only."""
    pts, queries = _pts(250, 12), _pts(40, 13)
    _, cloud = _carried(pts)
    packed = pack_point_bvh(cloud.bvh)
    assert packed.pts.shape == (256, 4) and packed.leaf.shape == (256,)
    assert packed.kids.shape == (21, 24) and packed.root.shape == (2, 3)
    for mode, k, radius in (("within", 8, 0.7), ("nearest", 16, None)):
        want = _port(cloud, queries, k, mode, radius)
        rays = tn.point_queries(queries, radius, device="cpu")
        got = neighbor_fused(cloud.bvh, rays, cloud.depth, k, mode=mode)
        for f in want._fields:
            np.testing.assert_array_equal(_bits(getattr(got, f)),
                                          _bits(getattr(want, f)), err_msg=f)
        assert int(want.rounds) == int(want.box_jobs.max())
        with pytest.raises(ValueError, match="CUDA"):
            neighbor_packed(packed, rays, cloud.depth, k, mode=mode)
    empty = neighbor_fused(cloud.bvh, tn.point_queries(np.zeros((0, 3), np.float32),
                                                       device="cpu"), cloud.depth, 3)
    assert empty.dist_sq.shape == (0, 3) and int(empty.rounds) == 0


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def cloud_pair():
    pts = _pts(300, 14)
    return pts, PointCloudScene.from_points(pts, device="cpu"), \
        JCloud.from_points(jnp.asarray(pts))


def test_engine_tree_backends_are_the_plain_engine(cloud_pair):
    """Both tree backends (``tree_cuda`` runs its plain version here),
    chunked and padded, give ``neighbor_wavefront``'s record on the
    cloud's own tree, bit for bit (``rounds`` re-reduced over chunks)."""
    _, cloud, _ = cloud_pair
    queries = _pts(40, 15)
    eng = cloud.engine(chunk_size=16)
    near = _port(cloud, queries, 6, "nearest", None)
    ball = _port(cloud, queries, 5, "within", 0.5)
    for backend in ("tree_wavefront", "tree_cuda"):
        got = eng.nearest(queries, 6, backend=backend)
        assert torch.equal(got.indices, near.index)
        assert torch.equal(got.scores.view(torch.int32), near.dist_sq.view(torch.int32))
        rec = eng.neighbor_search(queries, 5, radius=0.5, backend=backend)
        for f in ball._fields:
            assert torch.equal(getattr(rec, f), getattr(ball, f)), f
        got = eng.within(queries, 0.5, 5, backend=backend)
        assert torch.equal(got.indices, ball.index)
        assert torch.equal(got.within, ball.valid)
        assert torch.equal(eng.count_within(queries, 0.5, backend=backend), ball.count)
    assert set(neighbor_backends()) == {"tree_wavefront", "tree_cuda"}


def test_tree_matches_brute_outside_the_boundary_band(cloud_pair):
    pts, cloud, _ = cloud_pair
    queries = _pts(40, 16)
    queries[:5] = pts[:5]
    eng = cloud.engine()
    n = cloud.size
    for radius in (0.3, 0.8):
        rec = eng.neighbor_search(queries, n, radius=radius, backend="tree_wavefront")
        oracle = eng.scores(queries, backend="mxu").numpy()
        r_sq = radius * radius
        tol = 1e-5 * (1.0 + r_sq)
        idx, valid = rec.index.numpy(), rec.valid.numpy()
        for i in range(queries.shape[0]):
            got = set(idx[i][valid[i]])
            assert set(np.flatnonzero(oracle[i] <= r_sq - tol)) <= got
            assert got <= set(np.flatnonzero(oracle[i] <= r_sq + tol))
        counts = rec.count.numpy()
        assert ((oracle <= r_sq - tol).sum(1) <= counts).all()
        assert (counts <= (oracle <= r_sq + tol).sum(1)).all()
    tree = eng.nearest(queries, 5, backend="tree_wavefront")
    brute = eng.nearest(queries, 5, backend="mxu")
    picked = np.take_along_axis(oracle, tree.indices.numpy(), 1)
    np.testing.assert_allclose(picked, brute.scores.numpy(), rtol=1e-4, atol=1e-5)


def test_auto_policy_on_cpu():
    big = PointCloudScene.from_points(_pts(5000, 17), device="cpu").engine()
    assert big.resolve_neighbor_backend("nearest", "euclidean", k=8) == "tree_wavefront"
    assert big.resolve_neighbor_backend("nearest", "euclidean", k=400) == "mxu"
    assert big.resolve_neighbor_backend("within", "euclidean", radius=0.05) == "tree_wavefront"
    assert big.resolve_neighbor_backend("within", "euclidean", radius=5.0) == "mxu"
    assert big.resolve_neighbor_backend("nearest", "cosine", k=8) == "mxu"
    small = PointCloudScene.from_points(_pts(100, 18), device="cpu").engine()
    assert small.resolve_neighbor_backend("nearest", "euclidean", k=1) == "mxu"
    q = _pts(6, 19)
    assert torch.equal(big.nearest(q, 8).indices,
                       big.nearest(q, 8, backend="tree_wavefront").indices)
    assert torch.equal(small.neighbor_search(q, 3, radius=0.4).count,
                       small.neighbor_search(q, 3, radius=0.4,
                                             backend="tree_wavefront").count)
    with pytest.raises(ValueError, match="euclidean"):
        big.nearest(q, 3, "cosine", backend="tree_wavefront")


def test_tree_edges(cloud_pair):
    pts, cloud, _ = cloud_pair
    eng = cloud.engine()
    q = _pts(4, 20)
    small = PointCloudScene.from_points(pts[:7], device="cpu").engine()
    res = small.nearest(q, 10, backend="tree_wavefront")
    assert res.indices.shape == (4, 10)
    assert (res.indices[:, 7:] == -1).all() and not res.valid[:, 7:].any()
    assert torch.isinf(res.scores[:, 7:]).all()
    empty = eng.nearest(np.zeros((0, 3), np.float32), 4, backend="tree_wavefront")
    assert empty.scores.shape == (0, 4)
    rec = eng.neighbor_search(np.zeros((0, 3), np.float32), 4, radius=1.0)
    assert rec.count.shape == (0,) and int(rec.rounds) == 0
    with pytest.raises(ValueError, match=r"\(M, 3\)"):
        eng.nearest(np.zeros((2, 4), np.float32), 2, backend="tree_wavefront")
    # refit keeps the topology, as the reference's does: another point
    # count raises (tests/test_torch_refit.py holds the refit itself)
    with pytest.raises(ValueError, match="refit_points needs"):
        PointCloudScene.from_points(pts[:7], device="cpu").refit(pts[:6])


def test_point_cloud_round_trip(cloud_pair):
    pts, _, jcloud = cloud_pair
    b = jcloud.bvh
    cloud = point_cloud_from_numpy(b.node_lo, b.node_hi, b.leaf_tri, b.triangles.a,
                                   b.leaf_perm, jcloud.depth, device="cpu")
    assert cloud.size == jcloud.size and cloud.depth == jcloud.depth
    for f in ("node_lo", "node_hi", "leaf_tri", "leaf_perm"):
        np.testing.assert_array_equal(getattr(cloud.bvh, f).numpy(),
                                      np.asarray(getattr(b, f)))
    np.testing.assert_array_equal(cloud.points.numpy(), np.asarray(jcloud.points))
    assert cloud.root_volume() == jcloud.root_volume()
    np.testing.assert_allclose(cloud.index.sq_norms.numpy(),
                               np.asarray(jcloud.index.sq_norms), rtol=1e-6)


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("the default device is available here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PointCloudScene.from_points(_pts(10))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tn.point_queries(_pts(3))
