"""The port's CUDA kernels on the card, held against their plain versions.

A CUDA kernel has no CPU mode, so every test here needs a GPU; without one
each skips (decided inside the fixture, never at import).  On a GPU
machine:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

The traversal, neighbour and unified-stream kernels round every op as
their plain versions do (``-fmad=false`` and explicit round-to-nearest intrinsics),
so every field is bit-equal.  The distance kernel computes its
products as 3xTF32 on the tensor cores and the norm kernel sums in
another order than their plain versions (one matmul per 128-wide K
block), so their scores are held to ``1e-5 * (|q|^2 + |c|^2)`` for
squared distances, ``1e-5 * |q| |c|`` for dot products and ``1e-5 |c|^2``
for norms; rows holding inf or NaN give the plain version's non-finite
scores exactly.
"""
import os

import numpy as np
import pytest
import torch

from repro_torch.api import RAY_TYPES, PointCloudScene, Scene, VectorIndex, make_ray
from repro_torch.core.neighbor import neighbor_wavefront, point_queries, point_sq_norms
from repro_torch.core.wavefront import trace_wavefront
from repro_torch.kernels import nvcc
from repro_torch.kernels.distance import (K_BLOCK, MODES, NORM_SHORT_WIDE, NORM_WARP_ROW,
                                          NORM_WIDE_MAX_BLOCKS, distance_3xtf32,
                                          distance_cuda, distance_plain, norm_variant,
                                          norms_cuda, norms_plain)
from repro_torch.kernels.raybox import raybox, raybox_plain
from repro_torch.kernels.raytri import raytri, raytri_plain
from repro_torch.kernels.common import LANES, ROW_K, ROW_MASK, ROW_RESET, ROW_VEC_A
from repro_torch.kernels.traverse import (neighbor_launch, neighbor_packed, pack_bvh,
                                          pack_point_bvh, pack_rays, traverse_packed)
from repro_torch.kernels.unified import unified, unified_plain

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _bits_equal(a, b):
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return torch.equal(a, b)


def _rays(rng, n):
    org = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    dirs = rng.normal(size=(n, 3)).astype(np.float32)
    dirs[rng.uniform(size=(n, 3)) < 0.1] = -0.0
    return make_ray(org, dirs, device="cuda")


@pytest.mark.parametrize("n", [1, 129, 4096])
def test_raybox_kernel_bit_equal_to_plain(cuda, n):
    rng = np.random.default_rng(n)
    ray = _rays(rng, n)
    lo = rng.uniform(-3, 2, (12, n)).astype(np.float32)
    hi = (lo + rng.uniform(0, 3, (12, n))).astype(np.float32)
    args = (ray.origin.T.contiguous(), ray.inv.T.contiguous(),
            torch.signbit(ray.direction).float().T.contiguous(),
            torch.as_tensor(lo, device=cuda), torch.as_tensor(hi, device=cuda))
    before = nvcc.launch_counts().get("raybox", 0)
    for k, p in zip(raybox(*args), raybox_plain(*args)):
        assert _bits_equal(k, p)
    assert nvcc.launch_counts()["raybox"] == before + 1


@pytest.mark.parametrize("n", [1, 129, 4096])
def test_raytri_kernel_bit_equal_to_plain(cuda, n):
    rng = np.random.default_rng(100 + n)
    ray = _rays(rng, n)
    verts = [torch.as_tensor(rng.normal(size=(3, n)).astype(np.float32),
                             device=cuda) for _ in range(3)]
    k = torch.stack([ray.kx, ray.ky, ray.kz]).contiguous()
    args = (ray.origin.T.contiguous(), ray.shear.T.contiguous(), k, *verts)
    for a, b in zip(raytri(*args), raytri_plain(*args)):
        assert _bits_equal(a, b)


@pytest.mark.parametrize("scene", ["tetra", "sheet", "cluster"])
def test_fused_kernel_and_cuda_backend_bit_equal_to_wavefront(cuda, scene):
    data = np.load(os.path.join(GOLDEN, f"{scene}.npz"))
    sc = Scene.from_triangles(data["tris"], device=cuda)
    rays = make_ray(data["ray_org"], data["ray_dir"], data["ray_extent"],
                    device=cuda)
    for ray_type in RAY_TYPES:
        want = trace_wavefront(sc.bvh, rays, sc.depth, ray_type=ray_type)
        for got in (traverse_packed(pack_bvh(sc.bvh), rays, sc.depth,
                                    ray_type=ray_type),
                    sc.engine().trace(rays, ray_type, chunk_size=16)):
            for f in want._fields:
                assert _bits_equal(getattr(got, f), getattr(want, f)), f


def test_wrappers_check_their_operands(cuda):
    x3 = torch.zeros((3, 8), device=cuda)
    x12 = torch.zeros((12, 8), device=cuda)
    with pytest.raises(ValueError, match="shape"):
        raybox(x3, x3, x3, x3, x12)
    with pytest.raises(ValueError, match="float32"):
        raybox(x3, x3, x3.double(), x12, x12)
    with pytest.raises(ValueError, match="contiguous"):
        raybox(x3, x3, x3, x12.T.contiguous().T, x12)
    with pytest.raises(ValueError, match="CUDA"):
        raytri(x3, x3.cpu(), x3.int(), x3, x3, x3)


def _score_scale(q, c, mode):
    q2 = (q.double() ** 2).sum(1)
    c2 = (c.double() ** 2).sum(1)
    if mode == "euclidean":
        return q2[:, None] + c2[None, :]
    return q2.sqrt()[:, None] * c2.sqrt()[None, :]


def _assert_scores_close(got, want, scale, rtol=1e-5):
    """Finite scores within ``rtol * scale``; non-finite ones equal (NaN
    where NaN, the same infinity)."""
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    inf = torch.isinf(want)
    assert torch.equal(got[inf], want[inf])
    fin = torch.isfinite(want)
    assert ((got[fin] - want[fin]).abs().double() <= rtol * scale[fin]).all()


def _with_non_finite_rows(q, c):
    """+-inf and NaN in a few query and candidate rows, at the first, the
    last and a middle feature."""
    m, d = q.shape
    n = c.shape[0]
    q[m // 2, d // 2] = np.inf
    q[m - 1, 0] = np.nan
    c[0, d - 1] = -np.inf
    c[n // 3, d // 2] = np.inf
    c[n - 1, 0] = np.nan
    return q, c


# M on both sides of the 64-row warpgroup halves and of one 128-row tile;
# N odd and N = 2 mod 4 (output rows that start 4-byte or 8-byte aligned);
# D unaligned (4-byte copies), padded to 8, one and two K blocks
@pytest.mark.parametrize("m,n,d,non_finite", [
    (1, 1, 1, False), (77, 301, 37, False), (130, 257, 200, False),
    (63, 1023, 100, False), (65, 1026, 128, False), (1024, 515, 129, False),
    (1, 4098, 256, False), (1024, 2050, 100, False), (64, 130, 1, False),
    (65, 301, 37, True), (63, 1026, 128, True), (130, 515, 200, True),
])
def test_distance_and_norm_kernels_match_plain_at_ragged_shapes(cuda, m, n, d, non_finite):
    rng = np.random.default_rng(m + n + d)
    q = rng.normal(size=(m, d)).astype(np.float32)
    c = rng.normal(size=(n, d)).astype(np.float32)
    if non_finite:
        q, c = _with_non_finite_rows(q, c)
    q, c = torch.as_tensor(q, device=cuda), torch.as_tensor(c, device=cuda)
    before = nvcc.launch_counts().get("distance", 0)
    for mode in MODES:
        got, want = distance_cuda(q, c, mode=mode), distance_plain(q, c, mode)
        assert got.shape == (m, n)
        _assert_scores_close(got, want, _score_scale(q, c, mode))
    assert nvcc.launch_counts()["distance"] == before + len(MODES)
    got, want = norms_cuda(c), norms_plain(c)
    assert got.shape == (1, n)
    _assert_scores_close(got, want, want.abs().double())


# the kernel's arithmetic is distance_3xtf32's: both sum the same exact
# products of the TF32 split in f32, in different orders, so they differ
# only by f32 accumulation-order error, measured under 1e-6 of the scale
# at these sizes and held to 2e-6 (a fifth of the 1e-5 gate; a single
# TF32 pass misses by ~1e-4)
@pytest.mark.parametrize("m,n,d", [(128, 1000, 128), (200, 999, 100), (65, 514, 200)])
def test_distance_kernel_matches_3xtf32_model(cuda, m, n, d):
    rng = np.random.default_rng(7 * d)
    centres = rng.normal(size=(6, d))
    q = (centres[rng.integers(0, 6, m)] + 0.35 * rng.normal(size=(m, d))).astype(np.float32)
    c = (centres[rng.integers(0, 6, n)] + 0.35 * rng.normal(size=(n, d))).astype(np.float32)
    q, c = torch.as_tensor(q, device=cuda), torch.as_tensor(c, device=cuda)
    for mode in MODES:
        before = nvcc.launch_counts().get("distance", 0)
        got = distance_cuda(q, c, mode=mode)
        assert nvcc.launch_counts()["distance"] == before + 1
        model = distance_3xtf32(q, c, mode)
        _assert_scores_close(got, model, _score_scale(q, c, mode), rtol=2e-6)


# ---------------------------------------------------------------------------
# the norm kernel's two variants: warp a row and short-wide
# ---------------------------------------------------------------------------

NORM_ROWS = (1, 7, 16, 256, 8449)
NORM_DIMS = (1, 3, 127, 128, 129, 4096, 4097, 7168, 8192)


def _norm_table(cuda, n, d, offset=0):
    """A seeded N(0, 1) (n, d) table with -inf, +inf and NaN where
    ``_with_non_finite_rows`` puts them in a candidate table, starting
    ``offset`` floats into its buffer (1: rows not 16-byte aligned)."""
    g = torch.Generator(device=cuda).manual_seed(10007 * n + d)
    c = torch.randn(n * d + offset, generator=g, device=cuda)[offset:].view(n, d)
    c[0, d - 1] = -np.inf
    c[n // 3, d // 2] = np.inf
    c[n - 1, 0] = np.nan
    return c


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("d", NORM_DIMS)
@pytest.mark.parametrize("n", NORM_ROWS)
def test_norm_variants_bit_equal_and_match_plain(cuda, n, d, offset):
    """Both variants through the C entry point: the same bits (every row,
    the non-finite ones too; float4 and scalar loads in the short-wide
    one), each within 1e-5 |c|^2 of ``norms_plain``."""
    c = _norm_table(cuda, n, d, offset)
    lib = nvcc.library()
    stream = torch.cuda.current_stream().cuda_stream
    outs = []
    for variant in (NORM_WARP_ROW, NORM_SHORT_WIDE):
        out = torch.empty((1, n), dtype=torch.float32, device=cuda)
        assert lib.rayflex_norm(c.data_ptr(), out.data_ptr(), n, d, variant, stream) == 0
        outs.append(out)
    torch.cuda.synchronize()
    assert _bits_equal(outs[0], outs[1])
    want = norms_plain(c)
    for out in outs:
        _assert_scores_close(out, want, want.abs().double())


@pytest.mark.parametrize("n,d", [(16, 4096), (16, 8192), (256, 7168), (16, 128),
                                 (2047, 129), (2048, 129), (18_493, 100)])
def test_norms_cuda_launches_norm_variant(cuda, n, d):
    """The wrapper launches the kernel of ``norm_variant(n, d)``, as the
    profiler names it, once and counted, on both sides of the rule's row
    and width boundaries; its output is bit-equal to the other variant's."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    c = _norm_table(cuda, n, d)
    norms_cuda(c)
    torch.cuda.synchronize()
    before = nvcc.launch_counts().get("norm", 0)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        got = norms_cuda(c)
        torch.cuda.synchronize()
    assert nvcc.launch_counts()["norm"] == before + 1
    names = [e.key for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    want = {NORM_WARP_ROW: "norm_kernel", NORM_SHORT_WIDE: "norm_wide_kernel"}
    assert len(names) == 1 and want[norm_variant(n, d)] in names[0], names
    other = torch.empty_like(got)
    assert nvcc.library().rayflex_norm(c.data_ptr(), other.data_ptr(), n, d,
                                       1 - norm_variant(n, d),
                                       torch.cuda.current_stream().cuda_stream) == 0
    torch.cuda.synchronize()
    assert _bits_equal(got, other)


def test_norm_entry_point_refuses_what_it_cannot_take(cuda):
    """An unknown variant, d < 1, and a short-wide row whose block sums
    would not fit 48 KB of shared memory: cudaErrorInvalidValue (1)."""
    c = torch.zeros((2, 8), device=cuda)
    out = torch.empty((1, 2), device=cuda)
    call = nvcc.library().rayflex_norm
    stream = torch.cuda.current_stream().cuda_stream
    assert call(c.data_ptr(), out.data_ptr(), 2, 8, 2, stream) == 1
    assert call(c.data_ptr(), out.data_ptr(), 2, 0, 0, stream) == 1
    wide = (NORM_WIDE_MAX_BLOCKS + 1) * K_BLOCK
    assert call(c.data_ptr(), out.data_ptr(), 2, wide, NORM_SHORT_WIDE, stream) == 1
    assert call(c.data_ptr(), out.data_ptr(), 0, 8, 1, stream) == 0


def _cloud(cuda, n=6000, seed=3):
    rng = np.random.default_rng(seed)
    centres = rng.uniform(-4, 4, (40, 3))
    pts = (np.repeat(centres, n // 40, axis=0)
           + rng.normal(scale=0.06, size=(n, 3))).astype(np.float32)
    return pts, PointCloudScene.from_points(pts, device=cuda)


@pytest.mark.parametrize("k", [1, 16, 32, 33, 64, 65, 200])
def test_neighbor_kernel_bit_equal_to_plain(cuda, k):
    pts, cloud = _cloud(cuda)
    queries = np.concatenate([pts[:1500], pts[:1000] + 0.01]).astype(np.float32)
    packed = pack_point_bvh(cloud.bvh)
    sq = point_sq_norms(cloud.points)
    for mode, radius in (("nearest", None), ("within", 0.05), ("nearest", 0.1)):
        rays = point_queries(queries, radius, device=cuda)
        before = nvcc.launch_counts().get("neighbor", 0)
        got = neighbor_packed(packed, rays, cloud.depth, k, mode=mode)
        want = neighbor_wavefront(cloud.bvh, sq, rays, cloud.depth, k, mode)
        assert nvcc.launch_counts()["neighbor"] == before + 1
        for f in want._fields:
            assert _bits_equal(getattr(got, f), getattr(want, f)), (mode, f)


def test_neighbor_kernel_in_any_query_order(cuda):
    """Queries in a seeded random order, served in the kernel's Z-order
    schedule and in the caller's: the same record."""
    pts, cloud = _cloud(cuda)
    rng = np.random.default_rng(11)
    queries = (pts[rng.permutation(pts.shape[0])[:3000]]
               + rng.normal(scale=0.02, size=(3000, 3))).astype(np.float32)
    packed = pack_point_bvh(cloud.bvh)
    rays = point_queries(queries, None, device=cuda)
    want = neighbor_wavefront(cloud.bvh, point_sq_norms(cloud.points), rays, cloud.depth,
                              16, "nearest")
    got = neighbor_packed(packed, rays, cloud.depth, 16, mode="nearest")
    caller = neighbor_launch(packed, pack_rays(rays, -(-3000 // LANES) * LANES), None, 3000,
                             cloud.depth, 16, mode="nearest")
    for rec in (got, caller):
        for f in want._fields:
            assert _bits_equal(getattr(rec, f), getattr(want, f)), f


def test_engine_nearest_beyond_64_runs_the_kernel(cuda):
    pts, cloud = _cloud(cuda)
    eng = cloud.engine()
    assert cloud.size >= eng.AUTO_TREE_MIN_POINTS
    assert eng.resolve_neighbor_backend("nearest", "euclidean", k=65) == "tree_cuda"
    q = torch.as_tensor(pts[::4], device=cuda)
    nvcc.reset_launches()
    got = eng.nearest(q, 65)
    assert nvcc.launch_counts().get("neighbor", 0) >= 1
    want = eng.neighbor_search(q, 65, mode="nearest", backend="tree_wavefront")
    assert torch.equal(got.indices, want.index)
    assert _bits_equal(got.scores, want.dist_sq)
    assert torch.equal(got.valid, want.valid)


def test_engine_kernel_backends_match_plain_backends(cuda):
    rng = np.random.default_rng(7)
    db = rng.normal(size=(3000, 100)).astype(np.float32)
    q = torch.as_tensor(rng.normal(size=(300, 100)).astype(np.float32), device=cuda)
    index = VectorIndex.from_database(db, device=cuda)
    eng = index.engine(chunk_size=128)
    assert eng.resolve_distance_backend() == "cuda"
    nvcc.reset_launches()
    for metric in ("euclidean", "angular", "cosine"):
        oracle = eng.scores(q, metric, backend="mxu")
        got = eng.nearest(q, 10, metric)
        want = eng.nearest(q, 10, metric, backend="mxu")
        picked = torch.gather(oracle, 1, got.indices.long())
        scale = 1e-5 * (_score_scale(q, index.database, metric).max()
                        if metric != "cosine" else 1.0)
        assert ((picked - want.scores).abs() <= scale).all(), metric
    assert nvcc.launch_counts()["distance"] >= 3 * 3  # three chunks per metric

    pts, cloud = _cloud(cuda)
    ceng = cloud.engine(chunk_size=2048)
    qp = torch.as_tensor(pts[::3] + 0.01, device=cuda)
    assert ceng.resolve_neighbor_backend("nearest", "euclidean", k=16) == "tree_cuda"
    nvcc.reset_launches()
    for kind in ("nearest", "within"):
        radius = None if kind == "nearest" else 0.05
        got = ceng.neighbor_search(qp, 16, radius, mode=kind)
        want = ceng.neighbor_search(qp, 16, radius, mode=kind, backend="tree_wavefront")
        for f in want._fields:
            assert _bits_equal(getattr(got, f), getattr(want, f)), (kind, f)
    assert nvcc.launch_counts()["neighbor"] == 2 * 1  # 2000 queries: one chunk
    counts = ceng.count_within(qp, 0.05)
    assert torch.equal(counts, ceng.count_within(qp, 0.05, backend="tree_wavefront"))


def _animated_soup(seed, n_clusters=40, per=100, frames=3):
    """A clustered soup and its frames of rigid per-cluster motion."""
    rng = np.random.default_rng(seed)
    centres = rng.uniform(-4, 4, (n_clusters, 1, 3))
    tris = (np.repeat(centres, per, axis=0)
            + rng.normal(scale=0.06, size=(n_clusters * per, 3, 3))).astype(np.float32)
    vel = np.repeat(rng.normal(scale=0.1, size=(n_clusters, 1, 3)), per, axis=0)
    return tris, [(tris + f * vel).astype(np.float32) for f in range(1, frames + 1)]


def test_refit_then_cuda_trace_bit_equal_to_wavefront(cuda):
    tris, frames = _animated_soup(11)
    scene = Scene.from_triangles(tris, device=cuda)
    engine = scene.engine()
    assert engine.resolve_trace_backend() == "cuda"
    rng = np.random.default_rng(12)
    org = rng.uniform(-6, 6, (3000, 3)).astype(np.float32)
    rays = make_ray(org, (tris.mean(1)[rng.integers(0, len(tris), 3000)] - org), device=cuda)
    for moved in frames:
        scene.refit(moved)
        nvcc.reset_launches()
        for ray_type in RAY_TYPES:
            got = engine.trace(rays, ray_type)
            want = trace_wavefront(scene.bvh, rays, scene.depth, ray_type=ray_type)
            for f in want._fields:
                assert _bits_equal(getattr(got, f), getattr(want, f)), (ray_type, f)
        assert nvcc.launch_counts()["traverse"] == len(RAY_TYPES)
        shadow = trace_wavefront(scene.bvh, rays, scene.depth, ray_type="shadow")
        assert torch.equal(engine.occluded(rays), shadow.hit)


def test_refit_repacks_exactly_once_per_version(cuda, monkeypatch):
    from repro_torch.kernels import traverse
    tris, frames = _animated_soup(13)
    scene = Scene.from_triangles(tris, device=cuda)
    engine = scene.engine(chunk_size=1024)
    rays = make_ray(np.zeros((3000, 3), np.float32) + [0, 0, -9],
                    np.random.default_rng(14).normal(size=(3000, 3)) * [1, 1, 0] + [0, 0, 1],
                    device=cuda)
    packs = []
    real = traverse.pack_bvh
    monkeypatch.setattr(traverse, "pack_bvh", lambda *a: packs.append(1) or real(*a))
    for f, moved in enumerate([tris] + frames):
        if f:
            scene.refit(moved)
        for _ in range(2):  # three chunks each, twice
            engine.trace(rays)
        assert len(packs) == engine.prepares == f + 1
    info = engine.cache_info()
    assert (info.misses, info.entries) == (2, 2)  # the trace key and the prepare key


def test_cloud_refit_then_tree_cuda_bit_equal_to_tree_wavefront(cuda):
    pts, cloud = _cloud(cuda)
    eng = cloud.engine()
    rng = np.random.default_rng(15)
    for step in range(2):
        pts = (pts + rng.normal(scale=0.005, size=pts.shape)).astype(np.float32)
        cloud.refit(pts)
        assert torch.equal(cloud.points, torch.as_tensor(pts, device=cuda))
        want_sq = norms_plain(cloud.index.database)[0]
        _assert_scores_close(cloud.index.sq_norms, want_sq, want_sq.abs().double())
        q = torch.as_tensor(pts[::3], device=cuda)
        nvcc.reset_launches()
        for kind, radius in (("nearest", None), ("within", 0.05)):
            got = eng.neighbor_search(q, 16, radius, mode=kind)
            want = eng.neighbor_search(q, 16, radius, mode=kind, backend="tree_wavefront")
            for f in want._fields:
                assert _bits_equal(getattr(got, f), getattr(want, f)), (step, kind, f)
            if kind == "nearest":  # auto routes nearest to the same kernel
                assert torch.equal(eng.nearest(q, 16).indices, got.index)
        assert nvcc.launch_counts()["neighbor"] == 3


def _stream_operands(rng, ops, reset_p=0.3):
    """Packed (48, T*128) operands for per-beat opcodes ``ops``: normal
    values; k rows of {0, 1, 2, 0.5} and sign rows of {0, 1}; live-lane
    counts 0..16; per-lane resets that differ within a beat; NaN, +-inf
    and -0.0 in the dead lanes of vector beats."""
    t = len(ops)
    n = t * LANES
    x = rng.normal(size=(48, n)).astype(np.float32)
    op = np.repeat(np.asarray(ops), LANES)
    x[ROW_K:ROW_K + 3] = rng.choice(np.float32([0, 1, 2, 0.5]), size=(3, n))
    x[ROW_K:ROW_K + 3, op == 1] = rng.integers(0, 2, (3, int((op == 1).sum())))
    count = rng.integers(0, 17, n)
    x[ROW_MASK] = count
    x[ROW_RESET] = rng.random(n) < reset_p
    dead = (np.arange(32)[:, None] % 16 >= count[None]) & (op >= 2)
    junk = rng.choice(np.float32([np.nan, np.inf, -np.inf, -0.0]), size=(32, n))
    rows = x[ROW_VEC_A:ROW_VEC_A + 32]
    rows[dead] = junk[dead]
    return (torch.as_tensor(np.asarray(ops, np.int32), device="cuda"),
            torch.as_tensor(x, device="cuda"))


def _unified_bit_equal(opcodes, operands):
    before = nvcc.launch_counts().get("unified", 0)
    got = unified(opcodes, operands)
    assert nvcc.launch_counts()["unified"] == before + 1
    want = unified_plain(opcodes, operands)
    torch.cuda.synchronize()
    assert got.shape == want.shape == (16, operands.shape[1])
    bad = (got.view(torch.int32) != want.view(torch.int32)).any(1)
    assert not bool(bad.any()), f"rows {torch.nonzero(bad).flatten().tolist()} differ"
    return got


@pytest.mark.parametrize("t", [1, 3, 37])
def test_unified_kernel_bit_equal_to_plain(cuda, t):
    rng = np.random.default_rng(t)
    ops = rng.integers(0, 4, size=t)
    if t >= 4:
        ops[:4] = rng.permutation(4)
    _unified_bit_equal(*_stream_operands(rng, ops))


def test_unified_kernel_no_reset_stream(cuda):
    """All-euclidean beats and no reset: 128 chains as long as the stream,
    longer than a walk's look-ahead many times over."""
    rng = np.random.default_rng(11)
    opcodes, operands = _stream_operands(rng, np.full(300, 2), reset_p=0.0)
    got = _unified_bit_equal(opcodes, operands)
    assert bool((got[0].view(300, LANES).diff(dim=0) >= 0).all())  # sums of squares


def test_unified_kernel_signed_zero(cuda):
    """q = -1, c = +0 on 8 live lanes gives a -0.0 dot partial; the first
    angular beat and a reset beat both add +0.0 and give +0.0."""
    ops = np.asarray([3, 1, 3, 3], np.int32)
    opcodes, operands = _stream_operands(np.random.default_rng(2), ops)
    cols = torch.cat([torch.arange(LANES) + b * LANES for b in (0, 2, 3)]).cuda()
    operands[ROW_VEC_A:ROW_VEC_A + 8, cols] = -1.0
    operands[ROW_VEC_A + 16:ROW_VEC_A + 24, cols] = 0.0
    operands[ROW_MASK, cols] = 8.0
    operands[ROW_RESET, cols] = 0.0
    operands[ROW_RESET, 3 * LANES:] = 1.0
    got = _unified_bit_equal(opcodes, operands)
    dots = got[0, cols].view(3, LANES)
    assert bool((dots.view(torch.int32) == 0).all())  # +0.0, not -0.0


# ---------------------------------------------------------------------------
# the datapath config twins: arity 8, bf16 node rows, any stack size
# ---------------------------------------------------------------------------

TWIN_STACKS = [1, 2, 16, 64, 65, 200]


def _twin_scene(cuda, tag, stack, builder="lbvh"):
    from repro_torch.convert import config_from_tag
    from repro_torch.core.build.quality import clustered_soup

    config = config_from_tag(tag)._replace(stack_size=stack)
    tri = clustered_soup(np.random.default_rng(21), 64, 64, device=cuda)
    sc = Scene.from_triangles(tri, builder=builder, config=config, device=cuda)
    rng = np.random.default_rng(22)
    aim = tri.a[torch.as_tensor(rng.integers(0, 4096, 3000), device=cuda)]
    org = torch.as_tensor(rng.uniform(-9, 9, (3000, 3)).astype(np.float32), device=cuda)
    rays = make_ray(org, aim - org, device=cuda)
    return sc, rays


@pytest.mark.parametrize("stack", TWIN_STACKS)
@pytest.mark.parametrize("tag,builder", [("bvh8_s64_fp32_fp32", "lbvh"),
                                         ("bvh4_s64_bf16_fp32", "sah"),
                                         ("bvh8_s64_bf16_compressed", "sah")])
def test_fused_kernel_under_config_bit_equal_to_wavefront(cuda, tag, builder, stack):
    sc, rays = _twin_scene(cuda, tag, stack, builder)
    packed = pack_bvh(sc.bvh, sc.config)
    assert packed.kids.dtype == sc.config.packed_box_dtype
    before = nvcc.launch_counts().get("traverse", 0)
    overflowed = False
    for ray_type in RAY_TYPES:
        want = trace_wavefront(sc.bvh, rays, sc.depth, ray_type=ray_type, config=sc.config)
        got = traverse_packed(packed, rays, sc.depth, ray_type=ray_type, config=sc.config)
        for f in want._fields:
            assert _bits_equal(getattr(got, f), getattr(want, f)), f"{ray_type}: {f}"
        overflowed |= bool(want.stack_overflow.any())
    # the kernel ran every trace (the plain version counts no launch)
    assert nvcc.launch_counts()["traverse"] == before + len(RAY_TYPES)
    if stack <= 2:
        assert overflowed
    if stack >= 64:  # a BVH8 of depth 4 needs at most 22 slots
        assert not overflowed
    eng = sc.engine(chunk_size=1024)
    closest = trace_wavefront(sc.bvh, rays, sc.depth, config=sc.config)
    got = eng.trace(rays, backend="cuda")
    for f in closest._fields:
        assert _bits_equal(getattr(got, f), getattr(closest, f)), f


@pytest.mark.parametrize("stack", [1, 64, 65, 200, 1000])
def test_traverse_entry_point_takes_every_stack_size(cuda, stack):
    """``rayflex_traverse`` accepts every stack_size >= 1.  Above 64 the
    stack lives in device scratch: the C entry point refuses such a stack
    without scratch (so the local-array variant never serves it), and the
    wrapper supplies it."""
    import ctypes
    sc, rays = _twin_scene(cuda, "bvh4_s64_fp32_fp32", stack)
    packed = pack_bvh(sc.bvh, sc.config)
    n = rays.origin.shape[0]
    ray_op = pack_rays(rays, -(-n // LANES) * LANES)
    outs = [torch.empty(n, dtype=dt, device=cuda)
            for dt in (torch.float32, torch.int32, torch.int32, torch.int32, torch.int32)]
    lib = nvcc.library()
    stream = torch.cuda.current_stream().cuda_stream

    def call(scratch):
        return lib.rayflex_traverse(
            ray_op.data_ptr(), ray_op.shape[1], n, packed.kids.data_ptr(),
            packed.slots.data_ptr(), (4**(sc.depth - 1) - 1) // 3, (4**sc.depth - 1) // 3,
            0, ctypes.c_float(0.0), stack, 4, 0, scratch, *(o.data_ptr() for o in outs),
            stream)

    scratch = torch.empty((stack, n), dtype=torch.int32, device=cuda)
    assert call(scratch.data_ptr()) == 0
    assert call(None) == (0 if stack <= 64 else 1)  # 1: cudaErrorInvalidValue
    torch.cuda.synchronize()
    want = trace_wavefront(sc.bvh, rays, sc.depth, config=sc.config)
    got = traverse_packed(packed, rays, sc.depth, config=sc.config)
    for f in want._fields:
        assert _bits_equal(getattr(got, f), getattr(want, f)), f


@pytest.mark.parametrize("stack", [2, 100])
@pytest.mark.parametrize("tag", ["bvh4_s64_fp32_fp32", "bvh4_s64_bf16_compressed",
                                 "bvh8_s64_fp32_fp32", "bvh8_s64_bf16_fp32"])
def test_traverse_kernel_every_variant_in_any_order(cuda, tag, stack):
    """Each of the kernel's 8 variants (arity x node-box type x stack home)
    bit-equal to ``trace_wavefront`` on every field, on the batch as made
    and on the batch in a random order, for every ray type, with ``t_min``
    and ``max_rounds``; the 2-slot stack overflows."""
    sc, rays = _twin_scene(cuda, tag, stack)
    packed = pack_bvh(sc.bvh, sc.config)
    n = rays.origin.shape[0]
    shuffled = torch.randperm(n, generator=torch.Generator().manual_seed(23)).to(cuda)
    batches = (rays, type(rays)(*(x[shuffled] for x in rays)))
    before = nvcc.launch_counts().get("traverse", 0)
    overflowed = False
    cases = (("closest", {}), ("any", {}), ("shadow", {}), ("closest", {"t_min": 2.0}),
             ("closest", {"max_rounds": 5}), ("any", {"t_min": 1.0, "max_rounds": 7}))
    for ray_type, kw in cases:
        for batch in batches:
            want = trace_wavefront(sc.bvh, batch, sc.depth, ray_type=ray_type,
                                   config=sc.config, **kw)
            got = traverse_packed(packed, batch, sc.depth, ray_type=ray_type,
                                  config=sc.config, **kw)
            for f in want._fields:
                assert _bits_equal(getattr(got, f), getattr(want, f)), (ray_type, kw, f)
            overflowed |= bool(want.stack_overflow.any())
    assert overflowed == (stack == 2)
    assert nvcc.launch_counts()["traverse"] == before + len(cases) * len(batches)


# ---------------------------------------------------------------------------
# the MoE router (OpAngular over the expert table) and dispatch on the card
# ---------------------------------------------------------------------------


def _router_inputs(cuda, n, e, d, seed):
    g = torch.Generator(device=cuda).manual_seed(seed)
    x = torch.randn((n, d), generator=g, device=cuda)
    w = torch.randn((e, d), generator=g, device=cuda) / d ** 0.5
    return x, w


@pytest.mark.parametrize("metric", ["angular", "cosine"])
def test_router_scores_run_the_norm_kernel(cuda, metric):
    """Phi-3.5-MoE's router shape, (16, 4096): one norm-kernel launch per
    call, its norms within 1e-5 |c|^2 of ``norms_plain``, the scores within
    1e-5 |q||c| (dots) or 1e-5 (cosines) of the CPU path's."""
    from repro_torch.models import MoEConfig
    from repro_torch.models.moe import router_scores
    m = MoEConfig(num_experts=16, top_k=2, d_ff_expert=6400, router_metric=metric)
    x, w = _router_inputs(cuda, 512, 16, 4096, 11)
    before = nvcc.launch_counts().get("norm", 0)
    got = router_scores(m, x, w)
    assert nvcc.launch_counts()["norm"] == before + 1
    norms = norms_cuda(w)
    want_norms = norms_plain(w)
    assert bool(((norms - want_norms).abs() <= 1e-5 * want_norms).all())
    want = router_scores(m, x.cpu(), w.cpu())
    scale = (x.cpu().norm(dim=1)[:, None] * w.cpu().norm(dim=1)[None, :]
             if metric == "angular" else 1.0)
    assert bool(((got.cpu() - want).abs() <= 1e-5 * scale).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_local_on_the_card_matches_the_cpu(cuda, dtype):
    """Capacity dispatch with drops (capacity 64 for 512 tokens x top-2 over
    16 experts): tables and drops equal on the card and the CPU; the
    outputs within the compute dtype's rounding (f32: 1e-4 of the largest
    output, summation order; bf16: 2^-6 of it)."""
    from repro_torch.models import ModelConfig, MoEConfig
    from repro_torch.models.layers import exact_products
    from repro_torch.models.moe import _capacity, moe_dispatch, moe_init, moe_local, router_topk
    cfg = ModelConfig(name="t", family="moe", num_layers=1, d_model=256, num_heads=2,
                      num_kv_heads=2, d_ff=64, vocab_size=64, moe_pattern=(True,),
                      moe=MoEConfig(num_experts=16, top_k=2, d_ff_expert=128,
                                    capacity_factor=1.0))
    p = moe_init(torch.Generator().manual_seed(12), cfg)
    x, _ = _router_inputs(torch.device("cpu"), 512, 16, 256, 12)
    with torch.no_grad():
        w, idx, _ = router_topk(cfg.moe, x @ p["router"].T)
        cap = _capacity(cfg.moe, 512)
        table, gather_w, src = moe_dispatch(512, w, idx, 16, 0, cap)
        ctable, cgather_w, csrc = moe_dispatch(512, w.to(cuda), idx.to(cuda), 16, 0, cap)
        assert int((src == 16 * cap).sum()) > 0
        assert torch.equal(ctable.cpu(), table) and torch.equal(csrc.cpu(), src)
        assert torch.equal(cgather_w.cpu(), gather_w)
        want = moe_local(cfg, x.to(dtype), w, idx, p["wi"], p["wg"], p["wo"], 0, cap)
        pc = {k: v.to(cuda) for k, v in p.items()}
        with exact_products():
            got = moe_local(cfg, x.to(cuda, dtype), w.to(cuda), idx.to(cuda), pc["wi"],
                            pc["wg"], pc["wo"], 0, cap)
    tol = (1e-4 if dtype == torch.float32 else 2**-6) * float(want.float().abs().max())
    assert float((got.cpu().float() - want.float()).abs().max()) <= tol
    assert bool((got[csrc.reshape(512, 2).eq(16 * cap).all(1)] == 0).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_combine_on_the_card_is_deterministic_and_equals_the_cpu(cuda, dtype):
    """The top-8 combine over 512 tokens and 64 experts of capacity 48,
    drops included: two runs on the card bit-equal, and bit-equal to the
    CPU's on the same gated expert outputs (one add a rank, in (expert,
    slot) order: no atomics)."""
    from repro_torch.models.moe import moe_combine, moe_dispatch
    n, k, e, cap, d = 512, 8, 64, 48, 256
    rng = np.random.default_rng(26)
    experts = torch.as_tensor(np.argsort(rng.normal(size=(n, e)), 1)[:, :k])
    weights = torch.as_tensor(rng.uniform(0.05, 1.0, (n, k)).astype(np.float32))
    _, _, src = moe_dispatch(n, weights, experts, e, 0, cap)
    assert int((src == e * cap).sum()) > 0
    flat = torch.as_tensor(rng.normal(size=(e * cap + 1, d)).astype(np.float32)).to(dtype)
    flat[-1] = 0
    want = moe_combine(flat, src, n, k)
    runs = [moe_combine(flat.to(cuda), src.to(cuda), n, k) for _ in range(2)]
    assert torch.equal(runs[0].view(torch.int16), runs[1].view(torch.int16))
    assert torch.equal(runs[0].cpu().view(torch.int16), want.view(torch.int16))


@pytest.mark.parametrize("absorb", [False, True])
def test_mla_smoke_model_on_the_card_matches_the_cpu(cuda, absorb):
    """DeepSeek-V3's smoke config (MLA, sigmoid routing, the MTP head's
    parameters) in float32 on the card and the CPU from the same weights:
    greedy tokens equal, every step's logits within 1e-4 (TF32 off, as
    ``tests/test_torch_lm_serving.py`` holds the CPU to the reference)."""
    import copy
    import dataclasses

    from repro_torch.configs import get_smoke
    from repro_torch.models import decode_step, init_cache, init_params, prefill
    from repro_torch.parallel import NO_PARALLEL
    from repro_torch.serving import Engine
    cfg = get_smoke("deepseek-v3-671b")
    cfg = dataclasses.replace(cfg, compute_dtype="float32",
                              mla=dataclasses.replace(cfg.mla, absorb=absorb))
    cpu_params = init_params(26, cfg, device="cpu")
    gpu_params = copy.deepcopy(cpu_params).to(cuda)
    toks = torch.as_tensor(np.random.default_rng(26).integers(0, cfg.vocab_size, (3, 12)),
                           dtype=torch.int32)
    want = Engine(cfg, cpu_params, max_len=24).generate(toks, 8)
    got = Engine(cfg, gpu_params, max_len=24).generate(toks.to(cuda), 8)
    assert torch.equal(got.cpu(), want)
    logits = []
    for params, dev in ((cpu_params, torch.device("cpu")), (gpu_params, cuda)):
        out, cache = prefill(cfg, NO_PARALLEL, params, {"tokens": toks.to(dev)},
                             init_cache(cfg, 3, 24, device=dev))
        steps = [out.cpu()]
        for i in range(8):
            out, cache = decode_step(cfg, NO_PARALLEL, params, cache, want[:, i:i + 1].to(dev))
            steps.append(out.cpu())
        logits.append(torch.cat(steps, 1))
    assert float((logits[1] - logits[0]).abs().max()) <= 1e-4


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mamba_apply_on_the_card_matches_the_cpu(cuda, dtype):
    """Jamba's smoke mixer over 37 steps (scan chunks of 8, the last
    padded) from nonzero conv and SSM states, on the card and the CPU from
    the same weights and inputs: the output and both new states within
    2e-5 (float32, TF32 off: summation order) or, in bf16, 2^-6 of the
    largest value (a bf16 product rounds its f32 sum, whose order differs)."""
    import dataclasses

    from repro_torch.configs import get_smoke
    from repro_torch.models import mamba as mam
    from repro_torch.models.layers import exact_products
    from repro_torch.parallel import NO_PARALLEL
    cfg = dataclasses.replace(get_smoke("jamba-1.5-large-398b"),
                              compute_dtype=str(dtype).split(".")[1])
    p = mam.mamba_init(torch.Generator().manual_seed(27), cfg)
    conv_s, ssm_s = mam.mamba_state_shapes(cfg, 3)
    rng = np.random.default_rng(27)
    x, conv, ssm = (torch.as_tensor(rng.normal(size=s).astype(np.float32))
                    for s in ((3, 37, cfg.d_model), conv_s, ssm_s))
    args = (x.to(dtype), conv.to(dtype), ssm)
    with torch.no_grad():
        want = mam.mamba_apply(cfg, NO_PARALLEL, p, args[0], ssm_state=args[2],
                               conv_state=args[1])
        pc = {k: v.to(cuda) for k, v in p.items()}
        with exact_products():
            got = mam.mamba_apply(cfg, NO_PARALLEL, pc, args[0].to(cuda),
                                  ssm_state=args[2].to(cuda), conv_state=args[1].to(cuda))
    for name, g, w in zip(("y", "conv state", "ssm state"), (got[0], *got[1]),
                          (want[0], *want[1]), strict=True):
        assert g.dtype == w.dtype, name
        g, w = g.cpu().float(), w.float()
        tol = 2e-5 * (1 + w.abs()) if dtype == torch.float32 else 2**-6 * w.abs().max()
        assert bool(((g - w).abs() <= tol).all()), name


def test_jamba_smoke_model_on_the_card_matches_the_cpu(cuda):
    """Jamba's smoke config (Mamba, attention at layer 4, MoE at the odd
    layers) in float32 on the card and the CPU from the same weights:
    greedy tokens equal, every step's logits within 1e-4 (TF32 off), and
    the norm kernel launched once per MoE layer per forward, nothing
    else."""
    import copy
    import dataclasses

    from repro_torch.configs import get_smoke
    from repro_torch.models import decode_step, init_cache, init_params, prefill
    from repro_torch.parallel import NO_PARALLEL
    from repro_torch.serving import Engine
    cfg = dataclasses.replace(get_smoke("jamba-1.5-large-398b"), compute_dtype="float32")
    n_moe = sum(spec.moe for spec in cfg.layer_specs())
    cpu_params = init_params(27, cfg, device="cpu")
    gpu_params = copy.deepcopy(cpu_params).to(cuda)
    toks = torch.as_tensor(np.random.default_rng(27).integers(0, cfg.vocab_size, (3, 20)),
                           dtype=torch.int32)
    want = Engine(cfg, cpu_params, max_len=32).generate(toks, 8)
    nvcc.reset_launches()
    got = Engine(cfg, gpu_params, max_len=32).generate(toks.to(cuda), 8)
    assert nvcc.launch_counts() == {"norm": n_moe * 9}
    assert torch.equal(got.cpu(), want)
    logits = []
    for params, dev in ((cpu_params, torch.device("cpu")), (gpu_params, cuda)):
        out, cache = prefill(cfg, NO_PARALLEL, params, {"tokens": toks.to(dev)},
                             init_cache(cfg, 3, 32, device=dev))
        steps = [out.cpu()]
        for i in range(8):
            out, cache = decode_step(cfg, NO_PARALLEL, params, cache, want[:, i:i + 1].to(dev))
            steps.append(out.cpu())
        logits.append(torch.cat(steps, 1))
    assert float((logits[1] - logits[0]).abs().max()) <= 1e-4


def test_check_cuda_holds_each_operand_to_the_launch_device(cuda):
    """On one card too: an operand is refused when the launch's device is
    another, and passes on its own device."""
    t = torch.zeros((2, 3), device=cuda)
    assert nvcc.check_cuda("t", t, torch.float32, (2, 3), t.device) == t.data_ptr()
    with pytest.raises(ValueError, match="one launch runs on one device"):
        nvcc.check_cuda("t", t, torch.float32, (2, 3), torch.device("cuda", t.device.index + 1))


def test_launches_run_on_the_operands_device(cuda):
    """Operands on ``cuda:1`` while ``cuda:0`` is current: the norm,
    distance and OpQuadbox kernels run on card 1 and give the bits they
    give on card 0, the current device is left as it was; operands on two
    devices are refused before any launch."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    one = torch.device("cuda:1")
    gen = torch.Generator(device=one).manual_seed(26)
    c = torch.randn((256, 7168), generator=gen, device=one)
    q = torch.randn((64, 128), generator=gen, device=one)
    db = torch.randn((300, 128), generator=gen, device=one)
    rng = np.random.default_rng(26)
    ray = _rays(rng, 257)
    lo = rng.uniform(-3, 2, (12, 257)).astype(np.float32)
    hi = (lo + rng.uniform(0, 3, (12, 257))).astype(np.float32)
    box = (ray.origin.T.contiguous(), ray.inv.T.contiguous(),
           torch.signbit(ray.direction).float().T.contiguous(),
           torch.as_tensor(lo, device=cuda), torch.as_tensor(hi, device=cuda))
    with torch.cuda.device(0):
        before = nvcc.launch_counts()
        got = {"norm": norms_cuda(c), "distance": distance_cuda(q, db),
               "raybox": raybox(*(x.to(one) for x in box))}
        assert torch.cuda.current_device() == 0
        counts = nvcc.launch_counts()
        for name in got:
            assert counts.get(name, 0) == before.get(name, 0) + 1
    torch.cuda.synchronize(one)
    want = {"norm": norms_cuda(c.to("cuda:0")),
            "distance": distance_cuda(q.to("cuda:0"), db.to("cuda:0")),
            "raybox": raybox(*(x.to("cuda:0") for x in box))}
    for name, out in got.items():
        outs = out if isinstance(out, tuple) else (out,)
        refs = want[name] if isinstance(want[name], tuple) else (want[name],)
        for a, b in zip(outs, refs, strict=True):
            assert a.device == one
            assert _bits_equal(a.cpu(), b.cpu()), name
    with pytest.raises(ValueError, match="one launch runs on one device"):
        distance_cuda(q, db.to("cuda:0"))
    with pytest.raises(ValueError, match="one launch runs on one device"):
        raybox(*(x.to(one) for x in box[:-1]), box[-1].to("cuda:0"))


# ---------------------------------------------------------------------------
# operands past 2^31 elements: the kernels' row offsets are 64-bit
# ---------------------------------------------------------------------------

#: a few rays or jobs, tiled across a launch whose operand rows start past
#: 2^31 elements: row 15 of a (16, n_pad) ray operand above 2^31 / 15
#: columns, row 11 of an OpQuadbox box operand above 2^31 / 11, row 2 of an
#: OpTriangle operand above 2^31 / 3
TILE = 128
HUGE_RAYS = 150_000_000
HUGE_BOX_JOBS = 196_000_000
HUGE_TRI_JOBS = 720_000_000


def _tiled(base: torch.Tensor, n: int) -> torch.Tensor:
    """(rows, TILE) -> (rows, n): column j holds column j % TILE."""
    out = torch.empty((base.shape[0], n), dtype=base.dtype, device=base.device)
    out.view(base.shape[0], n // TILE, TILE).copy_(base[:, None, :])
    return out


def _tiled_rows(base: torch.Tensor, n: int) -> torch.Tensor:
    """(TILE, ...) -> (n, ...): row i holds row i % TILE."""
    return base.repeat((n // TILE,) + (1,) * (base.ndim - 1))


def _columns_off(got: torch.Tensor, want: torch.Tensor) -> int:
    """How many of ``got``'s columns (its last axis, n = reps * TILE) differ
    in their bits from the tile ``want`` (the same rows, TILE columns)."""
    if got.dtype == torch.float32:
        got, want = got.view(torch.int32), want.view(torch.int32)
    rows = got.shape[0] if got.ndim == 2 else 1
    g = got.reshape(rows, -1, TILE)
    return int((g != want.reshape(rows, 1, TILE)).any(0).sum())


def _free_bytes() -> int:
    torch.cuda.empty_cache()
    return torch.cuda.mem_get_info()[0]


def _huge_trace_columns_off(cuda) -> int:
    rng = np.random.default_rng(31)
    tris = rng.normal(size=(40, 3, 3)).astype(np.float32)
    sc = Scene.from_triangles(tris, device=cuda)
    base = _rays(rng, TILE)
    rays = type(base)(*(_tiled_rows(x, HUGE_RAYS) for x in base))
    before = nvcc.launch_counts().get("traverse", 0)
    got = traverse_packed(pack_bvh(sc.bvh), rays, sc.depth)
    assert nvcc.launch_counts()["traverse"] == before + 1
    del rays
    want = trace_wavefront(sc.bvh, base, sc.depth)
    assert bool(want.hit.any()) and not bool(want.hit.all())
    return sum(_columns_off(getattr(got, f), getattr(want, f))
               for f in want._fields if f != "rounds")


def test_traverse_kernel_past_2_31_operand_elements(cuda):
    """1.5e8 copies of 128 rays (a 9.6 GB ray operand) through a 40-triangle
    tree in one launch: every column bit-equal to ``trace_wavefront`` of its
    ray."""
    if _free_bytes() < 30 * 2**30:
        pytest.skip("needs 30 GiB of free device memory")
    assert _huge_trace_columns_off(cuda) == 0


def _huge_neighbor_columns_off(cuda) -> int:
    pts, cloud = _cloud(cuda, n=2000)
    base = point_queries(pts[:TILE] + 0.01, 0.3, device=cuda)
    queries = type(base)(*(_tiled_rows(x, HUGE_RAYS) for x in base))
    got = neighbor_packed(pack_point_bvh(cloud.bvh), queries, cloud.depth, 4,
                          mode="within")
    del queries
    want = neighbor_wavefront(cloud.bvh, point_sq_norms(cloud.points), base,
                              cloud.depth, 4, "within")
    assert bool((want.count > 0).all())
    cols = lambda x: x.T if x.ndim == 2 else x  # noqa: E731  (rows, queries)
    return sum(_columns_off(cols(getattr(got, f)), cols(getattr(want, f)))
               for f in want._fields if f != "rounds")


def test_neighbor_kernel_past_2_31_operand_elements(cuda):
    """1.5e8 copies of 128 radius queries in one launch: every field of
    every query bit-equal to ``neighbor_wavefront``."""
    if _free_bytes() < 40 * 2**30:
        pytest.skip("needs 40 GiB of free device memory")
    assert _huge_neighbor_columns_off(cuda) == 0


def _huge_raybox_columns_off(cuda) -> int:
    rng = np.random.default_rng(32)
    ray = _rays(rng, TILE)
    lo = rng.uniform(-3, 2, (12, TILE)).astype(np.float32)
    hi = (lo + rng.uniform(0, 3, (12, TILE))).astype(np.float32)
    base = (ray.origin.T.contiguous(), ray.inv.T.contiguous(),
            torch.signbit(ray.direction).float().T.contiguous(),
            torch.as_tensor(lo, device=cuda), torch.as_tensor(hi, device=cuda))
    want = raybox_plain(*base)
    assert bool(want[2].any())
    got = raybox(*(_tiled(x, HUGE_BOX_JOBS) for x in base))
    return sum(_columns_off(g, w) for g, w in zip(got, want))


def test_raybox_kernel_past_2_31_operand_elements(cuda):
    """OpQuadbox on 1.96e8 jobs (35 GB of operands and outputs), one launch:
    every column bit-equal to the plain version's on its job."""
    if _free_bytes() < 40 * 2**30:
        pytest.skip("needs 40 GiB of free device memory")
    assert _huge_raybox_columns_off(cuda) == 0


def _huge_raytri_columns_off(cuda) -> int:
    rng = np.random.default_rng(33)
    ray = _rays(rng, TILE)
    verts = [torch.as_tensor(rng.normal(size=(3, TILE)).astype(np.float32), device=cuda)
             for _ in range(3)]
    k = torch.stack([ray.kx, ray.ky, ray.kz]).contiguous()
    base = (ray.origin.T.contiguous(), ray.shear.T.contiguous(), k, *verts)
    want = raytri_plain(*base)
    assert bool(want[2].any())
    got = raytri(*(_tiled(x, HUGE_TRI_JOBS) for x in base))
    return sum(_columns_off(g[None], w[None]) for g, w in zip(got, want))


def test_raytri_kernel_past_2_31_operand_elements(cuda):
    """OpTriangle on 7.2e8 jobs (61 GB of operands and outputs), one launch:
    every column bit-equal to the plain version's on its job.  Skips on a
    card without the room."""
    if _free_bytes() < 64 * 2**30:
        pytest.skip("needs 64 GiB of free device memory")
    assert _huge_raytri_columns_off(cuda) == 0
