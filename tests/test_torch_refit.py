"""The port's dynamic scenes held against the JAX reference.

``refit`` keeps the builder's leaf assignment and re-sweeps the boxes, so
it is compare/select and min/max over the moved vertices plus the
degenerate cull's cross product: every ``BVH4`` array is **bit-equal** to
``repro``'s eager ``refit`` / ``refit_points`` on the same inputs.  The
moved soups make triangles exactly degenerate (``b = c = a``), whose cross
product is 0 with or without an FMA, so the reference's jitted
``Scene.refit`` culls the same triangles.

After a refit, queries on the plain backends are held to the rules of
the port's other tests: trace ``t`` to the forward error bound
``_t_tolerance`` (``tests/test_torch_trace.py``), tree ``dist_sq`` to
``12 u (|q|^2 + |c|^2)`` and brute scores to ``1e-5 (|q|^2 + |c|^2)``
(``tests/test_torch_neighbor.py``, ``tests/test_torch_knn.py``); every
other field exact.  ``Scene.stats()``: integers exact, the SAH cost, the
mean jobs and the branching factor within 1e-6 relative (float sums in
another order).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import PointCloudScene as JCloud
from repro.api import Scene as JScene
from repro.core import Triangle as JTriangle
from repro.core import make_ray as jmake_ray
from repro.core.build import build as jbuild
from repro.core.build.points import build_point_bvh as jbuild_point_bvh
from repro.core.build.points import refit_points as jrefit_points
from repro.core.build.refit import refit as jrefit
from repro_torch.api import PointCloudScene, Scene, make_ray
from repro_torch.core.build import build, refit, refit_points, tree_stats
from repro_torch.core.build.points import build_point_bvh
from repro_torch.core.types import Triangle
from test_torch_models import one_torch_thread  # noqa: F401  (autouse fixture)
from test_torch_trace import _assert_record

BVH_FIELDS = ("node_lo", "node_hi", "leaf_tri", "leaf_perm")
U = 2.0 ** -24


def _bits(x) -> np.ndarray:
    x = np.asarray(x)
    return x.view(np.int32) if x.dtype == np.float32 else x.astype(np.int64)


def _assert_bvh_equal(got, want, what=""):
    for f in BVH_FIELDS:
        np.testing.assert_array_equal(_bits(getattr(got, f).numpy()),
                                      _bits(getattr(want, f)), err_msg=f"{what}: {f}")
    for v, (g, w) in enumerate(zip(got.triangles, want.triangles)):
        np.testing.assert_array_equal(_bits(g.numpy()), _bits(w),
                                      err_msg=f"{what}: vertex {v}")


def _soups(tris: np.ndarray):
    jt = JTriangle(*(jnp.asarray(tris[:, i]) for i in range(3)))
    tt = Triangle(*(torch.as_tensor(tris[:, i].copy()) for i in range(3)))
    return jt, tt


def _animated(seed: int, n: int = 60, frames: int = 3):
    """A soup and its moved frames.  Every 5th triangle is a point at build
    time and gets area back under motion; every 7th collapses to a point
    from frame 1 on; the rest drift rigidly by a per-triangle velocity."""
    rng = np.random.default_rng(seed)
    ctr = rng.uniform(-5, 5, (n, 1, 3))
    tris = (ctr + rng.normal(scale=0.5, size=(n, 3, 3))).astype(np.float32)
    born = np.arange(n) % 5 == 0
    base = tris.copy()
    tris[born] = tris[born, :1]
    vel = rng.normal(scale=0.4, size=(n, 1, 3))
    moved = []
    for f in range(1, frames + 1):
        m = (base + f * vel).astype(np.float32)
        dies = np.arange(n) % 7 == 3
        m[dies] = m[dies, :1]
        moved.append(m)
    return tris, moved


def _rays(seed: int, tris: np.ndarray, n: int = 96):
    rng = np.random.default_rng(seed)
    org = rng.uniform(-9, 9, (n, 3)).astype(np.float32)
    aim = tris.mean(axis=1)[rng.integers(0, tris.shape[0], n)]
    tgt = (aim + rng.normal(scale=0.3, size=(n, 3))).astype(np.float32)
    return org, (tgt - org).astype(np.float32)


# ---------------------------------------------------------------------------
# the refit arrays
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1])
def test_refit_bit_equal_to_reference_under_motion(seed):
    tris, frames = _animated(seed)
    jt, tt = _soups(tris)
    jb, tb = jbuild(jt, "lbvh").bvh, build(tt, "lbvh").bvh
    _assert_bvh_equal(tb, jb, "build")
    culled = set()
    for f, moved in enumerate(frames):
        jm, tm = _soups(moved)
        want, got = jrefit(jb, jm), refit(tb, tm)
        _assert_bvh_equal(got, want, f"frame {f + 1}")
        culled |= set(np.flatnonzero(got.leaf_perm.numpy() >= 0)) - set(
            np.flatnonzero(got.leaf_tri.numpy() >= 0))
    # the cull moved with the geometry: build-time points came back, others
    # collapsed and dropped out
    back = (tb.leaf_tri.numpy() < 0) & (got.leaf_tri.numpy() >= 0)
    gone = (tb.leaf_tri.numpy() >= 0) & (got.leaf_tri.numpy() < 0)
    assert back.any() and gone.any() and culled


@pytest.mark.parametrize("seed", [2, 3])
def test_refit_of_unchanged_triangles_equals_the_build(seed):
    tris, _ = _animated(seed)
    tt = _soups(tris)[1]
    built = build(tt, "lbvh").bvh
    again = refit(built, Triangle(*(v.clone() for v in tt)))
    for f in BVH_FIELDS:
        assert np.array_equal(_bits(getattr(again, f).numpy()),
                              _bits(getattr(built, f).numpy())), f
    scene = Scene.from_triangles(tris, device="cpu")
    before = [getattr(scene.bvh, f).clone() for f in BVH_FIELDS]
    assert scene.refit(tris) is scene and scene.version == 1
    for f, b in zip(BVH_FIELDS, before):
        assert np.array_equal(_bits(getattr(scene.bvh, f).numpy()), _bits(b.numpy())), f


def test_refit_rejects_another_soup():
    tris, frames = _animated(4)
    tb = build(_soups(tris)[1], "lbvh").bvh
    with pytest.raises(ValueError, match="refit needs"):
        refit(tb, _soups(frames[0][:-1])[1])
    scene = Scene.from_triangles(tris, device="cpu")
    with pytest.raises(ValueError, match="refit needs"):
        scene.refit(frames[0][:-1])
    bad = frames[0].copy()
    bad[3, 1, 2] = np.nan
    with pytest.raises(ValueError, match="finite"):
        scene.refit(bad)
    assert scene.version == 0


@pytest.mark.parametrize("seed", [0, 5])
def test_refit_points_bit_equal_to_reference(seed):
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(300, 3)).astype(np.float32)
    res, jres = build_point_bvh(torch.as_tensor(pts)), jbuild_point_bvh(jnp.asarray(pts))
    for step in range(2):
        pts = (pts + rng.normal(scale=0.2, size=pts.shape)).astype(np.float32)
        want = jrefit_points(jres.bvh, jnp.asarray(pts))
        got = refit_points(res.bvh, torch.as_tensor(pts))
        _assert_bvh_equal(got, want, f"step {step}")
    with pytest.raises(ValueError, match="refit_points needs"):
        refit_points(res.bvh, torch.as_tensor(pts[:-1]))


# ---------------------------------------------------------------------------
# queries after a refit
# ---------------------------------------------------------------------------


def test_scene_refit_then_trace_matches_reference():
    tris, frames = _animated(6, n=80)
    scene = Scene.from_triangles(tris, device="cpu")
    jscene = JScene.from_triangles(tris)
    engine, jengine = scene.engine(), jscene.engine()
    for moved in frames:
        scene.refit(moved)
        jscene.refit(moved)
        org, dirs = _rays(7, moved)
        rays = make_ray(org, dirs, device="cpu")
        jrays = jmake_ray(jnp.asarray(org), jnp.asarray(dirs))
        for ray_type in ("closest", "shadow"):
            want = jengine.trace(jrays, ray_type, backend="wavefront")
            want = type(want)(*(np.asarray(x) for x in want))
            backends = ("wavefront", "cuda", "per_ray") if ray_type == "closest" \
                else ("wavefront", "cuda")
            for backend in backends:
                got = engine.trace(rays, ray_type, backend=backend)
                _assert_record(type(got)(*(x.numpy() for x in got)), want,
                               f"{ray_type}/{backend}", moved, rays)
        assert scene.num_triangles == moved.shape[0]


def test_cloud_refit_then_nearest_and_within_match_reference():
    rng = np.random.default_rng(8)
    pts = rng.normal(size=(500, 3)).astype(np.float32)
    cloud = PointCloudScene.from_points(pts, device="cpu")
    jcloud = JCloud.from_points(pts)
    eng, jeng = cloud.engine(), jcloud.engine()
    q = rng.normal(size=(40, 3)).astype(np.float32)
    for step in range(2):
        pts = (pts + rng.normal(scale=0.1, size=pts.shape)).astype(np.float32)
        assert cloud.refit(pts) is cloud
        jcloud.refit(pts)
        assert cloud.version == step + 1 and cloud.root_volume() == jcloud.root_volume()
        p64, q64 = pts.astype(np.float64), q.astype(np.float64)
        for backend, rule in (("tree_wavefront", 12 * U), ("mxu", 1e-5)):
            for kind, args in (("nearest", (6,)), ("within", (0.5, 6))):
                got = getattr(eng, kind)(q, *args, backend=backend)
                want = getattr(jeng, kind)(jnp.asarray(q), *args, backend=backend)
                np.testing.assert_array_equal(got.indices.numpy(),
                                              np.asarray(want.indices),
                                              err_msg=f"{backend}/{kind}")
                np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
                idx = np.maximum(got.indices.numpy(), 0)
                scale = (q64 * q64).sum(1)[:, None] + (p64 * p64).sum(1)[idx]
                g, w = got.scores.numpy(), np.asarray(want.scores)
                fin = np.isfinite(w)
                np.testing.assert_array_equal(np.isfinite(g), fin)
                assert (np.abs(g[fin] - w[fin]) <= rule * scale[fin]).all(), \
                    f"{backend}/{kind}: scores outside {rule} (|q|^2 + |c|^2)"
            np.testing.assert_array_equal(
                eng.count_within(q, 0.5, backend=backend).numpy(),
                np.asarray(jeng.count_within(jnp.asarray(q), 0.5, backend=backend)))
        np.testing.assert_array_equal(cloud.points.numpy(), pts)
    with pytest.raises(ValueError, match="finite"):
        cloud.refit(np.full_like(pts, np.inf))


# ---------------------------------------------------------------------------
# tree quality
# ---------------------------------------------------------------------------

EXACT_STATS = ("builder", "n_triangles", "depth", "n_nodes", "n_leaves",
               "occupancy", "arity", "bytes_per_node", "compression_ratio")
CLOSE_STATS = ("sah_cost", "mean_quadbox_jobs", "mean_triangle_jobs", "mean_jobs",
               "mean_branching_factor")


def _assert_stats(got, want, what=""):
    assert got._fields == want._fields
    for f in EXACT_STATS:
        assert getattr(got, f) == getattr(want, f), f"{what}: {f}"
    for f in CLOSE_STATS:
        g, w = getattr(got, f), getattr(want, f)
        assert abs(g - w) <= 1e-6 * abs(w), f"{what}: {f} {g} vs {w}"


@pytest.mark.parametrize("probes", [64, 256])
def test_scene_stats_match_reference(probes):
    tris, frames = _animated(9, n=120)
    scene = Scene.from_triangles(tris, device="cpu")
    jscene = JScene.from_triangles(tris)
    _assert_stats(scene.stats(probes=probes), jscene.stats(probes=probes), "build")
    for f, moved in enumerate(frames):
        scene.refit(moved)
        jscene.refit(moved)
        _assert_stats(scene.stats(probes=probes), jscene.stats(probes=probes),
                      f"frame {f + 1}")
    org, dirs = _rays(10, frames[-1])
    got = scene.stats(rays=make_ray(org, dirs, device="cpu"))
    want = jscene.stats(rays=jmake_ray(jnp.asarray(org), jnp.asarray(dirs)))
    _assert_stats(got, want, "given rays")
    assert got == tree_stats(scene.bvh, "lbvh", rays=make_ray(org, dirs, device="cpu"))
    assert got.mean_jobs == got.mean_quadbox_jobs + got.mean_triangle_jobs
    assert got.bytes_per_node == 24 and got.compression_ratio == 1.0
