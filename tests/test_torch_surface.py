"""The rest of the port's trace surface held against the JAX reference:
the per-ray oracle, ``occluded``, ``plan_for`` / ``batch_multiple``, the
engine's cache of built run functions, and shard resolution.

The oracle is held like every trace engine of the port: ``tri_index``,
``hit``, the job counters, ``stack_overflow`` and ``rounds`` exact, ``t``
within the forward error bound ``_t_tolerance``
(``tests/test_torch_trace.py``; the reference's loop is compiled by XLA,
which may contract products into FMAs), and bit-equal to the port's own
wavefront engine.  Plans are integers and are held exactly, the port's
``cuda`` / ``tree_cuda`` lanes against the reference's ``pallas`` /
``tree_pallas`` ones.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import PointCloudScene as JCloud
from repro.api import QueryEngine as JQueryEngine
from repro.api import Scene as JScene
from repro.core import make_ray as jmake_ray
from repro.core.bvh import DatapathConfig as JDatapathConfig
from repro.core.traversal import trace_rays as jtrace_rays
from repro_torch.api import (CacheInfo, PointCloudScene, QueryEngine, Scene, TraceResult,
                             make_ray)
from repro_torch.core import HitRecord, occlusion_test, trace_ray, trace_rays
from repro_torch.core.bvh import DatapathConfig
from repro_torch.core.dispatch import available_devices, resolve_shards
from repro_torch.core.wavefront import trace_wavefront
from test_torch_trace import _assert_record, _assert_same, _carried, _random_scene


def _np(rec):
    return type(rec)(*[np.asarray(x) for x in rec])


# ---------------------------------------------------------------------------
# the per-ray oracle
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("stack_size", [64, 2])
@pytest.mark.parametrize("seed", [0, 1])
def test_trace_rays_matches_reference(seed, stack_size):
    tris, org, dirs, ext = _random_scene(seed, n_rays=96)
    res, jr, tb, tr = _carried(tris, org, dirs, ext)
    got = trace_rays(tb, tr, res.depth, DatapathConfig(stack_size=stack_size))
    want = jtrace_rays(res.bvh, jr, res.depth, JDatapathConfig(stack_size=stack_size))
    assert isinstance(got, HitRecord) and got._fields == want._fields
    rounds = lambda rec: rec.quadbox_jobs.max()  # noqa: E731
    _assert_record(_np(TraceResult(*got, rounds(got))),
                   _np(TraceResult(*want, rounds(want))),
                   f"trace_rays stack {stack_size}", tris, tr)
    assert int(got.hit.sum()) > 10
    # the overflow case: a depth-3 tree needs up to 7 slots
    assert bool(got.stack_overflow.any()) == (stack_size == 2)
    if stack_size == 64:  # the oracle and the batch engine, bit for bit
        _assert_same(TraceResult(*got, rounds(got)),
                     trace_wavefront(tb, tr, res.depth))
    one = trace_ray(tb, type(tr)(*(f[5] for f in tr)), res.depth)
    _assert_same(one, HitRecord(*(f[5] for f in trace_rays(tb, tr, res.depth))))


def test_per_ray_backend_matches_reference_and_wavefront():
    tris, org, dirs, ext = _random_scene(2, n_rays=70)
    scene = Scene.from_triangles(tris, device="cpu")
    engine = scene.engine(chunk_size=32)
    rays = make_ray(org, dirs, ext, device="cpu")
    got = engine.trace(rays, backend="per_ray")
    _assert_same(got, engine.trace(rays, backend="wavefront"), "per_ray vs wavefront")
    jengine = JScene.from_triangles(tris).engine()
    jr = jmake_ray(jnp.asarray(org), jnp.asarray(dirs), extent=jnp.asarray(ext))
    want = jengine.trace(jr, backend="per_ray")
    _assert_record(_np(got), _np(want), "per_ray", tris, rays)
    for bad in (dict(t_min=0.5), dict(max_rounds=3)):
        with pytest.raises(ValueError, match="per_ray backend has no"):
            engine.trace(rays, backend="per_ray", **bad)
    with pytest.raises(ValueError, match="supports ray types"):
        engine.trace(rays, "any", backend="per_ray")
    # under arity 8 the oracle walks a BVH8 scene as the reference's does
    wide = Scene.from_triangles(tris, device="cpu", config=DatapathConfig(arity=8))
    jwide = JScene.from_triangles(tris, config=JDatapathConfig(arity=8))
    got8 = trace_rays(wide.bvh, rays, wide.depth, DatapathConfig(arity=8))
    want8 = jtrace_rays(jwide.bvh, jr, jwide.depth, JDatapathConfig(arity=8))
    rounds = lambda rec: rec.quadbox_jobs.max()  # noqa: E731
    _assert_record(_np(TraceResult(*got8, rounds(got8))),
                   _np(TraceResult(*want8, rounds(want8))), "per_ray bvh8", tris, rays)
    _assert_same(wide.engine().trace(rays, backend="per_ray"),
                 wide.engine().trace(rays, backend="wavefront"), "per_ray vs wavefront bvh8")


@pytest.mark.parametrize("backend", ["wavefront", "cuda", None])
def test_occluded_is_the_shadow_hit(backend):
    tris, org, dirs, ext = _random_scene(3, n_rays=80)
    scene = Scene.from_triangles(tris, device="cpu")
    engine = scene.engine()
    rays = make_ray(org, dirs, ext, device="cpu")
    got = engine.occluded(rays, backend=backend)
    assert got.dtype == torch.bool and 0 < int(got.sum()) < 80
    assert torch.equal(got, engine.trace(rays, "shadow", backend=backend).hit)
    assert torch.equal(engine.occluded(rays, t_min=0.5, backend=backend),
                       engine.trace(rays, "shadow", t_min=0.5, backend=backend).hit)
    assert torch.equal(got, occlusion_test(scene.bvh, rays, scene.depth))
    jr = jmake_ray(jnp.asarray(org), jnp.asarray(dirs), extent=jnp.asarray(ext))
    want = JScene.from_triangles(tris).engine().occluded(jr, backend="wavefront")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# plan_for / batch_multiple
# ---------------------------------------------------------------------------

# (method, port backend, reference backend, query parameters)
PLAN_CASES = [
    ("trace", None, None, {}),
    ("trace", "wavefront", "wavefront", {}),
    ("trace", "cuda", "pallas", {}),
    ("trace", "per_ray", "per_ray", {}),
    ("nearest", None, None, dict(k=4)),
    ("nearest", None, None, dict(k=1000)),
    ("nearest", "mxu", "mxu", dict(k=4)),
    ("nearest", "cuda", "pallas", dict(k=4)),
    ("nearest", "tree_cuda", "tree_pallas", dict(k=4)),
    ("within", None, None, dict(radius=0.05, k=4)),
    ("within", None, None, dict(k=4)),
    ("within", "tree_wavefront", "tree_wavefront", dict(radius=0.05, k=4)),
    ("count_within", None, None, dict(radius=0.05)),
    ("count_within", "tree_cuda", "tree_pallas", dict(radius=0.05)),
    ("scores", None, None, {}),
    ("scores", "cuda", "pallas", {}),
]


@pytest.fixture(scope="module")
def engines():
    tris, *_ = _random_scene(4)
    pts = np.random.default_rng(4).normal(size=(4500, 3)).astype(np.float32)
    port = QueryEngine(scene=Scene.from_triangles(tris, device="cpu"),
                       cloud=PointCloudScene.from_points(pts, device="cpu"))
    ref = JQueryEngine(scene=JScene.from_triangles(tris), cloud=JCloud.from_points(pts))
    return port, ref


@pytest.mark.parametrize("case", PLAN_CASES, ids=lambda c: f"{c[0]}-{c[1]}-{len(c[3])}")
def test_plan_for_and_batch_multiple_match_reference(engines, case):
    port, ref = engines
    method, backend, jbackend, kw = case
    assert port.batch_multiple(method, backend, **kw) == \
        ref.batch_multiple(method, jbackend, **kw)
    for n in (1, 7, 129, 1000, 4097):
        for chunk in (None, 64, 300):
            got = port.plan_for(method, n, backend=backend, chunk_size=chunk, **kw)
            want = ref.plan_for(method, n, backend=jbackend, chunk_size=chunk,
                                shard=1, **kw)
            assert (got.n, got.block, got.n_blocks, got.shards) == \
                (want.n, want.block, want.n_blocks, want.shards), (n, chunk)
            assert got.key == want.key


def test_plan_for_rejects_what_the_reference_rejects(engines):
    port, _ = engines
    assert port.SERVABLE_METHODS == ("trace", "nearest", "within", "count_within",
                                     "scores")
    with pytest.raises(ValueError, match="n >= 1"):
        port.plan_for("trace", 0)
    with pytest.raises(ValueError, match="unknown query method"):
        port.plan_for("render", 8)
    with pytest.raises(ValueError, match="unknown trace backend"):
        port.batch_multiple("trace", "pallas")
    with pytest.raises(ValueError, match="unknown distance/neighbor backend"):
        port.batch_multiple("nearest", "tree_pallas")
    with pytest.raises(ValueError, match="chunk_size"):
        port.plan_for("trace", 8, chunk_size=0)
    assert port.plan_for("trace", 5, shard="auto").shards == 1


# ---------------------------------------------------------------------------
# the cache of built run functions over an animated scene
# ---------------------------------------------------------------------------


def _frames(seed, n_frames=4):
    tris, org, dirs, ext = _random_scene(seed, n_rays=64)
    vel = np.random.default_rng(seed).normal(scale=0.3, size=(tris.shape[0], 1, 3))
    frames = [(tris + f * vel).astype(np.float32) for f in range(n_frames)]
    return frames, make_ray(org, dirs, ext, device="cpu")


def test_cache_info_over_an_animated_scene():
    frames, rays = _frames(5)
    scene = Scene.from_triangles(frames[0], device="cpu")
    engine = scene.engine()
    jscene = JScene.from_triangles(frames[0])
    jengine = jscene.engine()
    jr = jmake_ray(*(jnp.asarray(np.asarray(x)) for x in (rays.origin, rays.direction)),
                   extent=jnp.asarray(rays.extent.numpy()))
    for f, moved in enumerate(frames):
        if f:
            scene.refit(moved)
            jscene.refit(moved)
        engine.trace(rays)
        jengine.trace(jr, backend="wavefront")
    assert engine.cache_info() == CacheInfo(hits=3, misses=1, entries=1)
    assert tuple(engine.cache_info()) == tuple(jengine.cache_info())
    engine.occluded(rays)  # another query: one more entry
    assert engine.cache_info() == CacheInfo(hits=3, misses=2, entries=2)
    engine.cache_clear()
    assert engine.cache_info() == CacheInfo(0, 0, 0)
    engine.trace(rays)
    assert engine.cache_info() == CacheInfo(hits=0, misses=1, entries=1)


def test_cache_stays_bounded_over_an_animated_cloud():
    """Each refit of the cloud misses the brute path's key once, as in the
    reference, but the key keeps only its newest version: the engine holds
    no index of an earlier frame."""
    rng = np.random.default_rng(8)
    pts = rng.normal(size=(300, 3)).astype(np.float32)
    q = rng.normal(size=(20, 3)).astype(np.float32)
    cloud = PointCloudScene.from_points(pts, device="cpu")
    jcloud = JCloud.from_points(pts)
    engine, jengine = cloud.engine(), jcloud.engine()
    n_frames = 6
    for f in range(n_frames):
        if f:
            pts = (pts + rng.normal(scale=0.01, size=pts.shape)).astype(np.float32)
            cloud.refit(pts)
            jcloud.refit(pts)
        for _ in range(2):
            got = engine.scores(torch.as_tensor(q))
            want = jengine.scores(jnp.asarray(q))
        c = cloud.index.database.numpy()  # the columns' order
        scale = (q * q).sum(1)[:, None] + (c * c).sum(1)[None, :]
        assert (np.abs(got.numpy() - np.asarray(want)) <= 12 * 2.0**-24 * scale).all()
        info = engine.cache_info()
        assert info == CacheInfo(hits=f + 1, misses=f + 1, entries=1)
        assert info[:2] == jengine.cache_info()[:2]


def test_prepare_runs_once_per_version(monkeypatch):
    from repro_torch.kernels import traverse
    frames, rays = _frames(6)
    scene = Scene.from_triangles(frames[0], device="cpu")
    engine = scene.engine(backend="cuda", chunk_size=16)
    packs = []
    real = traverse.pack_bvh
    monkeypatch.setattr(traverse, "pack_bvh", lambda *a: packs.append(1) or real(*a))
    for f, moved in enumerate(frames):
        if f:
            scene.refit(moved)
        first = engine.trace(rays)
        again = engine.trace(rays)
        _assert_same(first, again)
        _assert_same(first, engine.trace(rays, backend="wavefront"), f"frame {f}")
        assert len(packs) == f + 1 and engine.prepares == f + 1
    # the trace key (4 chunks re-enter it) and the prepare key, each missed once
    info = engine.cache_info()
    assert (info.misses, info.entries) == (3, 3)  # cuda trace, prepare, wavefront


# ---------------------------------------------------------------------------
# shard resolution
# ---------------------------------------------------------------------------


def test_resolve_shards_on_the_cpu(monkeypatch):
    assert available_devices("cpu") == 1
    assert resolve_shards(None) == 1
    assert resolve_shards("auto", 5, "cpu") == 1
    assert resolve_shards("auto", 0, "cpu") == 1
    assert resolve_shards(1, 5, "cpu") == 1
    for bad in (2, 0, -1, 2.5, True, "two"):
        with pytest.raises(ValueError):
            resolve_shards(bad, 5, "cpu")
    tris, org, dirs, ext = _random_scene(7, n_rays=24)
    scene = Scene.from_triangles(tris, device="cpu")
    rays = make_ray(org, dirs, ext, device="cpu")
    engine = scene.engine()
    assert engine.default_shard == "auto"
    _assert_same(engine.trace(rays, shard=1), engine.trace(rays))
    with pytest.raises(ValueError, match="exceeds"):
        engine.trace(rays, shard=2)
    with pytest.raises(ValueError):
        scene.engine(shard=0)
    # two cards: "auto" stays on the one card the port shards over, and the
    # default trace runs; an explicit count the cards could serve is not
    # ported yet
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert available_devices("cuda") == 2
    assert resolve_shards("auto", 1, "cuda") == 1
    assert resolve_shards("auto", 5, "cuda") == 1
    assert engine._resolve_shards(None, 24, torch.device("cuda")) == 1
    _assert_same(engine.trace(rays), engine.trace(rays, shard=1))
    with pytest.raises(NotImplementedError, match="fan-out"):
        resolve_shards(2, 5, "cuda")
    with pytest.raises(ValueError, match="exceeds"):
        resolve_shards(3, 5, "cuda")
