"""The port's traversal and session held against the JAX reference.

Traversal parity is tested apart from builder parity: the reference builds
the tree, ``repro_torch.convert`` carries it across through numpy, and
both packages traverse the very same tree.  Tolerances, and why:

* ``tri_index``, ``hit``, ``quadbox_jobs``, ``triangle_jobs``,
  ``stack_overflow`` and ``rounds`` are **exact**.
* ``t`` differs.  The reference's traversal is jitted, and XLA on the CPU
  contracts mul -> add into FMAs inside it (``repro/kernels/common.py:
  round_stage``); the port rounds every op, as the hardware does.  Under
  cancellation in an edge function the two move apart by more than any
  fixed ulp count (measured: up to 4 ulps on random scenes, 2 on the
  goldens).  So ``t`` is held, per ray, to twice the standard forward
  error bound of the OpTriangle chain evaluated in f64
  (:func:`_t_tolerance`): each of the two values lies within that bound
  of the exact quotient, whichever products were fused.  The port's own
  engines agree with each other bit for bit.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import Triangle as JTriangle
from repro.core import make_ray as jmake_ray
from repro.core.build import build as jbuild
from repro.core.wavefront import trace_wavefront as jtrace_wavefront
from repro.kernels.traverse import pack_bvh as jpack_bvh
from repro.kernels.traverse import traverse_packed as jtraverse_packed
from repro_torch.api import (RAY_TYPES, Scene, TraceResult, make_ray,
                             trace_backend_ray_types, trace_backends)
from repro_torch.convert import bvh_from_numpy, rays_from_numpy
from repro_torch.core.dispatch import (check_count, concat_rows, make_plan,
                                       pad_leading, slice_rows, split_blocks)
from repro_torch.core.wavefront import trace_wavefront
from repro_torch.core.types import Box
from repro_torch.kernels.ops import ray_box_kernel
from repro_torch.kernels.traverse import (pack_bvh, pack_bvh_rows, pack_rays,
                                          traverse_fused, traverse_packed,
                                          unpack_bvh, unpack_rays)
from test_torch_models import one_torch_thread  # noqa: F401  (autouse fixture)

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
EXACT = ("tri_index", "hit", "quadbox_jobs", "triangle_jobs", "stack_overflow",
         "rounds")
GOLDEN_SCENES = ("tetra", "sheet", "cluster")


def _t_tolerance(tris: np.ndarray, rays, tri_index: np.ndarray) -> np.ndarray:
    """Per-ray bound on |t_port - t_reference| for hit rays (0 elsewhere).

    The chain from the f32 inputs (origin, vertices, shear) to ``t_num``
    and ``t_denom`` has at most 10 rounded ops, so each computed value is
    within gamma_10 = 10 u / (1 - 10 u) (u = 2^-24) of the exact value,
    relative to the same chain evaluated on absolute values; an FMA only
    drops roundings, so the bound holds for both packages, and their
    quotients differ by at most twice the quotient's bound."""
    hit = tri_index >= 0
    idx = np.maximum(tri_index, 0)
    org = np.asarray(rays.origin, np.float64)
    shear = np.abs(np.asarray(rays.shear, np.float64))
    s_signed = np.asarray(rays.shear, np.float64)
    k = [np.asarray(x) for x in (rays.kx, rays.ky, rays.kz)]
    rows = np.arange(org.shape[0])

    def sheared(v):  # (value, absolute-value evaluation) of x, y, z
        d = v.astype(np.float64)[idx] - org
        d_abs = np.abs(v.astype(np.float64)[idx]) + np.abs(org)
        kx, ky, kz = (d[rows, k[0]], d[rows, k[1]], d[rows, k[2]])
        ax, ay, az = (d_abs[rows, k[0]], d_abs[rows, k[1]], d_abs[rows, k[2]])
        return ((kx - s_signed[:, 0] * kz, ky - s_signed[:, 1] * kz,
                 s_signed[:, 2] * kz),
                (ax + shear[:, 0] * az, ay + shear[:, 1] * az, shear[:, 2] * az))

    (a, a_abs), (b, b_abs), (c, c_abs) = (sheared(tris[:, i]) for i in range(3))
    u, u_abs = c[0] * b[1] - c[1] * b[0], c_abs[0] * b_abs[1] + c_abs[1] * b_abs[0]
    v, v_abs = a[0] * c[1] - a[1] * c[0], a_abs[0] * c_abs[1] + a_abs[1] * c_abs[0]
    w, w_abs = b[0] * a[1] - b[1] * a[0], b_abs[0] * a_abs[1] + b_abs[1] * a_abs[0]
    den, den_abs = u + v + w, u_abs + v_abs + w_abs
    num = u * a[2] + v * b[2] + w * c[2]
    num_abs = u_abs * a_abs[2] + v_abs * b_abs[2] + w_abs * c_abs[2]
    unit = 2.0**-24
    gamma = 10 * unit / (1 - 10 * unit)
    with np.errstate(divide="ignore", invalid="ignore"):
        rel = gamma * (num_abs / np.abs(num) + den_abs / np.abs(den)) + unit
        tol = 2 * rel * np.abs(num / den)
    return np.where(hit, tol, 0.0)


def _assert_record(got, want, what="", tris=None, rays=None):
    """Exact fields exact; ``t`` bit-equal where both miss, and within
    :func:`_t_tolerance` where they hit."""
    for f in EXACT:
        np.testing.assert_array_equal(np.asarray(getattr(got, f)),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f"{what}: {f}")
    gt, wt = np.asarray(got.t), np.asarray(want.t)
    fin = np.isfinite(wt)
    np.testing.assert_array_equal(np.isfinite(gt), fin, err_msg=f"{what}: t")
    np.testing.assert_array_equal(gt[~fin], wt[~fin], err_msg=f"{what}: t")
    tol = _t_tolerance(tris, rays, np.asarray(got.tri_index))
    err = np.abs(gt[fin].astype(np.float64) - wt[fin])
    assert (err <= tol[fin]).all(), (
        f"{what}: t outside the forward error bound: {err[err > tol[fin]]}")


def _assert_same(a, b, what=""):
    """The port against itself: every field bit-equal."""
    for f in a._fields:
        x, y = getattr(a, f), getattr(b, f)
        if x.dtype == torch.float32:
            x, y = x.view(torch.int32), y.view(torch.int32)
        assert torch.equal(x, y), f"{what}: {f}"


def _np(rec):
    return type(rec)(*[x.numpy() for x in rec])


def _random_scene(seed: int, n_tri: int = 50, n_rays: int = 160):
    """A clumpy soup (depth 3) and rays aimed near triangle centroids, with
    some finite extents."""
    rng = np.random.default_rng(seed)
    tris = (rng.uniform(-5, 5, (n_tri, 1, 3))
            + rng.normal(scale=0.6, size=(n_tri, 3, 3))).astype(np.float32)
    org = rng.uniform(-9, 9, (n_rays, 3)).astype(np.float32)
    aim = tris.mean(axis=1)[rng.integers(0, n_tri, n_rays)]
    tgt = (aim + rng.normal(scale=0.3, size=(n_rays, 3))).astype(np.float32)
    ext = np.where(rng.uniform(size=n_rays) < 0.3,
                   rng.uniform(1, 15, n_rays), np.inf).astype(np.float32)
    return tris, org, (tgt - org).astype(np.float32), ext


def _carried(tris, org, dirs, ext):
    """Reference tree + rays, and the same carried into the port."""
    res = jbuild(JTriangle(*(jnp.asarray(tris[:, i]) for i in range(3))))
    jr = jmake_ray(jnp.asarray(org), jnp.asarray(dirs), extent=jnp.asarray(ext))
    b = res.bvh
    tb = bvh_from_numpy(*(np.asarray(x) for x in
                          (b.node_lo, b.node_hi, b.leaf_tri, *b.triangles,
                           b.leaf_perm)), device="cpu")
    tr = rays_from_numpy(*(np.asarray(x) for x in jr), device="cpu")
    return res, jr, tb, tr


@pytest.mark.parametrize("ray_type", RAY_TYPES)
@pytest.mark.parametrize("seed", [0, 1])
def test_wavefront_on_carried_tree_matches_reference(seed, ray_type):
    tris, org, dirs, ext = _random_scene(seed)
    res, jr, tb, tr = _carried(tris, org, dirs, ext)
    got = trace_wavefront(tb, tr, res.depth, ray_type=ray_type)
    assert int(got.hit.sum()) > 10
    want_wf = jtrace_wavefront(res.bvh, jr, res.depth, ray_type=ray_type)
    want_pl = jtraverse_packed(jpack_bvh(res.bvh), jr, res.depth,
                               ray_type=ray_type, interpret=None)
    _assert_record(_np(got), want_wf, f"wavefront/{ray_type}", tris, tr)
    _assert_record(_np(got), want_pl, f"pallas/{ray_type}", tris, tr)
    # the fused kernel's wrapper (its plain path on CPU), on packed and on
    # unpacked operands, agrees with the plain engine
    packed = pack_bvh(tb)
    _assert_same(traverse_packed(packed, tr, res.depth, ray_type=ray_type), got)
    _assert_same(traverse_fused(tb, tr, res.depth, ray_type=ray_type), got)


def test_rays_missing_the_root_children_retire_after_one_box_job():
    tris, org, dirs, ext = _random_scene(5, n_rays=96)
    dirs[::2] = -dirs[::2]  # half the rays point away from the soup
    org[::2] = org[::2] * 3.0
    res, jr, tb, tr = _carried(tris, org, dirs, ext)
    n = tr.origin.shape[0]
    root = Box(tb.node_lo[1:5].expand(n, 4, 3), tb.node_hi[1:5].expand(n, 4, 3))
    enter = ray_box_kernel(tr, root).is_intersect.any(dim=1)
    assert 0 < int(enter.sum()) < n
    packed = pack_bvh(tb)
    for ray_type in RAY_TYPES:
        got = traverse_packed(packed, tr, res.depth, ray_type=ray_type)
        want = trace_wavefront(tb, tr, res.depth, ray_type=ray_type)
        _assert_same(got, want, ray_type)
        assert (got.quadbox_jobs[~enter] == 1).all()
        assert (got.triangle_jobs[~enter] == 0).all()
        assert not got.hit[~enter].any()
        _assert_record(_np(got), jtrace_wavefront(res.bvh, jr, res.depth,
                                                  ray_type=ray_type),
                       ray_type, tris, tr)


def test_t_min_and_max_rounds_match_reference():
    tris, org, dirs, ext = _random_scene(2)
    res, jr, tb, tr = _carried(tris, org, dirs, ext)
    for kw in ({"t_min": 4.0}, {"max_rounds": 3}, {"max_rounds": 1}):
        want = jtrace_wavefront(res.bvh, jr, res.depth, **kw)
        got = trace_wavefront(tb, tr, res.depth, **kw)
        _assert_record(_np(got), want, str(kw), tris, tr)
        _assert_same(traverse_packed(pack_bvh(tb), tr, res.depth, **kw), got,
                     str(kw))


@pytest.mark.parametrize("ray_type", RAY_TYPES)
@pytest.mark.parametrize("scene", GOLDEN_SCENES)
def test_engine_reproduces_goldens(scene, ray_type):
    data = np.load(os.path.join(GOLDEN, f"{scene}.npz"))
    engine = Scene.from_triangles(data["tris"], device="cpu").engine()
    rays = make_ray(data["ray_org"], data["ray_dir"], data["ray_extent"],
                    device="cpu")
    stem = f"bvh4_s64_fp32_fp32__lbvh__{ray_type}"
    want = TraceResult(**{f: data[f"{stem}__{f}"] for f in TraceResult._fields})
    got = engine.trace(rays, ray_type)
    _assert_record(_np(got), want, f"{scene}/{ray_type}", data["tris"], rays)
    # every backend that takes the ray type, whole and chunked
    for backend in (b for b in trace_backends()
                    if ray_type in trace_backend_ray_types(b)):
        for chunk in (None, 16):
            _assert_same(engine.trace(rays, ray_type, backend=backend,
                                      chunk_size=chunk), got,
                         f"{backend}/{chunk}")


def test_auto_backend_and_engine_knobs():
    tris, org, dirs, ext = _random_scene(3, n_rays=40)
    scene = Scene.from_triangles(tris, device="cpu")
    engine = scene.engine(chunk_size=16, pad_multiple=4)
    assert engine.resolve_trace_backend() == "wavefront"
    rays = make_ray(org, dirs, ext, device="cpu")
    whole = scene.engine().trace(rays)
    _assert_same(engine.trace(rays), whole, "engine chunk_size=16")
    _assert_same(engine.trace(rays, chunk_size=7), whole, "per-call chunk")
    # shard resolves as the reference's does: "auto" is one shard on the
    # CPU, and a count above the device count raises
    _assert_same(engine.trace(rays, shard="auto"), whole, "shard='auto'")
    with pytest.raises(ValueError):
        scene.engine(shard=2).trace(rays)
    with pytest.raises(ValueError):
        engine.trace(rays, chunk_size=0)
    with pytest.raises(ValueError):
        engine.trace(rays, "nearest")
    with pytest.raises(ValueError):
        engine.trace(rays, backend="pallas")


def test_empty_batch_gives_typed_empty_result():
    data = np.load(os.path.join(GOLDEN, "tetra.npz"))
    engine = Scene.from_triangles(data["tris"], device="cpu").engine()
    empty = make_ray(np.zeros((0, 3)), np.zeros((0, 3)), device="cpu")
    for backend in trace_backends():
        ray_type = "shadow" if "shadow" in trace_backend_ray_types(backend) else "closest"
        res = engine.trace(empty, ray_type, backend=backend)
        assert isinstance(res, TraceResult)
        assert all(x.shape == (0,) for x in res[:-1]) and int(res.rounds) == 0
        assert (res.t.dtype, res.tri_index.dtype, res.hit.dtype) == \
            (torch.float32, torch.int32, torch.bool)


def test_pack_unpack_roundtrip_and_lane_padding():
    tris, org, dirs, ext = _random_scene(4, n_rays=130)
    res, jr, tb, tr = _carried(tris, org, dirs, ext)
    op = pack_rays(tr, 256)
    assert op.shape == (16, 256)
    assert torch.equal(op[:, 130:], op[:, :1].expand(16, 126))
    for a, b in zip(unpack_rays(op, 130), tr):
        assert torch.equal(a, b)
    for got, want in zip(pack_bvh_rows(tb), jpack_bvh(res.bvh)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the kernel's layout gives back every box a record depends on (the
    # inner nodes' children's); the root's and the leaves' are not stored
    back = unpack_bvh(pack_bvh(tb), res.depth)
    inner = 1 + 4 * ((4**(res.depth - 1) - 1) // 3)
    assert torch.equal(back.node_lo[1:inner], tb.node_lo[1:inner])
    assert bool(back.node_lo[0].isnan().all() and back.node_lo[inner:].isnan().all())
    assert torch.equal(back.leaf_tri, tb.leaf_tri)
    # what the layout drops changes no record: the unpacked tree traces as
    # the tree itself, every field, for every ray type
    for ray_type in RAY_TYPES:
        _assert_same(trace_wavefront(back, tr, res.depth, ray_type=ray_type),
                     trace_wavefront(tb, tr, res.depth, ray_type=ray_type), ray_type)


def test_dispatch_plan_and_row_helpers():
    assert check_count("chunk_size", None) is None
    for bad in (0, -1, 2.5, True):
        with pytest.raises(ValueError):
            check_count("chunk_size", bad)
    plan = make_plan(300, pad_multiple=8, chunk_size=100, lane_multiple=128)
    assert (plan.block, plan.n_blocks) == (128, 3)
    plan = make_plan(300, pad_multiple=8)
    assert (plan.block, plan.n_blocks) == (304, 1)
    rays = make_ray(np.arange(30.0).reshape(10, 3), np.ones((10, 3)),
                    device="cpu")
    blocks = list(split_blocks(rays, make_plan(10, pad_multiple=4,
                                               chunk_size=4)))
    assert [b.origin.shape[0] for b in blocks] == [4, 4, 4]
    assert torch.equal(blocks[2].origin[2:], blocks[2].origin[:1].expand(2, 3))
    joined = concat_rows(blocks, 10)
    assert torch.equal(joined.origin, rays.origin)
    parts = slice_rows(joined, [3, 7])
    assert torch.equal(parts[1].origin, rays.origin[3:])
    padded = pad_leading(make_ray(np.zeros((0, 3)), np.zeros((0, 3)),
                                  device="cpu"), 4)
    assert padded.origin.shape == (4, 3)
