"""The port's datapath config twins held against the JAX reference.

A :class:`DatapathConfig` sets the arity (4 or 8), the stack size and the
node-box codec (fp32, bf16, compressed).  Tolerances, and why:

* The codecs (``_bf16_down`` / ``_bf16_up``, ``quantize_boxes_bf16``,
  ``compress_nodes``), ``fit_nodes`` and the 8-wide sort network are
  eager ops rounded one at a time in both packages, so they are held
  **bit for bit**, on boxes with -0.0 / +0.0, inverted +-inf pad boxes,
  zero-extent parents and values at and next to bf16 rounding midpoints.
* Traces: ``tri_index``, ``hit``, the job counters, ``stack_overflow``
  and ``rounds`` exact; ``t`` within ``_t_tolerance``
  (``tests/test_torch_trace.py``): the reference's traversal loop is
  compiled by XLA, which may contract products into FMAs.  The port's
  engines agree with each other bit for bit.
* The contract of the codec twins (``tests/test_fuzz_backends.py`` states
  it): closest hits equal the exact twin's, and the job counters are at
  least those of the exact twin of the same builder, arity and stack,
  traced under that twin's own config, where neither overflowed.  One
  case is the fuzz's falsifying draw (BVH8, stack 16, bf16, SAH), which
  fails there because the fuzz traces the exact twin without its config.
  Ray by ray the counters hold on every ray that commits no hit; a ray
  that hits may visit fewer nodes, in the reference too.
"""
import os

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.api import Scene as JScene
from repro.core import bvh as jbvh
from repro.core import make_ray as jmake_ray
from repro.core.build import refit as jrefit
from repro.core.datapath import boxsort as jboxsort
from repro.core.datapath import ray_box_test as jray_box_test
from repro.core.types import Box as JBox
from repro.core.wavefront import trace_wavefront as jtrace_wavefront
from repro.kernels.traverse import pack_bvh as jpack_bvh
from repro.kernels.traverse import traverse_packed as jtraverse_packed
from repro_torch.api import Scene, TraceResult, make_ray
from repro_torch.convert import config_from_tag, scene_from_numpy
from repro_torch.core import bvh as tbvh
from repro_torch.core.datapath import boxsort, ray_box_test
from repro_torch.core.types import Box, Triangle
from repro_torch.core.wavefront import trace_wavefront
from repro_torch.kernels.traverse import pack_bvh, pack_bvh_rows, traverse_packed
from test_torch_models import one_torch_thread  # noqa: F401  (autouse fixture)
from test_torch_trace import GOLDEN, GOLDEN_SCENES, _assert_record, _assert_same

CODECS = (("fp32", "fp32"), ("bf16", "fp32"), ("bf16", "compressed"))
GOLDEN_CONFIGS = ("bvh4_s64_fp32_fp32", "bvh8_s64_fp32_fp32", "bvh4_s64_bf16_compressed")
FUZZ_CONFIGS = [(arity, stack, codec) for arity in (4, 8) for stack in (16, 64)
                for codec in CODECS]  # tests/test_fuzz_backends.py's domain


def _bits(x) -> np.ndarray:
    x = np.asarray(x)
    return x.view(np.int32) if x.dtype == np.float32 else x


def _np(rec):
    return type(rec)(*[np.asarray(x) for x in rec])


def _nodes(seed: int, depth: int, arity: int) -> np.ndarray:
    """(2, arity**depth, 3) leaf boxes: finite boxes spanning scales,
    inverted +-inf pads, zero-extent boxes, -0.0 / +0.0 bounds and bounds
    at or one ulp from a bf16 rounding midpoint."""
    rng = np.random.default_rng(seed)
    n = arity**depth
    lo = rng.normal(size=(n, 3)) * rng.choice([1e-3, 1.0, 1e3], size=(n, 1))
    hi = lo + np.abs(rng.normal(size=(n, 3)))
    mid = np.float32(1.0) + np.float32(2.0**-8)  # halfway between two bf16s
    near = (mid * rng.choice([1.0, -1.0, 0.5, 4.0], size=(n, 3))).astype(np.float32)
    step = np.nextafter(near, rng.choice([-np.inf, np.inf], size=(n, 3)).astype(np.float32))
    near = np.where(rng.random((n, 3)) < 0.5, step, near).astype(np.float32)
    lo, hi = lo.astype(np.float32), hi.astype(np.float32)
    pick = rng.random(n)
    lo[pick < 0.1] = np.minimum(near[pick < 0.1], hi[pick < 0.1])
    hi[(pick >= 0.1) & (pick < 0.2)] = lo[(pick >= 0.1) & (pick < 0.2)]  # zero extent
    zero = (pick >= 0.2) & (pick < 0.3)
    lo[zero] = np.where(rng.random((int(zero.sum()), 3)) < 0.5, -0.0, 0.0)
    hi[zero] = np.where(rng.random((int(zero.sum()), 3)) < 0.5, -0.0, 0.0)
    pad = pick >= 0.75
    lo[pad], hi[pad] = np.inf, -np.inf
    # one parent whose children's bounds are all +-0.0, a +0.0 first: the
    # reference's min gives -0.0 and its max +0.0, whatever the order
    first = np.arange(arity)[:, None] % 2 == 1
    lo[:arity] = np.where(first, -0.0, 0.0)
    hi[:arity] = np.where(first, 0.0, -0.0)
    return np.stack([lo, hi])


def test_config_surface_matches_reference():
    assert tbvh.resolve_config(None) == tbvh.DEFAULT_CONFIG
    for arity, stack, codec in FUZZ_CONFIGS + [(8, 1, CODECS[0]), (4, 200, CODECS[2])]:
        t = tbvh.DatapathConfig(arity, stack, *codec)
        j = jbvh.DatapathConfig(arity, stack, *codec)
        assert t.validate() == t and tuple(j.validate()) == tuple(t)
        assert (t.tag, t.exact_boxes, t.box_bytes_per_node) == \
            (j.tag, j.exact_boxes, j.box_bytes_per_node)
        assert config_from_tag(t.tag) == t
        assert t.packed_box_dtype.itemsize == np.dtype(j.packed_box_dtype).itemsize
    assert [tbvh.DatapathConfig(precision=p, node_format=f).box_bytes_per_node
            for p, f in CODECS] == [24, 12, 6]
    with pytest.raises(ValueError, match="tag"):
        config_from_tag("bvh4-s64")


def test_depth_of_is_exact_at_every_power_of_the_arity():
    """A depth-7 BVH8 has 8**7 leaf slots, where the floating log gives
    7.000000000000001: ``depth_of`` counts in integers, so refit and
    ``stats()`` see depth 7.  A build's default depth keeps the reference's
    formula (so an 8**7-triangle soup builds at depth 8 in both packages)."""
    for arity in (4, 8):
        for depth in range(1, {4: 11, 8: 8}[arity]):
            n = arity**depth
            bvh = tbvh.BVH4(*(None,) * 2, torch.empty((n,), dtype=torch.int32), None, None)
            assert tbvh.depth_of(bvh, arity) == tbvh.leaf_depth(n, arity) == depth
            assert tbvh.bvh_depth(n, arity) == jbvh.bvh_depth(n, arity)
    assert tbvh.bvh_depth(8**7, 8) == 8


def test_bf16_rounding_at_midpoints_bit_equal():
    """``.to(torch.bfloat16)`` rounds to nearest, ties to even, as XLA's
    cast does: exact midpoints between bf16 neighbours and the f32 values
    one ulp either side, over many binades and both signs."""
    grid = np.arange(-2**15, 2**15, 37, dtype=np.int32).astype(np.uint16)
    grid = grid.view(ml_dtypes.bfloat16).astype(np.float32)
    grid = grid[np.isfinite(grid)]
    up = (grid.astype(np.float32).view(np.int32) + (1 << 16)).view(np.float32)
    mids = ((grid.astype(np.float64) + up) / 2).astype(np.float32)
    x = np.concatenate([mids, np.nextafter(mids, np.inf), np.nextafter(mids, -np.inf),
                        np.float32([0.0, -0.0, 1e-30, -1e-30, np.inf, -np.inf])])
    x = x[np.isfinite(x) | np.isinf(x)].astype(np.float32)
    want = np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))
    got = torch.as_tensor(x).to(torch.bfloat16).to(torch.float32).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(want))
    for t_fn, j_fn in ((tbvh._bf16_down, jbvh._bf16_down), (tbvh._bf16_up, jbvh._bf16_up)):
        np.testing.assert_array_equal(_bits(t_fn(torch.as_tensor(x)).numpy()),
                                      _bits(j_fn(jnp.asarray(x))))


@pytest.mark.parametrize("arity", [4, 8])
def test_fit_and_codecs_bit_equal(arity):
    depth = {4: 3, 8: 2}[arity]
    for seed in range(3):
        lo, hi = _nodes(seed, depth, arity)
        want = jbvh.fit_nodes(jnp.asarray(lo), jnp.asarray(hi), depth, arity)
        got = tbvh.fit_nodes(torch.as_tensor(lo), torch.as_tensor(hi), depth, arity)
        for g, w in zip(got, want):  # -0.0 orders below +0.0, as in XLA
            np.testing.assert_array_equal(_bits(g.numpy()), _bits(w), err_msg="fit")
        node_lo, node_hi = (np.asarray(x) for x in want)
        jn = (jnp.asarray(node_lo), jnp.asarray(node_hi))
        tn = (torch.as_tensor(node_lo.copy()), torch.as_tensor(node_hi.copy()))
        pairs = {
            "quantize": (tbvh.quantize_boxes_bf16(*tn), jbvh.quantize_boxes_bf16(*jn)),
            "compress": (tbvh.compress_nodes(*tn, depth, arity),
                         jbvh.compress_nodes(*jn, depth, arity)),
        }
        for codec in CODECS:
            cfg = dict(arity=arity, precision=codec[0], node_format=codec[1])
            pairs[str(codec)] = (tbvh.encode_nodes(*tn, depth, tbvh.DatapathConfig(**cfg)),
                                 jbvh.encode_nodes(*jn, depth, jbvh.DatapathConfig(**cfg)))
        for what, (g, w) in pairs.items():
            for a, b in zip(g, w):
                np.testing.assert_array_equal(_bits(a.numpy()), _bits(b),
                                              err_msg=f"seed {seed}: {what}")
        # every bound below the root (the root's own box is never tested)
        # lies on the bf16 grid, and every decoded box holds the exact one
        d_lo, d_hi = pairs["compress"][0]
        for d in (d_lo[1:], d_hi[1:]):
            assert torch.equal(d.to(torch.bfloat16).to(torch.float32), d)
        live = torch.isfinite(tn[0])
        assert (d_lo[live] <= tn[0][live]).all() and (d_hi[live] >= tn[1][live]).all()


def test_boxsort_and_box_test_width8_bit_equal():
    rng = np.random.default_rng(2)
    keys = np.round(rng.normal(size=(400, 8)), 1).astype(np.float32)  # ties
    keys[rng.random((400, 8)) < 0.05] = np.nan
    keys[rng.random((400, 8)) < 0.05] = -0.0
    keys[rng.random((400, 8)) < 0.05] = np.inf
    idx = np.broadcast_to(np.arange(8, dtype=np.int32), (400, 8)).copy()
    hit = (rng.random((400, 8)) < 0.5).astype(np.int32)
    got = boxsort(torch.as_tensor(keys), torch.as_tensor(idx), torch.as_tensor(hit))
    want = jboxsort(jnp.asarray(keys), jnp.asarray(idx), jnp.asarray(hit))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_bits(g.numpy()), _bits(w))
    with pytest.raises(ValueError, match="sort width"):
        boxsort(torch.zeros((2, 5)))
    # the 8-wide box test: rays with +-0.0 directions against 8 boxes
    lo, hi = _nodes(4, 1, 8)
    lo, hi = np.broadcast_to(lo, (64, 8, 3)), np.broadcast_to(hi, (64, 8, 3))
    org = rng.uniform(-3, 3, (64, 3)).astype(np.float32)
    dirs = rng.normal(size=(64, 3)).astype(np.float32)
    dirs[::5, 0] = -0.0
    tr = make_ray(org, dirs, device="cpu")
    jr = jmake_ray(jnp.asarray(org), jnp.asarray(dirs))
    got = ray_box_test(tr, Box(torch.as_tensor(lo.copy()), torch.as_tensor(hi.copy())))
    want = jray_box_test(jr, JBox(jnp.asarray(lo), jnp.asarray(hi)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_bits(g.numpy()), _bits(w))


@pytest.mark.parametrize("builder", ["lbvh", "sah"])
@pytest.mark.parametrize("tag", GOLDEN_CONFIGS)
@pytest.mark.parametrize("scene", GOLDEN_SCENES)
def test_every_golden_entry_through_the_port(scene, tag, builder):
    """The 18 golden entries of each fixture, (config, builder, ray type),
    through the port's build and its wavefront engine; the per-ray oracle
    and the kernel backend's plain path bit-equal to it."""
    data = np.load(os.path.join(GOLDEN, f"{scene}.npz"))
    config = config_from_tag(tag)
    sc = Scene.from_triangles(data["tris"], builder=builder, config=config,
                              device="cpu")
    engine = sc.engine()
    rays = make_ray(data["ray_org"], data["ray_dir"], data["ray_extent"], device="cpu")
    for ray_type in ("closest", "any", "shadow"):
        stem = f"{tag}__{builder}__{ray_type}"
        want = TraceResult(**{f: data[f"{stem}__{f}"] for f in TraceResult._fields})
        got = engine.trace(rays, ray_type, backend="wavefront")
        _assert_record(_np(got), want, f"{scene}/{stem}", data["tris"], rays)
        _assert_same(engine.trace(rays, ray_type, backend="cuda", chunk_size=16), got,
                     f"{scene}/{stem}: cuda backend, plain path")
        if ray_type == "closest":
            _assert_same(engine.trace(rays, backend="per_ray"), got,
                         f"{scene}/{stem}: per_ray")


def _fuzz_scene(seed: int, n_tri: int) -> np.ndarray:
    """The fuzz suite's soup for (seed, n_tri), as (N, 3, 3)."""
    rng = np.random.default_rng(1000 * seed + n_tri)
    ctr = rng.uniform(-1, 1, (n_tri, 3)).astype(np.float32)
    d1 = rng.normal(scale=0.2, size=(n_tri, 3)).astype(np.float32)
    d2 = rng.normal(scale=0.2, size=(n_tri, 3)).astype(np.float32)
    return np.stack([ctr, ctr + d1, ctr + d2], axis=1)


def _fuzz_rays(seed: int, n: int):
    """The fuzz suite's rays for (ray_seed, n_rays), as numpy."""
    rng = np.random.default_rng(seed)
    org = rng.uniform(-3, -2, (n, 3)).astype(np.float32)
    tgt = rng.uniform(-0.6, 0.6, (n, 3)).astype(np.float32)
    ext = np.where(rng.uniform(size=n) < 0.3, rng.uniform(1.0, 6.0, n),
                   np.inf).astype(np.float32)
    return org, (tgt - org).astype(np.float32), ext


_REF_SCENES: dict = {}


def _ref_scene(tris: np.ndarray, arity: int, codec) -> JScene:
    """The reference's LBVH scene, once per (arity, codec): the stack size
    changes no tree."""
    key = (arity, codec)
    if key not in _REF_SCENES:
        _REF_SCENES[key] = JScene.from_triangles(
            tris, config=jbvh.DatapathConfig(arity=arity, precision=codec[0],
                                             node_format=codec[1]))
    return _REF_SCENES[key]


@pytest.mark.parametrize("arity,stack,codec", FUZZ_CONFIGS,
                         ids=[f"bvh{a}_s{s}_{'_'.join(c)}" for a, s, c in FUZZ_CONFIGS])
def test_wavefront_under_fuzz_configs_matches_reference(arity, stack, codec):
    """The reference's tree, carried across under its config tag, traced
    by both packages' ``trace_wavefront``; the port's own build of the
    same soup is the same tree.  One ray type per config, in turn, so each
    arity and codec meets all three (the reference compiles its loop once
    per config and ray type)."""
    tris = _fuzz_scene(0, 60)
    org, dirs, ext = _fuzz_rays(5, 48)
    jcfg = jbvh.DatapathConfig(arity, stack, *codec)
    js = _ref_scene(tris, arity, codec)
    b = js.bvh
    sc = scene_from_numpy(*(np.asarray(x) for x in (b.node_lo, b.node_hi, b.leaf_tri,
                                                     *b.triangles, b.leaf_perm)),
                          js.depth, config=jcfg.tag, device="cpu")
    assert sc.config.tag == jcfg.tag
    own = Scene.from_triangles(tris, config=sc.config, device="cpu")
    for f in ("node_lo", "node_hi", "leaf_tri"):
        assert torch.equal(_as_bits(getattr(own.bvh, f)), _as_bits(getattr(sc.bvh, f))), f
    ray_type = ("closest", "any", "shadow")[FUZZ_CONFIGS.index((arity, stack, codec)) % 3]
    rays = make_ray(org, dirs, ext, device="cpu")
    jr = jmake_ray(jnp.asarray(org), jnp.asarray(dirs), extent=jnp.asarray(ext))
    want = jtrace_wavefront(js.bvh, jr, js.depth, ray_type=ray_type, config=jcfg)
    got = trace_wavefront(sc.bvh, rays, sc.depth, ray_type=ray_type, config=sc.config)
    _assert_record(_np(got), want, f"{jcfg.tag}/{ray_type}", tris, rays)
    assert int(got.hit.sum()) > 5
    _assert_same(own.engine().trace(rays, ray_type, backend="cuda"), got, "cuda plain path")


def _as_bits(x: torch.Tensor) -> torch.Tensor:
    return x.view(torch.int32) if x.dtype == torch.float32 else x


SUPERSET_CASES = [
    # the draw that tests/test_fuzz_backends.py printed:
    # scene_seed, n_tri, builder, arity, stack_size, codec, ray_seed, n_rays
    (0, 230, "sah", 8, 16, ("bf16", "fp32"), 15903, 21),
    (1, 230, "lbvh", 4, 64, ("bf16", "compressed"), 7, 24),
    (0, 17, "sah", 8, 64, ("bf16", "compressed"), 99, 24),
]


@pytest.mark.parametrize("case", SUPERSET_CASES,
                         ids=["fuzz_falsifying_draw", "bvh4_lbvh_compressed",
                              "bvh8_sah_compressed"])
def test_codec_twins_honor_the_superset_contract(case):
    """On these draws every ray of a codec twin issues at least the jobs
    of the exact twin (same builder, arity and stack, traced under its own
    config).  That per-ray form holds on every ray that commits no hit: a
    widened box is hit wherever the exact one is, and nothing prunes the
    walk.  A ray that hits may visit fewer nodes in general (the widened
    boxes reorder its children, so it prunes in another order); the
    reference does the same (``ROADMAP.md`` §3)."""
    seed, n_tri, builder, arity, stack, codec, ray_seed, n_rays = case
    tris = _fuzz_scene(seed, n_tri)
    rays = make_ray(*_fuzz_rays(ray_seed, n_rays), device="cpu")
    narrow = tbvh.DatapathConfig(arity, stack, *codec)
    exact = tbvh.DatapathConfig(arity, stack)
    scenes = {c: Scene.from_triangles(tris, builder=builder, config=c, device="cpu")
              for c in (narrow, exact, tbvh.DEFAULT_CONFIG)}

    def trace(config, ray_type, traced_as=None):
        sc = scenes[config]
        return trace_wavefront(sc.bvh, rays, sc.depth, ray_type=ray_type,
                               config=traced_as or config)

    base = trace(tbvh.DEFAULT_CONFIG, "closest")  # the BVH4-fp32 default twin
    for ray_type in ("closest", "any", "shadow"):
        got, ex = trace(narrow, ray_type), trace(exact, ray_type)
        ok = ~got.stack_overflow & ~ex.stack_overflow
        if ray_type == "closest":
            ok_base = ok & ~base.stack_overflow
            for f in ("t", "tri_index", "hit"):
                assert torch.equal(getattr(got, f)[ok_base], getattr(base, f)[ok_base]), f
            assert (got.quadbox_jobs[ok] >= ex.quadbox_jobs[ok]).all(), narrow.tag
            assert (got.triangle_jobs[ok] >= ex.triangle_jobs[ok]).all(), narrow.tag
        else:
            assert torch.equal(got.hit[ok], ex.hit[ok]), ray_type
        miss = ok & ~got.hit & ~ex.hit
        assert (got.quadbox_jobs[miss] >= ex.quadbox_jobs[miss]).all(), ray_type
        assert (got.triangle_jobs[miss] >= ex.triangle_jobs[miss]).all(), ray_type
    if case == SUPERSET_CASES[0]:
        # the fuzz walks the exact BVH8 tree as a BVH4 with a 64-entry stack
        # (its trace passes no config): ray 12 then counts 12 triangle jobs
        # against the narrow twin's 8; under its own config the twin counts 8
        wrong = trace(exact, "closest", traced_as=tbvh.DEFAULT_CONFIG)
        right = trace(exact, "closest")
        assert (int(wrong.triangle_jobs[12]), int(right.triangle_jobs[12]),
                int(trace(narrow, "closest").triangle_jobs[12])) == (12, 8, 8)


def test_superset_holds_on_every_missing_ray():
    """A larger batch: on every ray that hits nothing the codec twins issue
    at least the exact twin's jobs, ray by ray and for every ray type."""
    tris = _fuzz_scene(1, 230)
    org, dirs, ext = _fuzz_rays(17, 600)
    rays = make_ray(org, dirs, ext, device="cpu")
    for builder in ("lbvh", "sah"):
        ex_sc = Scene.from_triangles(tris, builder=builder, device="cpu")
        # the exact twin, traced once per builder and ray type
        exact = {ray_type: trace_wavefront(ex_sc.bvh, rays, ex_sc.depth, ray_type=ray_type)
                 for ray_type in ("closest", "any", "shadow")}
        for codec in CODECS[1:]:
            narrow = tbvh.DatapathConfig(4, 64, *codec)
            sc = Scene.from_triangles(tris, builder=builder, config=narrow, device="cpu")
            for ray_type, ex in exact.items():
                got = trace_wavefront(sc.bvh, rays, sc.depth, ray_type=ray_type,
                                      config=narrow)
                miss = ~got.hit & ~ex.hit
                assert int(miss.sum()) > 50 and torch.equal(got.hit, ex.hit)
                assert (got.quadbox_jobs[miss] >= ex.quadbox_jobs[miss]).all()
                assert (got.triangle_jobs[miss] >= ex.triangle_jobs[miss]).all()


@pytest.mark.parametrize("tag", ["bvh8_s64_fp32_fp32", "bvh4_s64_bf16_compressed"])
def test_fused_kernel_under_config_matches_pallas_interpret(tag):
    """One tiny case per twin against the reference's fused Pallas kernel
    in interpret mode: the packed bf16 rows equal the reference's, and the
    wrapper's CPU path (unpack, upcast, ``trace_wavefront``) its record."""
    tris = _fuzz_scene(2, 17)
    org, dirs, ext = _fuzz_rays(3, 16)
    jcfg = jbvh.DatapathConfig(*config_from_tag(tag))
    js = JScene.from_triangles(tris, config=jcfg)
    sc = Scene.from_triangles(tris, config=config_from_tag(tag), device="cpu")
    rows, jpacked = pack_bvh_rows(sc.bvh, sc.config), jpack_bvh(js.bvh, jcfg)
    packed = pack_bvh(sc.bvh, sc.config)
    assert rows.nlo.dtype == packed.kids.dtype == sc.config.packed_box_dtype
    for g, w in zip(rows, jpacked):
        g = g.view(torch.int16) if g.dtype == torch.bfloat16 else _as_bits(g)
        w = np.asarray(w)
        w = w.view(np.int16) if w.dtype == ml_dtypes.bfloat16 else _bits(w)
        np.testing.assert_array_equal(g.numpy(), w)
    rays = make_ray(org, dirs, ext, device="cpu")
    jr = jmake_ray(jnp.asarray(org), jnp.asarray(dirs), extent=jnp.asarray(ext))
    want = jtraverse_packed(jpacked, jr, js.depth, config=jcfg, interpret=True)
    got = traverse_packed(packed, rays, sc.depth, config=sc.config)
    _assert_record(_np(got), want, f"{tag}: pallas interpret", tris, rays)
    _assert_same(got, trace_wavefront(sc.bvh, rays, sc.depth, config=sc.config))


@pytest.mark.parametrize("tag", ["bvh8_s64_fp32_fp32", "bvh4_s64_bf16_compressed"])
def test_refit_under_config(tag):
    """Refit under a twin's config re-encodes as the build does (bit-equal
    to the build on unchanged geometry) and as the reference's refit does
    on moved geometry; ``stats()`` reports the codec's node bytes."""
    tris = _fuzz_scene(3, 60)
    config = config_from_tag(tag)
    sc = Scene.from_triangles(tris, config=config, device="cpu")
    built = sc.bvh
    sc.refit(tris)
    for f in ("node_lo", "node_hi", "leaf_tri", "leaf_perm"):
        assert torch.equal(_as_bits(getattr(sc.bvh, f)), _as_bits(getattr(built, f))), f
    moved = (tris + np.random.default_rng(4).normal(scale=0.05, size=tris.shape)
             ).astype(np.float32)
    sc.refit(moved)
    jcfg = jbvh.DatapathConfig(*config)
    js = JScene.from_triangles(tris, config=jcfg)
    want = jrefit(js.bvh, type(js.bvh.triangles)(*(jnp.asarray(moved[:, i])
                                                   for i in range(3))), jcfg)
    for f in ("node_lo", "node_hi", "leaf_tri"):
        np.testing.assert_array_equal(_bits(getattr(sc.bvh, f).numpy()),
                                      _bits(getattr(want, f)), err_msg=f)
    st = sc.stats(probes=16)
    assert (st.arity, st.bytes_per_node) == (config.arity, config.box_bytes_per_node)
    assert st.compression_ratio == 24.0 / config.box_bytes_per_node
    assert isinstance(sc.bvh.triangles, Triangle)
