"""The port's LBVH builder held against the JAX reference, bit for bit.

The builder is compare/select, min/max, one rounded op per stage and a
stable sort, so ``node_lo`` / ``node_hi`` / ``leaf_tri`` / ``leaf_perm``
must be **bit-equal** to ``repro.core.build.build`` on the same soup
(compared as bit patterns, so -0.0 and the +-inf pad boxes count too).
``nondegenerate_mask`` is a cross product: the reference computes it in
one jitted ``jnp.cross``, where XLA may contract mul -> sub into an FMA;
the test checks that this moves no triangle across the cull on exactly
degenerate soups (points, and colinear triangles on a dyadic grid, whose
products are exact with or without the contraction).
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import Triangle as JTriangle
from repro.core import bvh as jbvh
from repro.core.build import build as jbuild
from repro.core.build.lbvh import morton3d as jmorton3d
from repro.core.build.quality import clustered_soup as jclustered_soup
from repro_torch.core import bvh as tbvh
from repro_torch.core.build import BuildResult, build, builders, register_builder
from repro_torch.core.build.lbvh import morton3d
from repro_torch.core.build.quality import clustered_soup
from repro_torch.core.types import Triangle
from test_torch_models import one_torch_thread  # noqa: F401  (autouse fixture)

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
GOLDEN_SCENES = ("tetra", "sheet", "cluster")
FIELDS = ("node_lo", "node_hi", "leaf_tri", "leaf_perm")


def _bits(x) -> np.ndarray:
    x = np.asarray(x)
    return x.view(np.int32) if x.dtype == np.float32 else x.astype(np.int64)


def _soups(tris: np.ndarray):
    jt = JTriangle(*(jnp.asarray(tris[:, i]) for i in range(3)))
    tt = Triangle(*(torch.as_tensor(tris[:, i].copy()) for i in range(3)))
    return jt, tt


def _random_soup(seed: int, n: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    ctr = rng.uniform(-5, 5, (n, 1, 3))
    return (ctr + rng.normal(scale=0.4, size=(n, 3, 3))).astype(np.float32)


def _degenerate_soup(seed: int, n: int) -> np.ndarray:
    """A random soup in which a third of the triangles are points and a
    third are colinear, all on a dyadic grid (every product exact)."""
    rng = np.random.default_rng(seed)
    tris = (rng.integers(-64, 64, (n, 3, 3)) / 8.0).astype(np.float32)
    pts = np.arange(n) % 3 == 0
    tris[pts] = tris[pts, :1]
    col = np.arange(n) % 3 == 1
    d = (rng.integers(-8, 8, (n, 1, 3)) / 4.0).astype(np.float32)
    tris[col, 1] = tris[col, 0] + d[col, 0]
    tris[col, 2] = tris[col, 0] + 2 * d[col, 0]
    return tris


def _scene_tris(name: str) -> np.ndarray:
    if name.startswith("random"):
        return _random_soup(int(name[-1]), 50)
    if name == "degenerate":
        return _degenerate_soup(5, 50)
    return np.load(os.path.join(GOLDEN, f"{name}.npz"))["tris"]


@pytest.mark.parametrize("scene", GOLDEN_SCENES + ("random1", "degenerate"))
def test_lbvh_bit_equal_to_reference(scene):
    tris = _scene_tris(scene)
    jt, tt = _soups(tris)
    want = jbuild(jt, "lbvh")
    got = build(tt, "lbvh")
    assert got.depth == want.depth and got.builder == "lbvh"
    for f in FIELDS:
        np.testing.assert_array_equal(_bits(getattr(got.bvh, f).numpy()),
                                      _bits(getattr(want.bvh, f)), err_msg=f)
    for g, w in zip(got.bvh.triangles, want.bvh.triangles):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_degenerate_cull_matches_reference_fma_or_not():
    tris = _degenerate_soup(6, 90)
    jt, tt = _soups(tris)
    want = np.asarray(jbvh.nondegenerate_mask(jt))
    got = tbvh.nondegenerate_mask(tt).numpy()
    np.testing.assert_array_equal(got, want)
    assert (~got).sum() >= 60  # points and colinear triangles are culled
    leaf = build(tt).bvh.leaf_tri.numpy()
    assert set(leaf[leaf >= 0]) == set(np.flatnonzero(got))


def test_morton_codes_bit_equal_incl_clip():
    rng = np.random.default_rng(11)
    pts = rng.uniform(-0.1, 1.1, (2000, 3)).astype(np.float32)
    pts[:4] = [[0, 0, 0], [1, 1, 1], [0.5, 1.0, 0.0], [1e-7, 0.999999, 0.5]]
    want = np.asarray(jmorton3d(jnp.asarray(pts))).astype(np.int64)
    got = morton3d(torch.as_tensor(pts)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.max() < 2**30


@pytest.mark.parametrize("n", [1, 2, 4, 5, 16, 17, 64, 65, 4**10])
def test_implicit_layout_helpers_match(n):
    assert tbvh.bvh_depth(n) == jbvh.bvh_depth(n, 4)
    d = tbvh.bvh_depth(n)
    assert tbvh.num_nodes(d) == jbvh.num_nodes(d, 4)
    assert [tbvh.level_offset(i) for i in range(d + 2)] == \
        [jbvh.level_offset(i, 4) for i in range(d + 2)]


def test_child_boxes_and_fit_nodes_match():
    tris = _random_soup(2, 50)  # the size of the other random soups: the
    jt, tt = _soups(tris)  # reference's eager ops are compiled once per size
    want = jbuild(jt).bvh
    got = build(tt).bvh
    nodes = np.asarray([0, 1, 3, 7, 20], np.int32)
    jb = jbvh.child_boxes(want, jnp.asarray(nodes))
    tb = tbvh.child_boxes(got, torch.as_tensor(nodes))
    for g, w in zip(tb, jb):
        np.testing.assert_array_equal(_bits(g.numpy()), _bits(w))
    depth = tbvh.bvh_depth(50)
    leaf_lo = got.node_lo[tbvh.level_offset(depth):]
    leaf_hi = got.node_hi[tbvh.level_offset(depth):]
    lo, hi = tbvh.fit_nodes(leaf_lo, leaf_hi, depth)
    np.testing.assert_array_equal(_bits(lo.numpy()), _bits(want.node_lo))
    np.testing.assert_array_equal(_bits(hi.numpy()), _bits(want.node_hi))


def test_clustered_soup_same_numbers_from_same_seed():
    want = jclustered_soup(np.random.default_rng(42), n_clusters=4,
                           per_cluster=30)
    got = clustered_soup(np.random.default_rng(42), 4, 30, device="cpu")
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_registry_and_config_guards():
    assert {"lbvh", "sah"} <= set(builders())
    tt = _soups(_random_soup(3, 20))[1]
    with pytest.raises(ValueError, match="unknown builder"):
        build(tt, "median")
    with pytest.raises(ValueError, match="leaf slots"):
        build(tt, depth=1)
    # the guards that remain are the reference's own (DatapathConfig.validate)
    for bad, field in ((dict(arity=3), "arity"), (dict(stack_size=0), "stack_size"),
                       (dict(precision="fp16"), "precision"),
                       (dict(node_format="zip"), "node_format")):
        with pytest.raises(ValueError, match=field):
            build(tt, config=tbvh.DatapathConfig(**bad))
        with pytest.raises(ValueError, match=field):
            jbvh.DatapathConfig(**bad).validate()
    for cfg in (tbvh.DatapathConfig(arity=8), tbvh.DatapathConfig(stack_size=8),
                tbvh.DatapathConfig(precision="bf16")):
        assert build(tt, config=cfg).config == cfg
    assert tbvh.DEFAULT_CONFIG.tag == jbvh.DEFAULT_CONFIG.tag

    @register_builder("lbvh_twice_for_test")
    def _twice(tri, depth, config):
        return build(tri, "lbvh", depth, config).bvh

    try:
        res = build(tt, "lbvh_twice_for_test")
        assert isinstance(res, BuildResult) and res.builder == "lbvh_twice_for_test"
    finally:
        from repro_torch.core import build as build_mod
        build_mod._BUILDERS.pop("lbvh_twice_for_test")
