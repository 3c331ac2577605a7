"""The port's binned-SAH builder held against the JAX reference, bit for bit.

``sah_leaf_perm`` is min / max reductions, a truncating bin index, the
SAH sweep (``a*b + c*d`` forms, each op rounded on its own as in the
reference's eager build), first-index ``argmax`` / ``argmin`` and a
stable two-pass argsort, so ``leaf_perm`` and the node arrays must be
**bit-equal** to ``repro``'s (compared as bit patterns: -0.0 and the
+-inf pad boxes count), at arity 4 and 8, under every node-box codec,
for triangle soups and for point clouds.  The soups: random, clustered
(``clustered_soup``), exactly degenerate (points and colinear triangles
on a dyadic grid) and one whose coordinates hold -0.0 and +0.0.  Every
soup and cloud has :data:`N` primitives: the reference's eager build
compiles each op once per shape, so shared shapes keep this file fast.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import Box as JBox
from repro.core import Triangle as JTriangle
from repro.core.build import build as jbuild
from repro.core.build.points import build_point_bvh as jbuild_point_bvh
from repro.core.build.quality import clustered_soup as jclustered_soup
from repro.core.build.sah import sah_leaf_perm as jsah_leaf_perm
from repro.core.bvh import DatapathConfig as JConfig
from repro.core.types import aabb_of_triangles as jaabb
from repro_torch.core.build import build
from repro_torch.core.build.points import build_point_bvh
from repro_torch.core.build.sah import BINS, sah_leaf_perm
from repro_torch.core.bvh import DatapathConfig
from repro_torch.core.types import Box, Triangle, aabb_of_triangles

FIELDS = ("node_lo", "node_hi", "leaf_tri", "leaf_perm")
CODECS = (("fp32", "fp32"), ("bf16", "fp32"), ("bf16", "compressed"))
N = 60  # primitives per soup: 64 leaf slots at BVH4 depth 3 and BVH8 depth 2


def _bits(x) -> np.ndarray:
    x = np.asarray(x)
    return x.view(np.int32) if x.dtype == np.float32 else x.astype(np.int64)


def _soup(kind: str) -> np.ndarray:
    """(N, 3 vertices, 3) f32."""
    if kind == "random":
        rng = np.random.default_rng(3)
        ctr = rng.uniform(-5, 5, (N, 1, 3))
        return (ctr + rng.normal(scale=0.4, size=(N, 3, 3))).astype(np.float32)
    if kind == "clustered":
        tri = jclustered_soup(np.random.default_rng(7), n_clusters=4, per_cluster=N // 4)
        return np.stack([np.asarray(v) for v in tri], axis=1)
    if kind == "degenerate":
        rng = np.random.default_rng(5)
        tris = (rng.integers(-64, 64, (N, 3, 3)) / 8.0).astype(np.float32)
        tris[::3] = tris[::3, :1]  # points
        tris[1::3, 2] = 2 * tris[1::3, 1] - tris[1::3, 0]  # colinear
        return tris
    assert kind == "signed_zero"  # a fan of triangles in x = -0.0 and x = +0.0
    rng = np.random.default_rng(11)
    tris = (rng.integers(-8, 8, (N, 3, 3)) / 4.0).astype(np.float32)
    tris[:, :, 0] = np.where(np.arange(N)[:, None] % 2 == 0, -0.0, 0.0)
    tris[::4, 0, 1] = -0.0
    return tris


def _both(tris: np.ndarray):
    jt = JTriangle(*(jnp.asarray(tris[:, i]) for i in range(3)))
    tt = Triangle(*(torch.as_tensor(tris[:, i].copy()) for i in range(3)))
    return jt, tt


def _assert_tree(got, want, what):
    assert got.depth == want.depth, what
    for f in FIELDS:
        np.testing.assert_array_equal(_bits(getattr(got.bvh, f)),
                                      _bits(getattr(want.bvh, f)),
                                      err_msg=f"{what}: {f}")


@pytest.mark.parametrize("arity", [4, 8])
@pytest.mark.parametrize("kind", ["random", "clustered", "degenerate", "signed_zero"])
def test_sah_leaf_perm_and_build_bit_equal(kind, arity):
    jt, tt = _both(_soup(kind))
    jboxes, tboxes = jaabb(jt), aabb_of_triangles(tt)
    np.testing.assert_array_equal(_bits(tboxes.lo), _bits(jboxes.lo))
    np.testing.assert_array_equal(_bits(tboxes.hi), _bits(jboxes.hi))
    depth = {4: 3, 8: 2}[arity]
    got = sah_leaf_perm(tboxes, depth, BINS, arity)
    want = jsah_leaf_perm(jboxes, depth, BINS, arity)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for builder in ("sah", "lbvh"):
        got = build(tt, builder, config=DatapathConfig(arity=arity))
        want = jbuild(jt, builder, config=JConfig(arity=arity))
        assert got.builder == builder and got.config == DatapathConfig(arity=arity)
        _assert_tree(got, want, f"{kind}/{builder}/bvh{arity}")


@pytest.mark.parametrize("codec", CODECS, ids=["_".join(c) for c in CODECS])
def test_sah_under_every_codec_bit_equal(codec):
    jt, tt = _both(_soup("clustered"))
    for arity in (4, 8):
        cfg = dict(arity=arity, precision=codec[0], node_format=codec[1])
        got = build(tt, "sah", config=DatapathConfig(**cfg))
        want = jbuild(jt, "sah", config=JConfig(**cfg))
        _assert_tree(got, want, f"sah {cfg}")


@pytest.mark.parametrize("codec", CODECS, ids=["_".join(c) for c in CODECS])
def test_point_sah_bit_equal(codec):
    rng = np.random.default_rng(9)
    pts = (rng.uniform(-2, 2, (4, 1, 3)) + rng.normal(scale=0.1, size=(4, N // 4, 3))
           ).reshape(-1, 3).astype(np.float32)
    cfg = dict(precision=codec[0], node_format=codec[1])
    for depth in (None,):
        got = build_point_bvh(torch.as_tensor(pts), "sah", depth,
                              config=DatapathConfig(**cfg))
        want = jbuild_point_bvh(jnp.asarray(pts), "sah", depth, config=JConfig(**cfg))
        assert got.builder == "sah"
        _assert_tree(got, want, f"points sah {cfg} depth {depth}")
    # the cores take boxes alone: a point's box is the point itself
    got = sah_leaf_perm(Box(torch.as_tensor(pts), torch.as_tensor(pts)), 3)
    want = jsah_leaf_perm(JBox(jnp.asarray(pts), jnp.asarray(pts)), 3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
