"""The traversal kernel's tree layout, held against the reference.

``kernels/traverse.py`` lays a tree out for ``csrc/traverse.cu``'s 16 B
vector loads (``pack_bvh``): one record of child boxes per node above the
leaf parents, no leaf box, and each leaf slot's triangle with its index.
The tests hold it to the reference's operand rows (``pack_bvh_rows``,
which ``tests/test_torch_trace.py`` holds to the reference's own).  On CPU
operands ``traverse_packed`` inverts the layout (``unpack_bvh``) and runs
``trace_wavefront``.  Everything here is exact
but ``t`` against the reference, which is held to ``_t_tolerance``
(``tests/test_torch_trace.py`` says why).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.wavefront import trace_wavefront as jtrace_wavefront
from repro.kernels.traverse import pack_bvh as jpack_bvh
from repro.kernels.traverse import traverse_packed as jtraverse_packed
from repro_torch.api import RAY_TYPES, Scene, make_ray
from repro_torch.convert import config_from_tag
from repro_torch.core.bvh import level_offset, num_nodes
from repro_torch.core.wavefront import trace_wavefront
from repro_torch.kernels.traverse import (SLOT_INDEX, pack_bvh, pack_bvh_rows, traverse_packed,
                                          unpack_bvh)
from test_torch_models import one_torch_thread  # noqa: F401  (autouse fixture)
from test_torch_trace import (_assert_record, _assert_same, _carried, _np,
                              _random_scene)

#: the goldens' three twins, the stack that overflows in ``chip_smoke.py``,
#: a bf16 BVH8 and a stack past the kernel's local array
LAYOUT_TAGS = ("bvh4_s64_fp32_fp32", "bvh8_s64_fp32_fp32", "bvh4_s64_bf16_compressed",
               "bvh4_s16_bf16_fp32", "bvh8_s64_bf16_compressed", "bvh4_s100_fp32_fp32")


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.view(torch.int16) if x.dtype == torch.bfloat16 else x.view(torch.int32)


def _soup(n_tri: int = 40) -> np.ndarray:
    """A random soup with two degenerate triangles (culled from the leaf
    table) and a count that leaves slots empty at both arities."""
    tris, _, _, _ = _random_scene(7, n_tri=n_tri, n_rays=1)
    tris[3] = tris[3, :1]  # a point
    tris[11, 2] = tris[11, 1]  # a segment
    return tris


@pytest.mark.parametrize("tag", LAYOUT_TAGS)
def test_layout_round_trips_to_the_rows(tag):
    config = config_from_tag(tag)
    arity = config.arity
    sc = Scene.from_triangles(_soup(), config=config, device="cpu")
    depth, bvh = sc.depth, sc.bvh
    rows, packed = pack_bvh_rows(bvh, config), pack_bvh(bvh, config)
    n_inner = level_offset(depth - 1, arity)
    n_slots = arity**depth
    assert packed.kids.dtype == rows.nlo.dtype == config.packed_box_dtype
    assert packed.kids.shape == (n_inner, 6 * arity)
    assert packed.slots.shape == (n_slots, 12) and packed.slots.dtype == torch.float32

    # child records: bound b of row (lo.x .. hi.z) of node n is the rows' bound
    # of child arity n + 1 + b, bit for bit (bf16 bits too)
    node, row, b = np.meshgrid(np.arange(n_inner), np.arange(6), np.arange(arity),
                               indexing="ij")
    want = torch.stack([rows.nlo, rows.nhi])[torch.as_tensor(row // 3),
                                             torch.as_tensor(row % 3),
                                             torch.as_tensor(arity * node + 1 + b)]
    assert torch.equal(_bits(packed.kids), _bits(want.reshape(n_inner, 6 * arity)))

    # leaf slots in slot order: the triangle's 9 floats and its index; an
    # empty slot holds zeros and -1
    leaf = bvh.leaf_tri
    index = packed.slots.view(torch.int32)[:, SLOT_INDEX]
    assert torch.equal(index, leaf)
    empty = leaf < 0
    assert 0 < int(empty.sum()) < n_slots
    assert bool((packed.slots[empty][:, :SLOT_INDEX] == 0).all())
    tri = bvh.triangles
    verts = torch.cat([tri.a, tri.b, tri.c], dim=1)[leaf[~empty].long()]
    assert torch.equal(_bits(packed.slots[~empty, :SLOT_INDEX]), _bits(verts))
    assert bool((packed.slots[:, SLOT_INDEX + 1:] == 0).all())

    # back to the rows: every column a record depends on, bit for bit; the
    # root's and the leaves' boxes (not stored) NaN; the soup at every
    # referenced triangle
    back = unpack_bvh(packed, depth, arity)
    assert back.node_lo.shape == (num_nodes(depth, arity), 3)
    again = pack_bvh_rows(back, config)
    kept = 1 + arity * n_inner
    for got, ref in ((again.nlo, rows.nlo), (again.nhi, rows.nhi)):
        assert torch.equal(_bits(got[:, 1:kept]), _bits(ref[:, 1:kept]))
        assert bool(got[:, 0].isnan().all())  # the root's own box: never tested
        assert bool(got[:, kept:num_nodes(depth, arity)].isnan().all())
    assert torch.equal(again.leaf[0, :n_slots], rows.leaf[0, :n_slots])
    used = leaf[~empty].long()
    assert torch.equal(_bits(again.tris[:, used]), _bits(rows.tris[:, used]))
    assert torch.equal(back.leaf_tri, leaf)


@pytest.mark.parametrize("ray_type", RAY_TYPES)
def test_packed_trace_on_the_layout_matches_reference(ray_type):
    """``traverse_packed`` on CPU operands of the kernel's layout equals the
    reference's fused Pallas kernel (interpret mode; the scene and shapes of
    ``test_torch_trace.py``, whose compilations it shares) and the port's
    ``trace_wavefront`` bit for bit, with ``t_min`` and ``max_rounds`` too."""
    tris, org, dirs, ext = _random_scene(0)
    res, jr, tb, tr = _carried(tris, org, dirs, ext)
    got = traverse_packed(pack_bvh(tb), tr, res.depth, ray_type=ray_type)
    assert int(got.hit.sum()) > 10
    want_pl = jtraverse_packed(jpack_bvh(res.bvh), jr, res.depth, ray_type=ray_type,
                               interpret=None)
    _assert_record(_np(got), want_pl, f"pallas/{ray_type}", tris, tr)
    _assert_same(got, trace_wavefront(tb, tr, res.depth, ray_type=ray_type), ray_type)
    for kw in ({"t_min": 4.0}, {"max_rounds": 3}):
        _assert_same(traverse_packed(pack_bvh(tb), tr, res.depth, ray_type=ray_type, **kw),
                     trace_wavefront(tb, tr, res.depth, ray_type=ray_type, **kw), str(kw))


def _nan_leaves(node, depth: int, arity: int):
    """A node-box array (the reference's or the port's) with NaN leaf rows."""
    first = level_offset(depth, arity)
    if isinstance(node, torch.Tensor):
        return torch.cat([node[:first], torch.full_like(node[first:], float("nan"))])
    return node.at[first:].set(jnp.nan)


@pytest.mark.parametrize("tag", ["bvh4_s64_fp32_fp32", "bvh8_s64_fp32_fp32"])
def test_leaf_boxes_never_matter(tag):
    """No record depends on a leaf parent's box test: the reference's and the
    port's ``trace_wavefront`` give the same record, bit for bit, on a tree
    whose leaf boxes are NaN, so the kernel's layout stores none.  (The
    reference traces BVH4 without a config, as ``test_torch_trace.py`` does
    at these shapes, and BVH8 closest rays only: one compilation each.)"""
    from repro.api import Scene as JScene
    from repro.core import bvh as jbvh
    from repro.core import make_ray as jmake_ray

    config = config_from_tag(tag)
    arity = config.arity
    tris, org, dirs, ext = _random_scene(1)
    jcfg = None if arity == 4 else jbvh.DatapathConfig(*config)
    js = JScene.from_triangles(tris, config=jcfg)
    jr = jmake_ray(jnp.asarray(org), jnp.asarray(dirs), extent=jnp.asarray(ext))
    sc = Scene.from_triangles(tris, config=config, device="cpu")
    rays = make_ray(org, dirs, ext, device="cpu")
    depth = sc.depth
    jblind = js.bvh._replace(node_lo=_nan_leaves(js.bvh.node_lo, depth, arity),
                             node_hi=_nan_leaves(js.bvh.node_hi, depth, arity))
    blind = sc.bvh._replace(node_lo=_nan_leaves(sc.bvh.node_lo, depth, arity),
                            node_hi=_nan_leaves(sc.bvh.node_hi, depth, arity))
    for ray_type in RAY_TYPES if arity == 4 else ("closest",):
        want = jtrace_wavefront(js.bvh, jr, depth, ray_type=ray_type, config=jcfg)
        got = jtrace_wavefront(jblind, jr, depth, ray_type=ray_type, config=jcfg)
        assert int(np.asarray(want.hit).sum()) > 10
        for f in want._fields:
            x, y = np.asarray(getattr(got, f)), np.asarray(getattr(want, f))
            np.testing.assert_array_equal(x.view(np.int32) if x.dtype == np.float32 else x,
                                          y.view(np.int32) if y.dtype == np.float32 else y,
                                          err_msg=f"{ray_type}: {f}")
    for ray_type in RAY_TYPES:
        want = trace_wavefront(sc.bvh, rays, depth, ray_type=ray_type, config=config)
        _assert_same(trace_wavefront(blind, rays, depth, ray_type=ray_type, config=config),
                     want, ray_type)
        _assert_same(traverse_packed(pack_bvh(sc.bvh, config), rays, depth,
                                     ray_type=ray_type, config=config), want, ray_type)


@pytest.mark.parametrize("tag", ["bvh4_s64_fp32_fp32", "bvh8_s64_bf16_compressed"])
def test_a_tree_whose_root_is_the_leaf_parent(tag):
    """A soup that fits one leaf parent: the layout holds no child record
    (the root is pre-pushed, its box never tested), every slot in the
    leaf table's order, and ``traverse_packed`` on it traces as
    ``trace_wavefront`` on the tree, for every ray type."""
    config = config_from_tag(tag)
    tris, org, dirs, ext = _random_scene(2, n_tri=3, n_rays=64)
    sc = Scene.from_triangles(tris, config=config, device="cpu")
    rays = make_ray(org, dirs, ext, device="cpu")
    assert sc.depth == 1
    packed = pack_bvh(sc.bvh, config)
    assert packed.kids.shape == (0, 6 * config.arity)
    assert packed.kids.dtype == config.packed_box_dtype
    assert torch.equal(packed.slots.view(torch.int32)[:, SLOT_INDEX], sc.bvh.leaf_tri)
    for ray_type in RAY_TYPES:
        want = trace_wavefront(sc.bvh, rays, 1, ray_type=ray_type, config=config)
        if ray_type == "closest":
            assert int(want.hit.sum()) > 0
        _assert_same(traverse_packed(packed, rays, 1, ray_type=ray_type, config=config),
                     want, ray_type)
