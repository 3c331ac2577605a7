"""The port's stage units and ray setup held against the JAX reference.

Inputs are made from a numpy seed and fed to both packages; results are
compared through numpy.  Tolerances, and why:

* ``make_ray``, the comparators, the sort network and OpQuadbox are
  compare/select plus single rounded ops: **bit-equal**, against both the
  reference's plain function (eager, or jitted: with no mul -> add chain
  there is nothing for XLA to contract) and its Pallas kernel (interpret
  mode).
* OpTriangle against the reference's plain function called eagerly (each
  ``jnp`` op dispatched on its own, so XLA fuses nothing): **bit-equal**.
* OpTriangle against the reference's Pallas kernel in interpret mode (and
  its jitted function): XLA on the CPU contracts mul -> add into FMAs
  there (``repro/kernels/common.py: round_stage``), and under cancellation
  an edge function moves by hundreds of ulps, so no ulp rule holds.  The
  test uses the reference's own rule for its kernel
  (``tests/test_kernels.py``: ``rtol=1e-4, atol=1e-5``) for ``t_num`` and
  ``t_denom``, and holds ``hit`` exact except where an edge function or
  ``t_num`` lies within that contraction error of 0 (checked in f64).
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import Box as JBox
from repro.core import Triangle as JTriangle
from repro.core import make_ray as jmake_ray
from repro.core import datapath as jdp
from repro.kernels.raybox import raybox_pallas
from repro.kernels.raytri import raytri_pallas
from repro_torch.core import datapath as tdp
from repro_torch.core.types import Box, Triangle, make_ray
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.raybox import raybox
from repro_torch.kernels.raytri import raytri
from test_torch_models import one_torch_thread  # noqa: F401  (autouse fixture)

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
SIZES = [1, 128, 300]  # one job, an exact lane multiple, a ragged tail
#: every Pallas comparison pads its jobs to this many columns, so the
#: interpret-mode kernels compile once per process, not once per size
PALLAS_COLS = 384


def _bits(x) -> np.ndarray:
    """Exact bit pattern (so -0.0 != +0.0 and inf/NaN compare by bits)."""
    x = np.asarray(x)
    if x.dtype == np.float32:
        return x.view(np.int32)
    return x.astype(np.int64)


def _assert_bit_equal(got, want, what=""):
    np.testing.assert_array_equal(_bits(got), _bits(want), err_msg=what)


def _t(x) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x))


def _rays_np(rng, n, zeros=True):
    org = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    dirs = rng.normal(size=(n, 3)).astype(np.float32)
    if zeros:
        z = rng.uniform(size=(n, 3))
        dirs[z < 0.1] = 0.0
        dirs[(z >= 0.1) & (z < 0.2)] = -0.0
        dirs[np.all(dirs == 0, axis=1)] = (0.0, -0.0, 1.0)
    return org, dirs


#: the reference's ray setup and box test, jitted: they hold no mul -> add
#: chain for XLA to contract, so jit changes no bit, and compiles faster
#: per size than the op-by-op eager path
_jmake_ray_jit = jax.jit(jmake_ray)
_jray_box_jit = jax.jit(jdp.ray_box_test)


def _both_rays(org, dirs, extent=None, eager=False):
    setup = jmake_ray if eager else _jmake_ray_jit
    jr = setup(jnp.asarray(org), jnp.asarray(dirs),
               extent=None if extent is None else jnp.asarray(extent))
    tr = make_ray(org, dirs, extent, device="cpu")
    return jr, tr


def _pad(x, value=0.0):
    x = jnp.asarray(x, jnp.float32)
    return jnp.pad(x, ((0, 0), (0, PALLAS_COLS - x.shape[1])),
                   constant_values=value)


def _pallas_ray_box(jr, lo, hi):
    """The reference's OpQuadbox Pallas kernel (interpret mode) as records,
    packed as ``repro.kernels.ops.ray_box_kernel`` packs them."""
    n = lo.shape[0]
    tmin, idx, hit = raybox_pallas(
        _pad(jr.origin.T), _pad(jr.inv.T, 1.0),
        _pad(jnp.signbit(jr.direction).astype(jnp.float32).T),
        _pad(lo.reshape(n, 12).T), _pad(hi.reshape(n, 12).T))
    return (np.asarray(tmin).T[:n], np.asarray(idx).T[:n],
            np.asarray(hit).T[:n].astype(bool))


def _pallas_ray_triangle(jr, a, b, c):
    """The reference's OpTriangle Pallas kernel (interpret mode) as arrays,
    packed as ``repro.kernels.ops.ray_triangle_kernel`` packs them."""
    n = a.shape[0]
    k = jnp.stack([jr.kx, jr.ky, jr.kz]).astype(jnp.float32)
    t_num, t_denom, hit = raytri_pallas(
        _pad(jr.origin.T), _pad(jr.shear.T, 1.0), _pad(k),
        _pad(a.T), _pad(b.T), _pad(c.T))
    return (np.asarray(t_num)[0, :n], np.asarray(t_denom)[0, :n],
            np.asarray(hit)[0, :n].astype(bool))


def test_make_ray_bit_equal_on_zero_and_tied_directions():
    rng = np.random.default_rng(0)
    special = np.asarray([
        [1, 1, 1], [-1, 1, -1], [1, -1, 1], [2, 2, -1], [-3, 1, 3],
        [0.0, 0.0, 1.0], [0.0, -0.0, -1.0], [-0.0, 2.0, -2.0],
        [0.0, 1.0, 1.0], [-0.0, -1.0, 1.0], [5.0, -0.0, 0.0],
        [1e-30, -1e-30, 1e-30], [0.5, -0.5, 0.25]], np.float32)
    org, dirs = _rays_np(rng, 200)
    dirs = np.concatenate([special, dirs]).astype(np.float32)
    org = rng.uniform(-2, 2, dirs.shape).astype(np.float32)
    extent = rng.uniform(0.5, 9.0, dirs.shape[0]).astype(np.float32)
    for ext, eager in ((None, True), (extent, True), (extent, False)):
        jr, tr = _both_rays(org, dirs, ext, eager)
        for f, a, b in zip(jr._fields, jr, tr):
            _assert_bit_equal(b.numpy(), a, f)


def test_comparators_keep_second_operand_on_nan():
    a = np.asarray([np.nan, 1.0, -np.inf, 2.0, np.nan, 0.0, -0.0], np.float32)
    b = np.asarray([3.0, np.nan, 1.0, 2.0, np.nan, -0.0, 0.0], np.float32)
    ja, jb, ta, tb = jnp.asarray(a), jnp.asarray(b), _t(a), _t(b)
    _assert_bit_equal(tdp.fmax(ta, tb).numpy(), jdp.fmax(ja, jb))
    _assert_bit_equal(tdp.fmin(ta, tb).numpy(), jdp.fmin(ja, jb))
    for x, y in zip(tdp.cmp_select(ta, tb), jdp.cmp_select(ja, jb)):
        _assert_bit_equal(x.numpy(), y)
    # never torch.maximum: the NaN in slot 0 must not propagate
    assert tdp.fmax(ta, tb)[0].item() == 3.0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quadsort_bit_equal_with_ties(seed):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 3, (500, 4)).astype(np.float32)  # many ties
    keys[rng.uniform(size=keys.shape) < 0.1] = np.inf
    idx = np.broadcast_to(np.arange(4, dtype=np.int32), keys.shape).copy()
    pay = rng.integers(0, 2, keys.shape).astype(np.int32)
    want = jdp.quadsort(jnp.asarray(keys), jnp.asarray(idx), jnp.asarray(pay))
    got = tdp.quadsort(_t(keys), _t(idx), _t(pay))
    for g, w in zip(got, want):
        _assert_bit_equal(g.numpy(), w)
    assert tdp.SORT_NETWORKS[4] == jdp.SORT_NETWORKS[4]


def _boxes_np(rng, org, dirs):
    n = org.shape[0]
    lo = rng.uniform(-3, 2, (n, 4, 3)).astype(np.float32)
    hi = (lo + rng.uniform(0, 3, (n, 4, 3))).astype(np.float32)
    # planes through the origin on zero-direction axes: 0 * inf slabs
    slab = (rng.uniform(size=(n, 4, 3)) < 0.3) & (dirs[:, None, :] == 0)
    lo = np.where(slab, org[:, None, :], lo).astype(np.float32)
    hi = np.where(slab & (rng.uniform(size=(n, 4, 3)) < 0.5),
                  org[:, None, :], hi).astype(np.float32)
    return lo, hi


@pytest.mark.parametrize("n", SIZES)
def test_ray_box_bit_equal_to_reference_and_pallas(n):
    rng = np.random.default_rng(10 + n)
    org, dirs = _rays_np(rng, n)
    lo, hi = _boxes_np(rng, org, dirs)
    jr, tr = _both_rays(org, dirs)
    jb, tb = JBox(jnp.asarray(lo), jnp.asarray(hi)), Box(_t(lo), _t(hi))
    got = tdp.ray_box_test(tr, tb)
    for want in (_jray_box_jit(jr, jb), _pallas_ray_box(jr, lo, hi)):
        for f, g, w in zip(got._fields, got, want):
            _assert_bit_equal(g.numpy(), w, f)
    # the port's own kernel wrapper (plain path on CPU) and oracle agree
    for g, k, r in zip(got, tops.ray_box_kernel(tr, tb), tref.ray_box_ref(tr, tb)):
        _assert_bit_equal(k.numpy(), g.numpy())
        _assert_bit_equal(r.numpy(), g.numpy())


def test_ray_box_sheet_scene_zero_times_inf_slabs():
    """Rays in the sheet scene's plane (z = 0, dir_z = +-0) against its flat
    boxes: (lo_z - org_z) * inv_z is 0 * inf = NaN, which the comparator
    trees must drop exactly as the reference drops them."""
    data = np.load(os.path.join(GOLDEN, "sheet.npz"))
    tris = data["tris"]
    lo3, hi3 = tris.min(axis=1), tris.max(axis=1)  # (32, 3) flat boxes
    rng = np.random.default_rng(7)
    n = 96
    pick = rng.integers(0, tris.shape[0], (n, 4))
    lo, hi = lo3[pick], hi3[pick]
    org = np.concatenate([rng.uniform(-3, 3, (n, 2)),
                          np.zeros((n, 1))], axis=1).astype(np.float32)
    dirs = np.concatenate([rng.normal(size=(n, 2)),
                           np.where(rng.uniform(size=(n, 1)) < 0.5, 0.0, -0.0)],
                          axis=1).astype(np.float32)
    jr, tr = _both_rays(org, dirs)
    with np.errstate(invalid="ignore"):
        nan_slabs = np.isnan((lo - org[:, None]) * np.asarray(jr.inv)[:, None])
    assert nan_slabs[..., 2].all()
    got = tdp.ray_box_test(tr, Box(_t(lo), _t(hi)))
    jb = JBox(jnp.asarray(lo), jnp.asarray(hi))
    for want in (_jray_box_jit(jr, jb), _pallas_ray_box(jr, lo, hi)):
        for f, g, w in zip(got._fields, got, want):
            _assert_bit_equal(g.numpy(), w, f)
    assert got.is_intersect.any() and not got.is_intersect.all()


def _tri_np(rng, n):
    return [rng.normal(size=(n, 3)).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("n", SIZES)
def test_ray_triangle_bit_equal_to_eager_reference(n):
    rng = np.random.default_rng(100 + n)
    org, dirs = _rays_np(rng, n, zeros=False)
    a, b, c = _tri_np(rng, n)
    jr, tr = _both_rays(org, dirs, eager=True)
    want = jdp.ray_triangle_test(jr, JTriangle(*map(jnp.asarray, (a, b, c))))
    got = tdp.ray_triangle_test(tr, Triangle(_t(a), _t(b), _t(c)))
    for f, g, w in zip(got._fields, got, want):
        _assert_bit_equal(g.numpy(), w, f)
    for k in (tops.ray_triangle_kernel(tr, Triangle(_t(a), _t(b), _t(c))),
              tref.ray_triangle_ref(tr, Triangle(_t(a), _t(b), _t(c)))):
        for g, w in zip(got, k):
            _assert_bit_equal(w.numpy(), g.numpy())


def _edge_margin(org, dirs, a, b, c, jr):
    """min over |u|, |v|, |w|, |t_num| of each job, each divided by the
    magnitude of the products it is made of (f64): how close a job's hit
    decision sits to a sign flip."""
    kx, ky, kz = (np.asarray(jr.kx), np.asarray(jr.ky), np.asarray(jr.kz))
    s = np.asarray(jr.shear).astype(np.float64)
    rows = np.arange(org.shape[0])

    def shear(v):
        v = (v - org).astype(np.float64)
        vz = v[rows, kz]
        return v[rows, kx] - s[:, 0] * vz, v[rows, ky] - s[:, 1] * vz, s[:, 2] * vz

    (ax, ay, az), (bx, by, bz), (cx, cy, cz) = shear(a), shear(b), shear(c)
    terms = [(cx * by, cy * bx), (ax * cy, ay * cx), (bx * ay, by * ax)]
    edges = [p - q for p, q in terms]
    margins = [np.abs(e) / np.maximum(np.abs(p) + np.abs(q), 1e-30)
               for e, (p, q) in zip(edges, terms)]
    zs = [edges[0] * az, edges[1] * bz, edges[2] * cz]
    t_num = zs[0] + zs[1] + zs[2]
    margins.append(np.abs(t_num) / np.maximum(sum(np.abs(z) for z in zs), 1e-30))
    return np.minimum.reduce(margins)


@pytest.mark.parametrize("n", SIZES)
def test_ray_triangle_vs_pallas_interpret_within_fma_rule(n):
    rng = np.random.default_rng(200 + n)
    org, dirs = _rays_np(rng, n, zeros=False)
    a, b, c = _tri_np(rng, n)
    jr, tr = _both_rays(org, dirs)
    jt = JTriangle(*map(jnp.asarray, (a, b, c)))
    got = tdp.ray_triangle_test(tr, Triangle(_t(a), _t(b), _t(c)))
    margin = _edge_margin(org, dirs, a, b, c, jr)
    for want in (_pallas_ray_triangle(jr, a, b, c),
                 jax.jit(jdp.ray_triangle_test)(jr, jt)):
        np.testing.assert_allclose(got.t_num.numpy(), np.asarray(want[0]),
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(got.t_denom.numpy(), np.asarray(want[1]),
                                   rtol=1e-4, atol=1e-5)
        flips = got.hit.numpy() != np.asarray(want[2])
        assert (margin[flips] < 1e-5).all(), (
            f"hit differs away from a sign flip: margins {margin[flips]}")


def test_stage_wrappers_take_the_plain_path_on_cpu_tensors():
    rng = np.random.default_rng(3)
    n = 130
    org, dirs = _rays_np(rng, n)
    lo, hi = _boxes_np(rng, org, dirs)
    tr = make_ray(org, dirs, device="cpu")
    neg = torch.signbit(tr.direction).float().T.contiguous()
    tmin, idx, hit = raybox(tr.origin.T.contiguous(), tr.inv.T.contiguous(), neg,
                            _t(lo.reshape(n, 12).T.copy()),
                            _t(hi.reshape(n, 12).T.copy()))
    want = tdp.ray_box_test(tr, Box(_t(lo), _t(hi)))
    _assert_bit_equal(tmin.T.numpy(), want.tmin.numpy())
    _assert_bit_equal(idx.T.numpy(), want.box_index.numpy())
    np.testing.assert_array_equal(hit.T.numpy().astype(bool),
                                  want.is_intersect.numpy())
    a, b, c = _tri_np(rng, n)
    k = torch.stack([tr.kx, tr.ky, tr.kz]).contiguous()
    t_num, t_denom, thit = raytri(tr.origin.T.contiguous(), tr.shear.T.contiguous(),
                                  k, _t(a.T.copy()), _t(b.T.copy()), _t(c.T.copy()))
    want = tdp.ray_triangle_test(tr, Triangle(_t(a), _t(b), _t(c)))
    _assert_bit_equal(t_num.numpy(), want.t_num.numpy())
    _assert_bit_equal(t_denom.numpy(), want.t_denom.numpy())
    np.testing.assert_array_equal(thit.numpy().astype(bool), want.hit.numpy())


def test_importing_the_port_loads_neither_jax_nor_repro():
    code = ("import sys\n"
            "import repro_torch, repro_torch.api, repro_torch.convert\n"
            "import repro_torch.kernels.ops, repro_torch.kernels.traverse\n"
            "import repro_torch.kernels.nvcc, repro_torch.core.build.quality\n"
            "import repro_torch.models, repro_torch.configs\n"
            "import repro_torch.serving.engine, repro_torch.launch.serve\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or"
            " m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
            "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": os.path.join(
                             os.path.dirname(GOLDEN), "..", "src")})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout


def test_entry_points_raise_without_gpu_unless_cpu_requested():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    from repro_torch.api import Scene
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_ray(np.zeros((2, 3)), np.ones((2, 3)))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Scene.from_triangles(np.zeros((1, 3, 3), np.float32) + np.eye(3))
    make_ray(np.zeros((2, 3)), np.ones((2, 3)), device="cpu")
