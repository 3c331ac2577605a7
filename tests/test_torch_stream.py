"""The port's unified datapath stream (Table V) held against the JAX
reference.

Inputs are made from a numpy seed and fed to both packages; results are
compared through numpy.  Tolerances, and why:

* The beat forms (``euclidean_partial``, ``angular_partial``,
  ``euclidean_beat``, ``angular_beat``) against the reference's functions
  called eagerly (each ``jnp`` op on its own, so XLA fuses nothing):
  **bit-equal**, reset on and off, with and without masks.
* Whatever is compiled in the reference (the multi-beat forms and
  ``unified_stream`` are ``lax.scan``s) may carry XLA's CPU FMA
  contraction (ROADMAP §3).  Opcode, box_index, is_intersect, tmin,
  triangle_hit and reset_accum are compare/select or single rounded ops:
  **exact** (triangle_hit on the tested draws).  t_num / t_denom: the
  rule the reference holds its own unified kernel to
  (``tests/test_kernels.py``), ``rtol=1e-4, atol=1e-4``.  Accumulators (and the multi-beat forms):
  within ``1e-5`` times the sum of the absolute terms they add (for
  squared distances and norms, the value itself); a contracted FMA skips
  one rounding of at most ``2^-24`` of a partial sum per add.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import datapath as jdp
from repro.core import make_ray as jmake_ray
from repro.core.stream import DatapathJob as JDatapathJob
from repro.core.stream import make_jobs as jmake_jobs
from repro.core.stream import unified_stream_jit as junified_stream
from repro.core.types import Box as JBox
from repro.core.types import DatapathState as JDatapathState
from repro.core.types import Triangle as JTriangle
from repro_torch.convert import datapath_state_from_numpy, jobs_from_numpy
from repro_torch.core import datapath as tdp
from repro_torch.core.stream import make_jobs, unified_stream
from repro_torch.core.types import (OP_ANGULAR, OP_EUCLIDEAN, OP_QUADBOX,
                                    OP_TRIANGLE, DatapathState,
                                    init_datapath_state)
from test_torch_models import one_torch_thread  # noqa: F401  (autouse fixture)

EXACT = ("opcode", "box_index", "is_intersect", "tmin", "triangle_hit",
         "reset_accum")
RTOL_TRI, ATOL_TRI = 1e-4, 1e-4  # the reference's rule for its unified kernel
ACC_RTOL = 1e-5  # of the sum of |terms| an accumulator adds


def _bits(x) -> np.ndarray:
    x = np.asarray(x)
    return x.view(np.int32) if x.dtype == np.float32 else x


def _np(tree):
    """Every leaf of a (nested) record as numpy."""
    if isinstance(tree, (torch.Tensor, jax.Array, np.ndarray)):
        return np.asarray(tree)
    return type(tree)(*(_np(x) for x in tree))


def _jstate(shape):
    z = jnp.zeros(shape, jnp.float32)
    return JDatapathState(z, z, z)


#: the reference's ray setup, jitted (it holds no mul -> add chain, so jit
#: changes no bit), so each job shape compiles once
_jmake_ray = jax.jit(jmake_ray)


def _random_jobs(rng, t, lanes, reset_p=0.3):
    """A reference ``DatapathJob`` of (t, lanes) jobs: random rays, boxes,
    triangles and vectors; random per-beat opcodes; per-lane resets; lane
    masks with holes.  Built in numpy, so no shape compiles an op."""
    n = t * lanes
    org = rng.normal(size=(n, 3)).astype(np.float32)
    dirs = rng.normal(size=(n, 3)).astype(np.float32)
    dirs[rng.uniform(size=(n, 3)) < 0.05] = -0.0
    lo = rng.normal(size=(n, 4, 3)).astype(np.float32)
    hi = lo + rng.uniform(0.1, 2, (n, 4, 3)).astype(np.float32)
    ops = rng.integers(0, 4, size=t).astype(np.int32)
    jobs = JDatapathJob(
        opcode=np.repeat(ops, lanes),
        ray=_np(_jmake_ray(org, dirs)),
        boxes=JBox(lo, hi),
        triangle=JTriangle(*(rng.normal(size=(n, 3)).astype(np.float32)
                             for _ in range(3))),
        vec_a=rng.normal(size=(n, 16)).astype(np.float32),
        vec_b=rng.normal(size=(n, 16)).astype(np.float32),
        mask=rng.random((n, 16)) < 0.7,
        reset_accum=rng.random(n) < reset_p)
    return jax.tree.map(lambda x: jnp.asarray(x.reshape((t, lanes) + x.shape[1:])), jobs)


def _both_streams(jjobs, jstate=None):
    """The same jobs through ``repro``'s and the port's ``unified_stream``
    (state shaped like the lane axes); returns numpy (state, out) pairs."""
    lanes = jjobs.opcode.shape[1:]
    jstate = _jstate(lanes) if jstate is None else jstate
    j_st, j_out = junified_stream(jjobs, jstate)
    t_st, t_out = unified_stream(jobs_from_numpy(_np(jjobs), device="cpu"),
                                 datapath_state_from_numpy(_np(jstate), device="cpu"))
    return (_np(j_st), _np(j_out)), (_np(t_st), _np(t_out))


def _abs_dot_scale(jjobs):
    """The running sum of |q_i c_i| each angular output adds (the port's
    stream on |q|, |c|), the scale of the dot products' tolerance."""
    absj = jobs_from_numpy(_np(jjobs), device="cpu")
    absj = absj._replace(vec_a=absj.vec_a.abs(), vec_b=absj.vec_b.abs())
    return unified_stream(absj)[1].angular_dot_product.numpy()


def _assert_outputs_match(want, got, dot_scale):
    for f in EXACT:
        np.testing.assert_array_equal(_bits(getattr(got, f)), _bits(getattr(want, f)),
                                      err_msg=f)
    for f in ("t_num", "t_denom"):
        np.testing.assert_allclose(getattr(got, f), getattr(want, f),
                                   rtol=RTOL_TRI, atol=ATOL_TRI, err_msg=f)
    for f, scale in (("euclidean_accumulator", np.abs(want.euclidean_accumulator)),
                     ("angular_norm", np.abs(want.angular_norm)),
                     ("angular_dot_product", dot_scale)):
        diff = np.abs(getattr(got, f).astype(np.float64) - getattr(want, f))
        assert np.all(diff <= ACC_RTOL * scale), (f, diff.max())


# ---------------------------------------------------------------------------
# beat forms: bit-equal to the reference's eager functions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("masking", ["none", "prefix", "holes"])
@pytest.mark.parametrize("reset", [False, True])
def test_beat_forms_bit_equal_to_eager_reference(masking, reset):
    rng = np.random.default_rng(7 + 2 * reset + len(masking))
    n = 300
    a = rng.normal(size=(n, 16)).astype(np.float32)
    b = rng.normal(size=(n, 16)).astype(np.float32)
    a[:5] = -1.0  # products of -1 and +0: -0.0 partials under reset
    b[:5] = 0.0
    mask = {"none": None,
            "prefix": np.arange(16)[None] < rng.integers(0, 17, (n, 1)),
            "holes": rng.random((n, 16)) < 0.6}[masking]
    acc = [rng.normal(size=n).astype(np.float32) for _ in range(3)]
    jm = None if mask is None else jnp.asarray(mask)
    tm = None if mask is None else torch.as_tensor(mask)
    ja, jb, ta, tb = jnp.asarray(a), jnp.asarray(b), torch.as_tensor(a), torch.as_tensor(b)

    np.testing.assert_array_equal(_bits(tdp.euclidean_partial(ta, tb, tm)),
                                  _bits(jdp.euclidean_partial(ja, jb, jm)))
    for got, want in zip(tdp.angular_partial(ta, tb, tm), jdp.angular_partial(ja, jb, jm)):
        np.testing.assert_array_equal(_bits(got), _bits(want))

    jst = JDatapathState(*map(jnp.asarray, acc))
    tst = DatapathState(*map(torch.as_tensor, acc))
    for jbeat, tbeat in ((jdp.euclidean_beat, tdp.euclidean_beat),
                         (jdp.angular_beat, tdp.angular_beat)):
        j_st, j_res = jbeat(jst, ja, jb, jm, reset)
        t_st, t_res = tbeat(tst, ta, tb, tm, reset)
        for got, want in zip(list(t_st) + list(t_res), list(j_st) + list(j_res)):
            np.testing.assert_array_equal(_bits(got), _bits(want))
    if reset:  # a -0.0 partial leaves a reset beat as +0.0
        st5 = DatapathState(*(x[:5] for x in tst))
        dot = tdp.angular_beat(st5, ta[:5], tb[:5], None, True)[1].dot_product
        assert bool(torch.signbit(tdp.angular_partial(ta[:5], tb[:5])[0]).all())
        assert not bool(torch.signbit(dot).any())


@jax.jit
def _jmulti_beat(a, b):
    """The reference's two multi-beat forms in one compile per shape."""
    return jdp.euclidean_distance_sq(a, b), jdp.angular_distance_parts(a, b)


@pytest.mark.parametrize("d", [1, 16, 37, 100, 128])
def test_multi_beat_forms_match_reference(d):
    rng = np.random.default_rng(d)
    a = rng.normal(size=(2, 21, d)).astype(np.float32)
    b = rng.normal(size=(2, 21, d)).astype(np.float32)
    ta, tb = torch.as_tensor(a), torch.as_tensor(b)
    got = tdp.euclidean_distance_sq(ta, tb).numpy()
    want, (jdot, jnrm) = jax.tree.map(np.asarray, _jmulti_beat(a, b))
    assert got.shape == want.shape == (2, 21)
    np.testing.assert_allclose(got, want, rtol=ACC_RTOL, atol=0)
    np.testing.assert_allclose(got, ((a.astype(np.float64) - b) ** 2).sum(-1), rtol=1e-5)

    dot, nrm = (x.numpy() for x in tdp.angular_distance_parts(ta, tb))
    abs_dot = (np.abs(a.astype(np.float64)) * np.abs(b)).sum(-1)
    assert np.all(np.abs(dot - jdot.astype(np.float64)) <= ACC_RTOL * abs_dot)
    np.testing.assert_allclose(nrm, jnrm, rtol=ACC_RTOL, atol=0)
    np.testing.assert_allclose(dot, (a.astype(np.float64) * b).sum(-1),
                               atol=1e-5 * abs_dot.max())

    # the same pairs fed beat by beat through the beat form: bit-equal
    st = init_datapath_state((2, 21), device="cpu")
    for j in range(0, d, 16):
        width = min(16, d - j)
        pad = lambda x: torch.nn.functional.pad(x[..., j:j + width], (0, 16 - width))
        live = torch.arange(16) < width
        st, _ = tdp.euclidean_beat(st, pad(ta), pad(tb), live, j == 0)
    np.testing.assert_array_equal(_bits(st.euclid_accum), _bits(got))


# ---------------------------------------------------------------------------
# the stream: Table V cases of tests/test_stream.py, through both packages
# ---------------------------------------------------------------------------


#: every Table V case is padded to this many jobs (trailing box jobs change
#: no earlier output), so the reference's stream compiles once for them all
TABLE_V_JOBS = 6


def _vec_jobs(seq):
    """A single-lane reference job stream from (opcode, a, b, reset) tuples,
    padded with box jobs to ``TABLE_V_JOBS``."""
    seq = list(seq) + [(OP_QUADBOX, [], [], False)] * (TABLE_V_JOBS - len(seq))
    va = np.zeros((TABLE_V_JOBS, 16), np.float32)
    vb = np.zeros((TABLE_V_JOBS, 16), np.float32)
    for i, s in enumerate(seq):
        va[i, :len(s[1])] = s[1]
        vb[i, :len(s[2])] = s[2]
    return _np(jmake_jobs(TABLE_V_JOBS))._replace(
        opcode=np.asarray([s[0] for s in seq], np.int32), vec_a=va, vec_b=vb,
        reset_accum=np.asarray([bool(s[3]) for s in seq]))


TABLE_V = {
    # name: (jobs, [(field, job, expected)])
    "multibeat": ([(OP_EUCLIDEAN, [1.0] * 16, [0.0] * 16, True),
                   (OP_EUCLIDEAN, [2.0] * 16, [0.0] * 16, False)],
                  [("euclidean_accumulator", 0, 16.0), ("euclidean_accumulator", 1, 80.0)]),
    "isolation_interleaved": ([(OP_EUCLIDEAN, [1.0], [0.0], True),
                               (OP_ANGULAR, [3.0], [2.0], True),
                               (OP_QUADBOX, [], [], False),
                               (OP_EUCLIDEAN, [2.0], [0.0], False),
                               (OP_TRIANGLE, [], [], False),
                               (OP_ANGULAR, [1.0], [5.0], False)],
                              [("euclidean_accumulator", 3, 5.0),
                               ("angular_dot_product", 5, 11.0), ("angular_norm", 5, 29.0)]),
    "reset_clears_only_own_mode": ([(OP_EUCLIDEAN, [2.0], [0.0], True),
                                    (OP_ANGULAR, [1.0], [1.0], True),
                                    (OP_ANGULAR, [1.0], [1.0], True),
                                    (OP_EUCLIDEAN, [1.0], [0.0], False)],
                                   [("angular_dot_product", 2, 1.0),
                                    ("euclidean_accumulator", 3, 5.0)]),
    "reset_propagated": ([(OP_EUCLIDEAN, [1.0], [0.0], True),
                          (OP_EUCLIDEAN, [1.0], [0.0], False)],
                         [("reset_accum", 0, True), ("reset_accum", 1, False)]),
    "angular_uses_eight_lanes": ([(OP_ANGULAR, [1.0] * 16, [1.0] * 16, True)],
                                 [("angular_dot_product", 0, 8.0)]),
}


@pytest.mark.parametrize("case", sorted(TABLE_V))
def test_table_v_cases_match_reference(case):
    seq, expected = TABLE_V[case]
    jjobs = _vec_jobs(seq)
    (_, want), (t_st, got) = _both_streams(jjobs)
    _assert_outputs_match(want, got, _abs_dot_scale(jjobs))
    for field, job, value in expected:
        assert getattr(got, field)[job] == value, (field, job)
    assert t_st.euclid_accum.shape == ()


def test_mask_lanes_drop_dead_lanes_in_both():
    jjobs = _vec_jobs([(OP_EUCLIDEAN, [1.0] * 16, [0.0] * 16, True)])
    jjobs = jjobs._replace(mask=np.broadcast_to(np.arange(16) < 5, (TABLE_V_JOBS, 16)))
    (_, want), (_, got) = _both_streams(jjobs)
    assert got.euclidean_accumulator[0] == want.euclidean_accumulator[0] == 5.0


@pytest.mark.parametrize("seed", [0, 1])
def test_mixed_lane_streams_match_reference(seed):
    """Seeded mixed streams over 32 lane-streams: per-lane resets, masks
    with holes, every opcode; every output field of every job."""
    rng = np.random.default_rng(seed)
    jjobs = _random_jobs(rng, 10, 32)
    (j_st, want), (t_st, got) = _both_streams(jjobs)
    _assert_outputs_match(want, got, _abs_dot_scale(jjobs))
    for f in ("euclid_accum", "norm_accum"):
        np.testing.assert_allclose(getattr(t_st, f), getattr(j_st, f), rtol=ACC_RTOL)


def test_state_carries_across_two_calls():
    """Splitting a stream across two calls, state threaded through, gives
    the single call's outputs bit for bit (port), and the reference's."""
    rng = np.random.default_rng(3)
    jjobs = _random_jobs(rng, 20, 32, reset_p=0.1)
    jobs = jobs_from_numpy(_np(jjobs), device="cpu")
    whole = unified_stream(jobs)[1]
    first = jax.tree.map(lambda x: x[:10], jjobs)
    rest = jax.tree.map(lambda x: x[10:], jjobs)
    j_mid, _ = junified_stream(first, _jstate((32,)))
    (_, want), (_, got) = _both_streams(rest, j_mid)
    _assert_outputs_match(want, got, _abs_dot_scale(jjobs)[10:])
    t_mid, _ = unified_stream(jax.tree.map(lambda x: x[:10], jobs))
    t_rest = unified_stream(jax.tree.map(lambda x: x[10:], jobs), t_mid)[1]
    for f, a, b in zip(whole._fields, whole, t_rest):
        np.testing.assert_array_equal(_bits(a[10:]), _bits(b), err_msg=f)


def test_entry_points_default_to_cuda():
    """``make_jobs`` and ``init_datapath_state`` put their tensors on CUDA
    unless asked for the CPU; without a GPU they raise."""
    assert make_jobs(3, device="cpu").opcode.shape == (3,)
    assert init_datapath_state((2,), device="cpu").euclid_accum.shape == (2,)
    if torch.cuda.is_available():
        assert make_jobs(3).vec_a.is_cuda and init_datapath_state().dot_accum.is_cuda
    else:
        for call in (lambda: make_jobs(3), init_datapath_state):
            with pytest.raises(RuntimeError, match="device='cpu'"):
                call()
