"""The port's unified-stream kernel path (``pack_unified`` ->
``kernels.unified`` -> ``unpack_unified``) held against the JAX
reference's, whose Pallas kernel runs in interpret mode here, as
``tests/test_kernels.py`` runs it.

On the CPU the port's wrapper runs its plain version, ``unified_plain``;
on the card the kernel is held bit-equal to that (``tests/
test_torch_cuda.py``).  Tolerances, and why:

* Packing is data movement and selects: **bit-equal**, all 48 rows.
* Output rows: the box rows, the triangle hit row, the reset row and every
  row an opcode does not write (zero) are **exact** (the hit row on the
  tested draws).  t_num / t_denom: the rule the reference holds its own
  unified kernel to (``tests/test_kernels.py``), ``rtol=1e-4, atol=1e-4``
  (XLA's CPU FMA contraction in the interpreted kernel body, ROADMAP §3).  The
  accumulators: within ``1e-5`` times the sum of the absolute terms they
  add, for the same reason.
* The port's in-order oracle ``unified_ref`` and its kernel path are the
  same arithmetic: **bit-equal** on every valid field, for prefix masks.

Every stream here is 12 beats of 128 lane-streams, so the interpret-mode
kernel compiles once per process.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import make_ray as jmake_ray
from repro.core.stream import DatapathJob as JDatapathJob
from repro.core.stream import unified_stream_jit as junified_stream
from repro.core.types import Box as JBox
from repro.core.types import DatapathState as JDatapathState
from repro.core.types import Triangle as JTriangle
from repro.kernels import ops as jops
from repro.kernels.unified import unified_pallas
from repro_torch.convert import jobs_from_numpy
from repro_torch.core.stream import unified_stream
from repro_torch.core.types import OP_ANGULAR, OP_EUCLIDEAN, OP_QUADBOX, OP_TRIANGLE
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.common import LANES, N_OUTPUT_ROWS, ROW_VEC_A, ROW_VEC_B
from repro_torch.kernels.unified import unified, unified_plain
from test_torch_models import one_torch_thread  # noqa: F401  (autouse fixture)

T = 12  # beats of every stream here
RTOL_TRI, ATOL_TRI = 1e-4, 1e-4  # the reference's rule for its unified kernel
ACC_RTOL = 1e-5
#: output rows each opcode writes; exact ones, and tolerant ones
WRITES = {OP_TRIANGLE: ({2}, {0, 1}), OP_QUADBOX: (set(range(12)), set()),
          OP_EUCLIDEAN: ({12}, {0}), OP_ANGULAR: ({12}, {0, 1})}
VALID = {"tmin": OP_QUADBOX, "box_index": OP_QUADBOX, "is_intersect": OP_QUADBOX,
         "t_num": OP_TRIANGLE, "t_denom": OP_TRIANGLE, "triangle_hit": OP_TRIANGLE,
         "euclidean_accumulator": OP_EUCLIDEAN, "angular_dot_product": OP_ANGULAR,
         "angular_norm": OP_ANGULAR}

_jmake_ray = jax.jit(jmake_ray)


def _bits(x) -> np.ndarray:
    x = np.asarray(x)
    return x.view(np.int32) if x.dtype == np.float32 else x


def _np(tree):
    if isinstance(tree, (torch.Tensor, jax.Array, np.ndarray)):
        return np.asarray(tree)
    return type(tree)(*(_np(x) for x in tree))


def _jobs(rng, ops, holes=True, reset_p=0.3):
    """(T, 128) reference jobs with per-beat opcodes ``ops`` (numpy), random
    operands, per-lane resets and lane masks with holes (or prefixes)."""
    n = T * LANES
    org = rng.normal(size=(n, 3)).astype(np.float32)
    dirs = rng.normal(size=(n, 3)).astype(np.float32)
    dirs[rng.uniform(size=(n, 3)) < 0.05] = -0.0
    lo = rng.normal(size=(n, 4, 3)).astype(np.float32)
    hi = lo + rng.uniform(0.1, 2, (n, 4, 3)).astype(np.float32)
    if holes:
        mask = rng.random((n, 16)) < 0.7
    else:
        mask = np.arange(16)[None] < rng.integers(0, 17, size=(n, 1))
    jobs = JDatapathJob(
        opcode=np.repeat(np.asarray(ops, np.int32), LANES),
        ray=_np(_jmake_ray(org, dirs)),
        boxes=JBox(lo, hi),
        triangle=JTriangle(*(rng.normal(size=(n, 3)).astype(np.float32)
                             for _ in range(3))),
        vec_a=rng.normal(size=(n, 16)).astype(np.float32),
        vec_b=rng.normal(size=(n, 16)).astype(np.float32),
        mask=mask, reset_accum=rng.random(n) < reset_p)
    return jax.tree.map(lambda x: x.reshape((T, LANES) + x.shape[1:]), jobs)


def _mixed_ops(rng):
    ops = rng.integers(0, 4, size=T)
    ops[:4] = rng.permutation(4)  # every opcode at least once
    return ops


def _port(jobs):
    return jobs_from_numpy(jobs, device="cpu")


def _dot_scale(opcodes, operands):
    """Per column, the running sum of |q_i c_i| an angular output adds."""
    absolute = operands.clone()
    absolute[ROW_VEC_A:ROW_VEC_B + 16] = absolute[ROW_VEC_A:ROW_VEC_B + 16].abs()
    return unified_plain(opcodes, absolute)[0].numpy()


@pytest.mark.parametrize("holes", [False, True])
def test_pack_unified_bit_equal_to_reference(holes):
    rng = np.random.default_rng(1 + holes)
    ops = _mixed_ops(rng)
    ops[5], ops[6] = -1, 4  # out-of-range opcodes pack as the reference packs them
    jobs = _jobs(rng, ops, holes)
    j_ops, j_operands = jops.pack_unified(jax.tree.map(jnp.asarray, jobs))
    t_ops, t_operands = tops.pack_unified(_port(jobs))
    np.testing.assert_array_equal(t_ops.numpy(), np.asarray(j_ops))
    assert t_operands.shape == (48, T * LANES)
    np.testing.assert_array_equal(_bits(t_operands), _bits(j_operands))


@pytest.mark.parametrize("seed", [3, 4])
def test_unified_matches_reference_kernel_row_by_row(seed):
    """Raw (16, T*128) outputs of the port's wrapper (plain on the CPU) and
    the reference's Pallas kernel (interpret) on the same packed stream,
    every row of every beat; opcodes above 3 clamp to OpAngular in both."""
    rng = np.random.default_rng(seed)
    ops = _mixed_ops(rng)
    ops[7], ops[8] = 5, 9
    t_ops, t_operands = tops.pack_unified(_port(_jobs(rng, ops)))
    want = np.asarray(unified_pallas(jnp.asarray(t_ops.numpy()),
                                     jnp.asarray(t_operands.numpy())))
    got = unified(t_ops, t_operands).numpy()
    assert got.shape == want.shape == (N_OUTPUT_ROWS, T * LANES)
    scale = {0: _dot_scale(t_ops, t_operands)}
    for beat, op in enumerate(np.clip(ops, 0, 3)):
        cols = slice(beat * LANES, (beat + 1) * LANES)
        exact, tolerant = WRITES[op]
        for r in range(N_OUTPUT_ROWS):
            g, w = got[r, cols], want[r, cols]
            if r in tolerant and op == OP_TRIANGLE:
                np.testing.assert_allclose(g, w, rtol=RTOL_TRI, atol=ATOL_TRI)
            elif r in tolerant:
                s = scale[0][cols] if (op, r) == (OP_ANGULAR, 0) else np.abs(w)
                assert np.all(np.abs(g.astype(np.float64) - w) <= ACC_RTOL * s), (beat, r)
            else:  # exact, or unwritten and zero in both
                np.testing.assert_array_equal(_bits(g), _bits(w), err_msg=f"{beat} {r}")
                if r not in exact:
                    assert not np.any(_bits(g)), (beat, r)


def test_unified_datapath_matches_reference_records():
    rng = np.random.default_rng(5)
    ops = _mixed_ops(rng)
    jobs = _jobs(rng, ops)
    want = _np(jops.unified_datapath(jax.tree.map(jnp.asarray, jobs)))
    got = _np(tops.unified_datapath(_port(jobs)))
    for f in ("opcode", "reset_accum"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    op = want.opcode
    for f, valid in VALID.items():
        g, w = getattr(got, f)[op == valid], getattr(want, f)[op == valid]
        assert g.dtype == w.dtype, f
        if f in ("t_num", "t_denom"):
            np.testing.assert_allclose(g, w, rtol=RTOL_TRI, atol=ATOL_TRI)
        elif f in ("euclidean_accumulator", "angular_norm"):
            np.testing.assert_allclose(g, w, rtol=ACC_RTOL, atol=0)
        elif f != "angular_dot_product":  # held row by row above
            np.testing.assert_array_equal(_bits(g), _bits(w), err_msg=f)


def test_accumulator_across_tiles():
    """Beats of one long Euclidean job land in the same lane across beats."""
    rng = np.random.default_rng(10)
    jobs = _jobs(rng, np.full(T, OP_EUCLIDEAN), holes=False)
    reset = np.zeros((T, LANES), bool)
    reset[0] = True
    jobs = jobs._replace(reset_accum=reset, mask=np.ones((T, LANES, 16), bool))
    got = tops.unified_datapath(_port(jobs)).euclidean_accumulator.numpy()
    want = np.asarray(jops.unified_datapath(jax.tree.map(jnp.asarray, jobs))
                      .euclidean_accumulator)
    np.testing.assert_allclose(got, want, rtol=ACC_RTOL, atol=0)
    exact = ((jobs.vec_a.astype(np.float64) - jobs.vec_b) ** 2).sum(-1).cumsum(axis=0)
    np.testing.assert_allclose(got, exact, rtol=1e-5)


def test_unified_ref_equals_unified_datapath_on_prefix_masks():
    rng = np.random.default_rng(6)
    jobs = _port(_jobs(rng, _mixed_ops(rng), holes=False))
    want = tref.unified_ref(jobs)
    got = tops.unified_datapath(jobs)
    op = want.opcode
    np.testing.assert_array_equal(got.opcode, op)
    for f, valid in VALID.items():
        np.testing.assert_array_equal(_bits(getattr(got, f)[op == valid]),
                                      _bits(getattr(want, f)[op == valid]), err_msg=f)
    vec = op >= OP_EUCLIDEAN
    np.testing.assert_array_equal(got.reset_accum[vec], want.reset_accum[vec])


def _vector_stream(op, a, b, mask, reset):
    """All-``op`` (T, 128) jobs of zero vectors but lane-stream 0's first
    beat: vectors ``a``, ``b``, lane mask ``mask``, reset ``reset``."""
    jobs = _jobs(np.random.default_rng(0), np.full(T, op), reset_p=0.0)
    va, vb = np.zeros((T, LANES, 16), np.float32), np.zeros((T, LANES, 16), np.float32)
    va[0, 0], vb[0, 0] = a, b
    m = np.ones((T, LANES, 16), bool)
    m[0, 0] = mask
    r = np.zeros((T, LANES), bool)
    r[0, 0] = reset
    return jobs._replace(vec_a=va, vec_b=vb, mask=m, reset_accum=r)


def _all_four(jobs, field):
    """Lane-stream 0's first output ``field`` through the kernel path and
    the in-order stream, in both packages."""
    jj = jax.tree.map(jnp.asarray, jobs)
    z = jnp.zeros((LANES,), jnp.float32)
    return {
        "repro datapath": getattr(jops.unified_datapath(jj), field),
        "port datapath": getattr(tops.unified_datapath(_port(jobs)), field),
        "repro stream": getattr(junified_stream(jj, JDatapathState(z, z, z))[1], field),
        "port stream": getattr(unified_stream(_port(jobs))[1], field),
    }


def test_mask_is_a_count_in_the_kernel_path_and_a_bitmask_in_the_stream():
    """A mask with holes (lanes 0 and 2 live) counts as its prefix (lanes 0
    and 1) through ``unified_datapath``, and as itself through
    ``unified_stream``, in the reference as in the port."""
    a = np.zeros(16, np.float32)
    a[:3] = (1.0, 2.0, 4.0)
    mask = np.zeros(16, bool)
    mask[[0, 2]] = True
    out = _all_four(_vector_stream(OP_EUCLIDEAN, a, np.zeros(16), mask, True),
                    "euclidean_accumulator")
    got = {k: float(np.asarray(v)[0, 0]) for k, v in out.items()}
    assert got == {"repro datapath": 5.0, "port datapath": 5.0,
                   "repro stream": 17.0, "port stream": 17.0}


@pytest.mark.parametrize("reset", [False, True])
def test_negative_zero_dot_partial_leaves_as_positive_zero(reset):
    """q = -1, c = +0 on all 8 live lanes: every product is -0.0, so is the
    dot partial; the first beat (reset, or accumulators at power-up) adds
    +0.0 and both packages give +0.0, bit for bit."""
    out = _all_four(_vector_stream(OP_ANGULAR, -np.ones(16), np.zeros(16),
                                   np.ones(16, bool), reset), "angular_dot_product")
    for name, v in out.items():
        assert _bits(np.asarray(v)[0, 0]) == 0, name  # +0.0, not -0.0 (0x80000000)


def test_unified_rejects_malformed_operands():
    ops = torch.zeros(3, dtype=torch.int32)
    with pytest.raises(ValueError, match="operands"):
        unified(ops, torch.zeros(48, 2 * LANES))
    with pytest.raises(ValueError, match="opcodes"):
        unified(ops[None], torch.zeros(48, 3 * LANES))
    assert unified(ops[:0], torch.zeros(48, 0)).shape == (16, 0)
