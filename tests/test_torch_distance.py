"""The distance kernel's 3xTF32 arithmetic, modelled in plain PyTorch and held
against the plain version and the JAX reference.

``csrc/distance.cu`` runs on the tensor cores: each f32 operand is split as
``x = hi + lo`` (``hi`` rounded to TF32 to nearest, ties away from zero;
``lo = x - hi``), and ``q.c`` is ``hi.hi + (hi.lo + lo.hi)`` with ``lo``
truncated to TF32.  A CUDA kernel cannot run here, so these tests hold its
model (``kernels.distance.split_tf32`` / ``distance_3xtf32``) to the
arithmetic it claims.  Tolerances, and why:

* **The split is exact:** ``hi + lo == x`` for every finite ``x`` below
  2^126, and ``hi`` keeps 10 mantissa bits.
* **Scores** stay within the kernel's own gates, ``1e-5 (|q|^2 + |c|^2)``
  for squared distances and ``1e-5 |q| |c|`` for dot products, of both
  ``distance_plain`` and the reference's ``distance_pallas`` (interpret
  mode).  The model's worst error normalised by those scales must stay at
  most 2e-6, a fifth of the gate: the split drops about 2.5 * 2^-21 of each
  ``|q_i c_i|``.
* **Rows holding inf, NaN or a value beyond 2^126** are recomputed in plain
  f32, so their non-finite scores equal the plain version's exactly.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.distance import distance_pallas
from repro_torch.kernels.distance import (K_BLOCK, MODES, SPLIT_LIMIT, distance_3xtf32,
                                          distance_plain, split_flags, split_tf32)
from test_torch_models import one_torch_thread  # noqa: F401  (autouse fixture)

RTOL = 1e-5
MODEL_RTOL = 2e-6
DIMS = (1, 37, 100, 128, 200)


def _bits(x):
    return x.contiguous().view(torch.int32)


def _round_tf32_reference(x: np.ndarray) -> np.ndarray:
    """Round f32 to 10 mantissa bits, to nearest with ties away from zero,
    through the float64 value (independent of the bit trick under test)."""
    x64 = x.astype(np.float64)
    _, e = np.frexp(x64)  # x = f 2^e, 0.5 <= |f| < 1
    step = np.ldexp(1.0, e - 11)  # one TF32 ulp
    r = np.sign(x64) * np.floor(np.abs(x64) / step + 0.5) * step
    return np.where(x64 == 0, x64, r).astype(np.float32)


def _clustered(seed, n, d, n_q):
    """Database and queries as clustered Gaussians, built as the chip smoke
    run builds its ann-benchmarks shapes: centres N(0, 1), members
    N(centre, 0.35^2)."""
    rng = np.random.default_rng(seed)
    centres = rng.standard_normal((8, d), dtype=np.float32)
    db = centres[rng.integers(0, 8, n)] + 0.35 * rng.standard_normal((n, d), dtype=np.float32)
    q = centres[rng.integers(0, 8, n_q)] + 0.35 * rng.standard_normal((n_q, d), dtype=np.float32)
    return q.astype(np.float32), db.astype(np.float32)


def _scale(q, c, mode):
    q2 = (q.astype(np.float64) ** 2).sum(1)
    c2 = (c.astype(np.float64) ** 2).sum(1)
    if mode == "euclidean":
        return q2[:, None] + c2[None, :]
    return np.sqrt(q2)[:, None] * np.sqrt(c2)[None, :]


def _pallas(q, c, mode):
    """The reference's kernel in interpret mode, on inputs zero-padded to
    its 128-blocks (as tests/test_torch_knn.py runs it)."""
    def pad(x, rows):
        out = np.zeros((-(-rows // 128) * 128, -(-x.shape[1] // K_BLOCK) * K_BLOCK),
                       np.float32)
        out[:x.shape[0], :x.shape[1]] = x
        return out
    got = distance_pallas(jnp.asarray(pad(q, q.shape[0])), jnp.asarray(pad(c, c.shape[0])),
                          mode=mode, bm=128, bn=128, bk=K_BLOCK, interpret=True)
    return np.asarray(got)[:q.shape[0], :c.shape[0]]


def test_split_is_exact_and_rounds_to_nearest_tf32():
    rng = np.random.default_rng(0)
    x = np.concatenate([
        rng.normal(size=4000) * 10.0 ** rng.integers(-30, 30, 4000),
        rng.normal(size=500).astype(np.float32) * np.float32(1e-40),  # subnormals
        [0.0, -0.0, 1.0, -1.0, 2.0 ** 126, -(2.0 ** 126)],
    ]).astype(np.float32)
    # values exactly halfway between two TF32 numbers: ties go away from zero
    exponent = rng.integers(1, 253, 500).astype(np.uint32)  # normal, below 2^126
    mantissa = rng.integers(0, 1 << 10, 500).astype(np.uint32)
    ties = exponent << 23 | mantissa << 13 | 0x1000
    ties = np.concatenate([ties, ties | np.uint32(1 << 31)])  # and their negatives
    tie_vals = ties.astype(np.uint32).view(np.float32)
    x = np.concatenate([x, tie_vals]).astype(np.float32)
    hi, lo = split_tf32(torch.as_tensor(x))
    assert bool(((_bits(hi) & 0x1FFF) == 0).all())
    # normal numbers: the bit trick is round to nearest at 10 mantissa bits
    normal = np.abs(x) >= np.finfo(np.float32).tiny
    np.testing.assert_array_equal(hi.numpy()[normal], _round_tf32_reference(x[normal]))
    # exact: hi + lo == x in float64 (and so in float32)
    np.testing.assert_array_equal(hi.double().numpy() + lo.double().numpy(), x.astype(np.float64))
    # ties round away from zero
    th, _ = split_tf32(torch.as_tensor(tie_vals))
    assert bool((th.abs() > torch.as_tensor(tie_vals).abs()).all())
    # |lo| is at most half a TF32 ulp of a normal x, so the dropped lo.lo is tiny
    assert (np.abs(lo.numpy()[normal]) <= np.abs(x[normal]) * 2.0 ** -11).all()


def test_huge_and_non_finite_values_take_the_plain_path():
    fmax = np.finfo(np.float32).max
    vals = np.float32([np.inf, -np.inf, np.nan, fmax, -fmax,
                       np.nextafter(np.float32(SPLIT_LIMIT), np.float32(np.inf))])
    hi, lo = split_tf32(torch.as_tensor(vals))
    # near FLT_MAX hi overflows; at inf, lo = inf - inf is NaN: the split
    # cannot represent these rows
    assert bool(torch.isinf(hi[:2]).all()) and bool(torch.isnan(lo[:3]).all())
    assert bool(torch.isinf(hi[3:5]).all())
    rows = np.ones((len(vals) + 2, 5), np.float32)
    rows[:len(vals), 2] = vals
    rows[-2, 0] = SPLIT_LIMIT  # the limit itself splits exactly
    flags = split_flags(torch.as_tensor(rows))
    assert flags.tolist() == [True] * len(vals) + [False, False]


@pytest.mark.parametrize("d", DIMS)
def test_3xtf32_model_matches_plain_and_pallas(d):
    q, c = _clustered(d, 120, d, 77)
    tq, tc = torch.as_tensor(q), torch.as_tensor(c)
    worst = {}
    for mode in MODES:
        model = distance_3xtf32(tq, tc, mode).numpy()
        scale = _scale(q, c, mode)
        for name, want in (("plain", distance_plain(tq, tc, mode).numpy()),
                           ("pallas", _pallas(q, c, mode))):
            err = np.abs(model - want) / scale
            assert (err <= RTOL).all(), (mode, name)
            worst[mode, name] = float(err.max())
    print(f"d={d}: worst normalised error of the 3xTF32 model: "
          + ", ".join(f"{m}/{n} {e:.3g}" for (m, n), e in worst.items()))
    assert max(worst.values()) <= MODEL_RTOL


def test_single_pass_tf32_would_miss_the_gate():
    """The gate tells 3xTF32 from plain TF32: one pass of hi.hi alone
    misses 1e-5 |q||c| on clustered data, so the split's two extra
    products are needed."""
    q, c = _clustered(5, 128, 128, 64)
    tq, tc = torch.as_tensor(q), torch.as_tensor(c)
    qh, _ = split_tf32(tq)
    ch, _ = split_tf32(tc)
    err = (qh @ ch.T - distance_plain(tq, tc, "angular")).abs().numpy() / _scale(q, c, "angular")
    assert err.max() > RTOL
    model = distance_3xtf32(tq, tc, "angular")
    assert float(((model - distance_plain(tq, tc, "angular")).abs().numpy()
                  / _scale(q, c, "angular")).max()) <= MODEL_RTOL


@pytest.mark.parametrize("d", (37, 128, 200))
def test_rows_with_inf_and_nan_equal_the_plain_version(d):
    q, c = _clustered(100 + d, 90, d, 40)
    q[3, d // 2] = np.inf
    q[7, 0] = np.nan
    q[11, d - 1] = -np.inf
    c[5, 0] = np.inf
    c[9, d - 1] = -np.inf
    c[13, d // 3] = np.nan
    c[17, 0] = np.inf  # with q[3]'s +inf at another feature: inf * finite
    c[17, d // 2] = 0.0 if d > 1 else c[17, 0]  # inf * 0 against q[3]
    tq, tc = torch.as_tensor(q), torch.as_tensor(c)
    for mode in MODES:
        got = distance_3xtf32(tq, tc, mode)
        want = distance_plain(tq, tc, mode)
        fin = torch.isfinite(want)
        assert torch.equal(torch.isnan(got), torch.isnan(want)), mode
        assert torch.equal(got[~fin & ~torch.isnan(want)], want[~fin & ~torch.isnan(want)])
        assert bool((~fin).any()) and bool(torch.isinf(want).any())
        scale = torch.as_tensor(_scale(q, c, mode))
        ok = (got[fin] - want[fin]).abs().double() <= RTOL * scale[fin]
        assert bool(ok.all()), mode
        # without the rule the split would give NaN where plain gives +-inf
        qh, ql = split_tf32(tq)
        ch, cl = split_tf32(tc)
        raw = qh @ ch.T + (qh @ cl.T + ql @ ch.T)
        assert bool((torch.isnan(raw) & torch.isinf(want)).any()), mode
