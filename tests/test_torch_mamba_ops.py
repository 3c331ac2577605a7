"""The Mamba mixer's pieces in the port held bit for bit against the
reference's on the CPU, and its chunked scan against the recurrence.

- ``_associative_scan`` against ``jax.lax.associative_scan`` over 1 to 128
  steps, and ``_conv1d`` over 1, 2 and 4 taps in float32 and bf16: bit for
  bit, both packages run op by op;
- ``silu`` and the mixer's softplus against ``jax.nn``'s: bit for bit in
  bf16, within 2 ulps in float32;
- ``selective_scan`` from a nonzero state, at several lengths and chunk
  sizes, against the recurrence in float64 at 1e-5.

Below ``TINY`` the packages may differ: XLA's CPU backend flushes
subnormal values to zero, PyTorch's does not.  Inputs come from a numpy
seed.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import mamba as jmamba
from repro_torch.models import MambaConfig, ModelConfig
from repro_torch.models import mamba as tmamba
from repro_torch.models.layers import silu
from test_torch_mamba import _as
from test_torch_models import one_torch_thread  # noqa: F401  (autouse fixture)

#: below this magnitude the packages may differ (XLA's CPU backend flushes
#: subnormal results and intermediates to zero)
TINY = 1e-30


def _same_bits(got: torch.Tensor, want, what: str, ulps: int = 0):
    """Bit-equal (within ``ulps`` float32 steps) wherever either side is at
    least ``TINY`` in magnitude; elsewhere both are below it."""
    g = got.float().numpy()
    w = np.asarray(jnp.asarray(want).astype(jnp.float32))
    big = (np.abs(g) >= TINY) | (np.abs(w) >= TINY)
    gi, wi = (v[big].view(np.int32).astype(np.int64) for v in (g, w))
    assert ((np.sign(g[big]) == np.sign(w[big])) & (np.abs(gi - wi) <= ulps)).all(), (
        f"{what}: {int((np.abs(gi - wi) > ulps).sum())} of {gi.size} differ by more than "
        f"{ulps} ulps; the first at {np.flatnonzero(np.abs(gi - wi) > ulps)[:4]}")
    assert (np.abs(g[~big]) < TINY).all() and (np.abs(w[~big]) < TINY).all(), what


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 6, 7, 8, 9, 16, 17, 31, 32, 33, 127, 128])
def test_associative_scan_is_the_references_product_tree(n):
    """``_associative_scan`` of the scan's operator over ``n`` steps, bit for
    bit against ``jax.lax.associative_scan`` run op by op (jitted, XLA
    contracts ``a2 * m1 + m2`` into one rounding): the same odd/even
    recursion, so the same products and sums in the same order.  Decays in
    [0.05, 1) take the longer products below float32's normal range."""
    rng = np.random.default_rng(n)
    a = rng.uniform(0.05, 1.0, (2, n, 3, 2)).astype(np.float32)
    m = rng.normal(size=(2, n, 3, 2)).astype(np.float32)
    want = jax.lax.associative_scan(
        lambda l, r: (l[0] * r[0], r[0] * l[1] + r[1]), (jnp.asarray(a), jnp.asarray(m)),
        axis=1)
    got = tmamba._associative_scan([torch.as_tensor(a), torch.as_tensor(m)])
    for name, g, w in zip(("decay", "state"), got, want, strict=True):
        _same_bits(g, w, f"{name} over {n} steps")


@pytest.mark.parametrize("state", [False, True], ids=["zeros", "state"])
@pytest.mark.parametrize("t", [1, 5])
@pytest.mark.parametrize("k", [1, 2, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_conv1d_bit_equal_to_the_reference(dtype, k, t, state):
    """``_conv1d`` with ``k`` taps over ``t`` steps, from zeros or from a
    state, bit for bit against the reference run op by op: the output (the
    taps summed in the same order, in ``dtype``) and the new state (the
    padded input's last ``k - 1`` rows; none for one tap)."""
    rng = np.random.default_rng(10 * k + t)
    x, tx = _as(rng.normal(size=(2, t, 6)), dtype)
    s, ts = _as(rng.normal(size=(2, k - 1, 6)), dtype) if state else (None, None)
    p = {"conv_w": rng.normal(size=(k, 6)).astype(np.float32),
         "conv_b": rng.normal(size=6).astype(np.float32)}
    want = jmamba._conv1d({n: jnp.asarray(v) for n, v in p.items()}, x, s)
    got = tmamba._conv1d({n: torch.as_tensor(v) for n, v in p.items()}, tx, ts)
    for name, g, w in zip(("output", "state"), got, want, strict=True):
        assert g.dtype == getattr(torch, dtype) and tuple(g.shape) == w.shape, name
        _same_bits(g, w, name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("op", ["silu", "softplus"])
def test_silu_and_softplus_match_jax(op, dtype):
    """The port's ``silu`` and the mixer's softplus against ``jax.nn``'s over
    [-100, 100] and a few extremes, wherever either result is at least
    ``TINY`` (past about -88 both are zero or a subnormal that XLA
    flushes): in bf16, where each op rounds to bf16 as in the reference,
    bit for bit; in float32 within 2 ulps (XLA's exp, log1p and logistic
    are its own approximations, not the C library's)."""
    x = np.concatenate([np.linspace(-100, 100, 4001),
                        [0.0, -0.0, 1e-30, -1e-30, 1e4, -1e4]])
    jx, tx = _as(x, dtype)
    want = {"silu": jax.nn.silu, "softplus": jax.nn.softplus}[op](jx)
    got = {"silu": silu, "softplus": tmamba._softplus}[op](tx)
    assert got.dtype == getattr(torch, dtype)
    _same_bits(got, want, op, ulps=2 if dtype == "float32" else 0)


@pytest.mark.parametrize("chunk", [1, 4, 16])
@pytest.mark.parametrize("t", [1, 4, 9, 16])
def test_selective_scan_from_a_state_is_the_recurrence(t, chunk):
    """``selective_scan`` over ``t`` steps in chunks of ``min(chunk, t)``
    (the last one padded where they do not divide ``t``), from a nonzero
    state: outputs and final state against the recurrence h_t = exp(dt_t A)
    h_{t-1} + dt_t B_t x_t, y_t = C_t h_t + D x_t in float64, at 1e-5."""
    cfg = ModelConfig(name="t", family="ssm", num_layers=1, d_model=4, num_heads=1,
                      num_kv_heads=1, d_ff=8, vocab_size=16, layer_pattern=("mamba",),
                      mamba=MambaConfig(d_state=3, d_conv=2, expand=2, chunk=chunk))
    rng = np.random.default_rng(100 * t + chunk)
    d_in, n = 8, 3
    dt = rng.uniform(0.01, 0.5, (2, t, d_in)).astype(np.float32)
    b, c = (rng.normal(size=(2, t, n)).astype(np.float32) for _ in range(2))
    xc = rng.normal(size=(2, t, d_in)).astype(np.float32)
    h0 = rng.normal(size=(2, d_in, n)).astype(np.float32)
    a_log = np.log(rng.uniform(1.0, 4.0, (d_in, n))).astype(np.float32)
    d_skip = rng.normal(size=d_in).astype(np.float32)
    p = {"a_log": torch.as_tensor(a_log), "d_skip": torch.as_tensor(d_skip)}
    y, h = tmamba.selective_scan(cfg, *(torch.as_tensor(v) for v in (dt, b, c, xc)), p,
                                 torch.as_tensor(h0))
    a = -np.exp(a_log.astype(np.float64))
    hw, ys = h0.astype(np.float64), []
    for i in range(t):
        hw = (np.exp(dt[:, i, :, None] * a) * hw
              + (dt[:, i] * xc[:, i])[..., None] * b[:, i, None, :])
        ys.append(np.einsum("bdn,bn->bd", hw, c[:, i]) + xc[:, i] * d_skip)
    np.testing.assert_allclose(y.numpy(), np.stack(ys, 1), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(h.numpy(), hw, rtol=1e-5, atol=1e-5)
