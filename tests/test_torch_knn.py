"""The port's brute-force distance search held against the JAX reference.

The same numpy inputs go through ``repro`` and ``repro_torch`` (with
``device="cpu"``).  Tolerances, and why:

* **Indices, ``within`` flags and counts are exact**, ties included: the
  port selects on IEEE total-order keys and puts the lower index first,
  as ``jax.lax.top_k`` does.  The data are drawn so that no two distinct
  candidates of a row score within the score tolerance of each other.
* **Scores** agree to 1e-5 relative to the scale of the sum that made
  them: ``1e-5 * (|q|^2 + |c|^2)`` for squared euclidean distances (the
  expanded form ``|q|^2 - 2 q.c + |c|^2`` cancels, so its error scales
  with the norms, not with the result), ``1e-5 * |q| |c|`` for dot
  products and 1e-5 for cosine similarities.  XLA and PyTorch sum the
  128-wide products in different orders.
* Selection alone, given the very same score matrix, is **bit-equal**.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import VectorIndex as JVectorIndex
from repro.kernels.distance import distance_pallas, norms_pallas
from repro_torch.api import VectorIndex, distance_backends
from repro_torch.convert import index_from_numpy
from repro_torch.core import knn as tk
from repro_torch.kernels import ops
from repro_torch.kernels.distance import distance_cuda, distance_plain, norms_plain
from repro_torch.kernels.ref import angular_ref, euclidean_direct_ref, euclidean_ref
from test_torch_models import one_torch_thread  # noqa: F401  (autouse fixture)

jk = importlib.import_module("repro.core.knn")

METRICS = ("euclidean", "angular", "cosine")
RTOL = 1e-5
N_DB, N_Q, DIM = 300, 37, 100


def _data(seed=0, n=N_DB, m=N_Q, d=DIM):
    """Database with a triplicate (rows 5, 9, 11) and a query equal to it."""
    rng = np.random.default_rng(seed)
    db = rng.normal(size=(n, d)).astype(np.float32)
    q = rng.normal(size=(m, d)).astype(np.float32)
    if n > 11:
        db[5] = db[11] = db[9]
        q[3] = db[9]
    return q, db


def _scale(q, db, metric):
    """The tolerance scale of each (query, candidate) score."""
    q64, c64 = q.astype(np.float64), db.astype(np.float64)
    q2, c2 = (q64 * q64).sum(1), (c64 * c64).sum(1)
    if metric == "euclidean":
        return q2[:, None] + c2[None, :]
    if metric == "angular":
        return np.sqrt(q2)[:, None] * np.sqrt(c2)[None, :]
    return np.ones((q.shape[0], db.shape[0]))


def _assert_scores(got, want, scale, idx=None):
    got, want = np.asarray(got), np.asarray(want)
    if idx is not None:  # (M, k) slots: the scale of the chosen candidate
        scale = np.take_along_axis(scale, np.maximum(np.asarray(idx), 0), 1)
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), fin)
    np.testing.assert_array_equal(got[~fin], want[~fin])
    assert (np.abs(got[fin] - want[fin]) <= RTOL * scale[fin]).all()


def _t(x):
    return torch.as_tensor(np.asarray(x))


# ---------------------------------------------------------------------------
# core/knn.py, function by function
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("metric", METRICS)
def test_pairwise_scores_match_reference(metric):
    q, db = _data()
    want = np.asarray(jk.pairwise_scores(jnp.asarray(q), jnp.asarray(db), metric))
    got = tk.pairwise_scores(_t(q), _t(db), metric)
    _assert_scores(got, want, _scale(q, db, metric))
    # with precomputed norms, as an index passes them
    c2 = tk.squared_norms(_t(db))
    np.testing.assert_allclose(c2, np.asarray(jk.squared_norms(jnp.asarray(db))),
                               rtol=RTOL)
    _assert_scores(tk.pairwise_scores(_t(q), _t(db), metric, c_sq_norms=c2), want,
                   _scale(q, db, metric))


@pytest.mark.parametrize("metric", METRICS)
def test_knn_radius_search_and_count_match_reference(metric):
    q, db = _data(1)
    jq, jdb = jnp.asarray(q), jnp.asarray(db)
    scale = _scale(q, db, metric)
    want_s, want_i = jk.knn(jq, jdb, 12, metric)
    got_s, got_i = tk.knn(_t(q), _t(db), 12, metric)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    _assert_scores(got_s, want_s, scale, want_i)
    if metric == "angular":
        return
    s = np.asarray(jk.pairwise_scores(jq, jdb, metric))
    radius = float(np.sqrt(np.median(s))) if metric == "euclidean" else 0.1
    w_s, w_i, w_w = jk.radius_search(jq, jdb, radius, 20, metric)
    g_s, g_i, g_w = tk.radius_search(_t(q), _t(db), radius, 20, metric)
    np.testing.assert_array_equal(g_w.numpy(), np.asarray(w_w))
    np.testing.assert_array_equal(g_i.numpy(), np.asarray(w_i))
    _assert_scores(g_s, w_s, scale, w_i)
    np.testing.assert_array_equal(
        tk.radius_count(_t(q), _t(db), radius, metric).numpy(),
        np.asarray(jk.radius_count(jq, jdb, radius, metric)))


@pytest.mark.parametrize("metric", METRICS)
def test_selection_bit_equal_on_the_same_scores(metric):
    """Ties, the triplicate, -0.0 against +0.0 and -inf rows: every
    selection epilogue returns the reference's bits."""
    q, db = _data(2)
    s = np.asarray(jk.pairwise_scores(jnp.asarray(q), jnp.asarray(db), metric))
    s = s.copy()
    s[7, 40:60] = s[7, 40]  # a 20-wide tie group across the k-th slot
    s[8, :] = 0.0
    s[8, ::3] = -0.0
    js, ts = jnp.asarray(s), _t(s)
    for a, b in zip(jk.select_topk(js, 10, metric), tk.select_topk(ts, 10, metric)):
        np.testing.assert_array_equal(np.asarray(a).view(np.int32),
                                      b.numpy().view(np.int32))
    if metric == "angular":
        return
    for radius in (0.0, float(np.median(np.abs(s))) ** 0.5):
        for a, b in zip(jk.select_within(js, radius, 30, metric),
                        tk.select_within(ts, radius, 30, metric)):
            a, b = np.asarray(a), b.numpy()
            if a.dtype == np.float32:
                a, b = a.view(np.int32), b.view(np.int32)
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(
            tk.count_within_scores(ts, radius, metric).numpy(),
            np.asarray(jk.count_within_scores(js, radius, metric)))


def test_ties_go_to_the_lower_index():
    q, db = _data(3)
    scores, idx = tk.knn(_t(q[3:4]), _t(db), 3)
    assert idx.tolist() == [[5, 9, 11]]
    assert (scores == scores[0, 0]).all()
    # the same through the engine, chunked, with the triplicate at the end
    eng = VectorIndex.from_database(db, device="cpu").engine(chunk_size=2)
    assert eng.nearest(q[:5], 3).indices[3].tolist() == [5, 9, 11]


def test_radius_compare_squares_in_double_then_rounds_to_f32():
    # here r*r in double falls just below the score s = f32(0.01), and
    # rounds to s in f32: s is inside only under the reference's compare
    s = np.float32(0.01)
    r = float(np.sqrt(np.float64(s)))
    assert r * r < float(s) and np.float32(r * r) == s
    scores = np.asarray([[s, np.nextafter(s, np.float32(1))]], np.float32)
    want = np.asarray(jk.count_within_scores(jnp.asarray(scores), r))
    assert want.tolist() == [1]
    assert tk.count_within_scores(_t(scores), r).tolist() == [1]
    assert tk.select_within(_t(scores), r, 2)[2].tolist() == [[True, False]]


def test_checks_raise_eagerly():
    for bad in (0, -3):
        with pytest.raises(ValueError, match="k must be"):
            tk.check_k(bad)
    with pytest.raises(ValueError, match="NaN"):
        tk.check_radius(float("nan"))
    with pytest.raises(ValueError, match=">= 0"):
        tk.check_radius(-1.0, "euclidean")
    assert tk.check_radius(-0.5, "cosine") == -0.5
    eng = VectorIndex.from_database(_data()[1], device="cpu").engine()
    q = _data()[0][:2]
    with pytest.raises(ValueError, match="k must be"):
        eng.nearest(q, 0)
    with pytest.raises(ValueError, match="NaN"):
        eng.within(q, float("nan"), 4)
    with pytest.raises(ValueError, match=">= 0"):
        eng.count_within(q, -1.0)


@pytest.mark.parametrize("backend", ("mxu", "cuda"))
def test_k_exceeds_db_pads(backend):
    q, db = _data(4, n=9, m=4, d=8)
    eng = VectorIndex.from_database(db, device="cpu").engine()
    res = eng.nearest(q, 12, backend=backend)
    assert res.scores.shape == (4, 12)
    assert (res.indices[:, 9:] == -1).all() and not res.valid[:, 9:].any()
    assert torch.isinf(res.scores[:, 9:]).all() and (res.scores[:, 9:] > 0).all()
    cos = eng.nearest(q, 12, "cosine", backend=backend)
    assert (cos.scores[:, 9:] == float("-inf")).all()
    win = eng.within(q, 100.0, 12, backend=backend)
    assert win.within[:, :9].all() and not win.within[:, 9:].any()
    want = JVectorIndex.from_database(jnp.asarray(db)).engine(shard=1).nearest(
        jnp.asarray(q), 12, backend="mxu")
    np.testing.assert_array_equal(res.indices.numpy(), np.asarray(want.indices))


@pytest.mark.parametrize("backend", ("mxu", "cuda"))
def test_radius_zero_and_duplicates(backend):
    # integer coordinates: the expanded form is exact, duplicates sit at 0
    rng = np.random.default_rng(13)
    pts = rng.integers(0, 7, size=(30, 3)).astype(np.float32)
    pts[0] = pts[1] = pts[2] = (2.0, 3.0, 1.0)
    eng = VectorIndex.from_database(pts, device="cpu").engine()
    q = np.asarray([[2.0, 3.0, 1.0], [50.0, 50.0, 50.0]], np.float32)
    assert eng.count_within(q, 0.0, backend=backend).tolist() == [3, 0]
    res = eng.within(q, 0.0, 8, backend=backend)
    assert res.indices[0, :3].tolist() == [0, 1, 2]
    assert res.within[0].tolist() == [True] * 3 + [False] * 5
    assert not res.within[1].any() and (res.scores[0, :3] == 0).all()
    assert eng.nearest(q[:1], 3, backend=backend).indices.tolist() == [[0, 1, 2]]


@pytest.mark.parametrize("backend", ("mxu", "cuda"))
def test_zero_norm_cosine_ranks_last(backend):
    rng = np.random.default_rng(31)
    db = rng.normal(size=(24, 8)).astype(np.float32)
    db[5] = 0.0
    q = rng.normal(size=(6, 8)).astype(np.float32)
    q[2] = 0.0
    eng = VectorIndex.from_database(db, device="cpu").engine()
    sims = eng.scores(q, "cosine", backend=backend)
    assert not torch.isnan(sims).any()
    assert (sims[:, 5] == float("-inf")).all() and (sims[2] == float("-inf")).all()
    idx = eng.nearest(q, 24, "cosine", backend=backend).indices
    assert (idx[[0, 1, 3, 4, 5], -1] == 5).all()
    win = eng.within(q, -1.0, 24, "cosine", backend=backend)
    assert not win.within[2].any()
    assert not (win.indices[win.within] == 5).any()


@pytest.mark.parametrize("backend", ("mxu", "cuda"))
def test_empty_batches(backend):
    eng = VectorIndex.from_database(_data()[1], device="cpu").engine()
    q = np.zeros((0, DIM), np.float32)
    res = eng.nearest(q, 4, backend=backend)
    assert res.scores.shape == (0, 4) and res.valid.dtype == torch.bool
    assert eng.within(q, 1.0, 4, backend=backend).within.shape == (0, 4)
    assert eng.count_within(q, 1.0, backend=backend).shape == (0,)
    assert eng.scores(q, backend=backend).shape == (0, N_DB)


# ---------------------------------------------------------------------------
# the distance and norm kernels' plain versions, and ops at a ragged D
# ---------------------------------------------------------------------------


def test_plain_versions_match_pallas_interpret():
    """One 128 x 128 output tile over two 128-wide K blocks, so the
    euclidean sum carries across blocks as the reference's does."""
    rng = np.random.default_rng(5)
    q = rng.normal(size=(128, 256)).astype(np.float32)
    c = rng.normal(size=(128, 256)).astype(np.float32)
    for mode, metric in (("euclidean", "euclidean"), ("angular", "angular")):
        want = np.asarray(distance_pallas(jnp.asarray(q), jnp.asarray(c), mode=mode,
                                          bm=128, bn=128, bk=128, interpret=True))
        _assert_scores(distance_plain(_t(q), _t(c), mode), want, _scale(q, c, metric))
    want = np.asarray(norms_pallas(jnp.asarray(c), bn=128, bk=128, interpret=True))
    np.testing.assert_allclose(norms_plain(_t(c)).numpy(), want, rtol=RTOL)
    # on CPU tensors the wrappers are their plain versions
    assert torch.equal(distance_cuda(_t(q), _t(c)), distance_plain(_t(q), _t(c)))


def test_ops_at_d100_match_the_oracles():
    q, db = _data(6, n=130, m=9)
    tq, tdb = _t(q), _t(db)
    _assert_scores(ops.euclidean_kernel(tq, tdb), euclidean_ref(tq, tdb),
                   _scale(q, db, "euclidean"))
    _assert_scores(ops.euclidean_kernel(tq, tdb), euclidean_direct_ref(tq, tdb),
                   _scale(q, db, "euclidean"))
    dots, norms = ops.angular_kernel(tq, tdb)
    want_dots, want_norms = angular_ref(tq, tdb)
    assert dots.shape == (9, 130) and norms.shape == (130,)
    _assert_scores(dots, want_dots, _scale(q, db, "angular"))
    np.testing.assert_allclose(norms, want_norms, rtol=RTOL)
    assert torch.equal(ops.dot_kernel(tq, tdb), dots)


# ---------------------------------------------------------------------------
# the engine against the reference's engine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("metric", METRICS)
def test_engine_matches_reference_engine(metric):
    q, db = _data(7)
    jeng = JVectorIndex.from_database(jnp.asarray(db)).engine(shard=1)
    jq = jnp.asarray(q)
    index = VectorIndex.from_database(db, device="cpu")
    scale = _scale(q, db, metric)
    assert set(distance_backends()) == {"mxu", "cuda"}
    for backend in ("mxu", "cuda"):  # "cuda" runs its plain version here
        eng = index.engine(chunk_size=16)
        want = jeng.nearest(jq, 7, metric, backend="mxu")
        got = eng.nearest(q, 7, metric, backend=backend)
        np.testing.assert_array_equal(got.indices.numpy(), np.asarray(want.indices))
        np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
        _assert_scores(got.scores, want.scores, scale, want.indices)
        _assert_scores(eng.scores(q, metric, backend=backend),
                       jeng.scores(jq, metric, backend="mxu"), scale)
        if metric == "angular":
            continue
        radius = 13.0 if metric == "euclidean" else 0.1
        w = jeng.within(jq, radius, 9, metric, backend="mxu")
        g = eng.within(q, radius, 9, metric, backend=backend)
        np.testing.assert_array_equal(g.within.numpy(), np.asarray(w.within))
        np.testing.assert_array_equal(g.indices.numpy(), np.asarray(w.indices))
        np.testing.assert_array_equal(
            eng.count_within(q, radius, metric, backend=backend).numpy(),
            np.asarray(jeng.count_within(jq, radius, metric, backend="mxu")))
    assert index.engine().resolve_distance_backend() == "mxu"


def test_index_methods_and_round_trip():
    q, db = _data(8)
    jidx = JVectorIndex.from_database(jnp.asarray(db))
    idx = index_from_numpy(db, np.asarray(jidx.sq_norms), device="cpu")
    np.testing.assert_array_equal(idx.database.numpy(), np.asarray(jidx.database))
    np.testing.assert_array_equal(idx.sq_norms.numpy(), np.asarray(jidx.sq_norms))
    own = index_from_numpy(db, device="cpu")  # norms from the norm kernel's plain
    np.testing.assert_allclose(own.sq_norms, np.asarray(jidx.sq_norms), rtol=RTOL)
    jq = jnp.asarray(q)
    _assert_scores(idx.dots(q), jidx.dots(jq), _scale(q, db, "angular"))
    _assert_scores(idx.cosine_similarity(q), jidx.cosine_similarity(jq),
                   _scale(q, db, "cosine"))
    np.testing.assert_array_equal(idx.knn(q, 4)[1].numpy(),
                                  np.asarray(jidx.knn(jq, 4)[1]))
    np.testing.assert_array_equal(idx.radius_search(q, 13.0, 6)[1].numpy(),
                                  np.asarray(jidx.radius_search(jq, 13.0, 6)[1]))
    np.testing.assert_array_equal(idx.radius_count(q, 13.0).numpy(),
                                  np.asarray(jidx.radius_count(jq, 13.0)))


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("the default device is available here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        VectorIndex.from_database(_data()[1])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        index_from_numpy(_data()[1])
