"""Generalized distance modes as vector search (kNN / radius queries).

The port's counterpart of ``repro/core/knn.py``.  Every query is *score
computation* followed by *selection*:

    ||q - c||^2 = ||q||^2 - 2 q.c + ||c||^2          (euclidean)
    scores      = Q @ C^T,  norms = rowsum(C*C)      (angular)

``pairwise_scores`` produces the (M, N) score matrix for any metric;
``select_topk`` / ``select_within`` / ``count_within_scores`` are the
selection epilogues; ``knn`` / ``radius_search`` / ``radius_count`` compose
the two.  The session layer (``core/session.py``) reuses the same pieces
with an index's precomputed ``||c||^2``.

Two points where PyTorch differs from JAX and the port holds to JAX:

* **Matmul precision.** The reference multiplies at
  ``Precision.HIGHEST``; the port's products run with TF32 off
  (:func:`full_f32_matmul`).
* **Ties.** ``jax.lax.top_k`` ranks by IEEE total order and puts the
  lower index first among equal scores; ``torch.topk`` treats -0.0 and
  +0.0 as equal and promises no order among ties.  Selection therefore
  runs on int32 order keys (:func:`order_key`) through
  :func:`topk_keys`, which restores the reference's order exactly.
"""
from __future__ import annotations

import contextlib
import math

import torch

METRICS = ("euclidean", "angular", "cosine")
RADIUS_METRICS = ("euclidean", "cosine")


# ---------------------------------------------------------------------------
# Eager query-parameter validation
# ---------------------------------------------------------------------------


def check_k(k) -> int:
    """Validate a top-k slot count: a positive int, not required to be
    <= the candidate count (selection clamps and pads the excess)."""
    k = int(k)
    if k <= 0:
        raise ValueError(f"k must be >= 1, got {k}")
    return k


def check_radius(radius, metric: str = "euclidean") -> float:
    """Validate a query radius: NaN raises, and so does a negative
    euclidean radius.  Cosine radii are minimum similarities, so any
    non-NaN value is legal there."""
    r = float(radius)
    if math.isnan(r):
        raise ValueError(f"radius must not be NaN (got {radius!r})")
    if metric == "euclidean" and r < 0.0:
        raise ValueError(
            f"euclidean radius must be >= 0, got {r} (distances are "
            "non-negative, so a negative radius can match nothing)")
    return r


def _pad_slots(x: torch.Tensor, k: int, fill) -> torch.Tensor:
    """Pad the trailing top-k axis from ``min(k, N)`` back out to ``k``."""
    pad = k - x.shape[-1]
    if pad == 0:
        return x
    return torch.cat([x, torch.full(x.shape[:-1] + (pad,), fill,
                                    dtype=x.dtype, device=x.device)], dim=-1)


# ---------------------------------------------------------------------------
# Scores
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def full_f32_matmul():
    """Hold TF32 off for float32 matrix products (the reference's
    ``Precision.HIGHEST``), restoring the caller's setting after."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _f32(x) -> torch.Tensor:
    return x if x.dtype == torch.float32 else x.to(torch.float32)


def squared_norms(x: torch.Tensor) -> torch.Tensor:
    """Row-wise ||x||^2 -- the OpAngular norm output.  (N, D) -> (N,)."""
    x = _f32(x)
    return (x * x).sum(-1)


def euclidean_scores(queries: torch.Tensor, database: torch.Tensor, *,
                     c_sq_norms: torch.Tensor | None = None) -> torch.Tensor:
    """Pairwise squared euclidean distances, matmul form.  (M,D),(N,D) ->
    (M,N): ``max((||q||^2 - 2 q.c) + ||c||^2, 0)``."""
    q, c = _f32(queries), _f32(database)
    q2 = squared_norms(q)[:, None]
    c2 = squared_norms(c) if c_sq_norms is None else c_sq_norms
    with full_f32_matmul():
        qc = q @ c.T
    # in place, to hold one (M, N) buffer: -2 q.c + q2 is q2 - 2 q.c exactly
    return qc.mul_(-2.0).add_(q2).add_(c2[None, :]).clamp_min_(0.0)


def angular_scores(queries: torch.Tensor, database: torch.Tensor, *,
                   c_sq_norms: torch.Tensor | None = None):
    """OpAngular outputs for all pairs: ``(Q @ C^T, ||c||^2)``."""
    q, c = _f32(queries), _f32(database)
    with full_f32_matmul():
        dots = q @ c.T
    norms = squared_norms(c) if c_sq_norms is None else c_sq_norms
    return dots, norms


def cosine_epilogue(dots: torch.Tensor, c_sq_norms: torch.Tensor,
                    queries: torch.Tensor) -> torch.Tensor:
    """The external divider of Eq. (8): ``dot / max(sqrt(q^2) sqrt(c^2),
    1e-30)``, an IEEE divide.  A pair with a zero-norm vector on either
    side has no angle and scores ``-inf`` (ranks last, never in a radius)."""
    q_sq = squared_norms(queries)
    denom = torch.sqrt(q_sq)[:, None] * torch.sqrt(c_sq_norms)[None, :]
    out = dots / denom.clamp_min_(1e-30)
    degenerate = (q_sq == 0.0)[:, None] | (c_sq_norms == 0.0)[None, :]
    return out.masked_fill_(degenerate, float("-inf"))


def cosine_similarity(queries: torch.Tensor, database: torch.Tensor, *,
                      c_sq_norms: torch.Tensor | None = None) -> torch.Tensor:
    dots, c_norms = angular_scores(queries, database, c_sq_norms=c_sq_norms)
    return cosine_epilogue(dots, c_norms, queries)


def pairwise_scores(queries: torch.Tensor, database: torch.Tensor,
                    metric: str = "euclidean", *,
                    c_sq_norms: torch.Tensor | None = None) -> torch.Tensor:
    """The (M, N) score matrix: squared distances for ``euclidean``
    (lower = closer), similarities for ``angular``/``cosine``."""
    if metric == "euclidean":
        return euclidean_scores(queries, database, c_sq_norms=c_sq_norms)
    if metric == "angular":
        return angular_scores(queries, database, c_sq_norms=c_sq_norms)[0]
    if metric == "cosine":
        return cosine_similarity(queries, database, c_sq_norms=c_sq_norms)
    raise ValueError(f"unknown metric: {metric} (want one of {METRICS})")


# ---------------------------------------------------------------------------
# Selection
# ---------------------------------------------------------------------------


_LOW31 = 0x7FFFFFFF


def order_key(x: torch.Tensor) -> torch.Tensor:
    """f32 -> int32 whose integer order is IEEE total order (-0.0 < +0.0,
    +NaN above +inf): the order ``jax.lax.top_k`` ranks by.  The map is
    its own inverse on the bits (:func:`key_value`), and ``~key`` is the
    key of ``-x``."""
    b = x.contiguous().view(torch.int32)
    return (b >> 31).bitwise_and_(_LOW31).bitwise_xor_(b)


def key_value(key: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`order_key`."""
    return ((key >> 31).bitwise_and_(_LOW31).bitwise_xor_(key)
            .view(torch.float32))


def topk_keys(key: torch.Tensor, k: int):
    """``jax.lax.top_k`` over the last axis of 2-D int32 order keys: the
    ``k`` largest, descending, equal keys in ascending index order.

    ``torch.topk`` gets the kept values right but may keep any members of
    the tie group at the k-th value, in any order.  Where a row holds more
    members of that group than ``topk`` kept, those slots are refilled
    with the group's lowest indices (a second ``topk`` over a key that is
    ``N-1-j`` on the group and -1 elsewhere).  Then every row's ``k``
    slots are put in (key descending, index ascending) order."""
    n = key.shape[-1]
    vals, idx = torch.topk(key, k, dim=-1)
    t = vals[:, -1:]
    n_gt = (vals > t).sum(-1)
    short = ((key == t).sum(-1) != k - n_gt).nonzero().squeeze(1)
    if short.numel():
        rev = torch.arange(n - 1, -1, -1, dtype=torch.int32, device=key.device)
        group = torch.where(key[short] == t[short], rev, -1)
        _, ties = torch.topk(group, k, dim=-1)
        slot = torch.arange(k, device=key.device)
        g = n_gt[short][:, None]
        idx[short] = torch.where(
            slot < g, idx[short], torch.gather(ties, 1, (slot - g).clamp(min=0)))
    order = torch.argsort((vals.to(torch.int64) << 32) | (n - 1 - idx), dim=-1,
                          descending=True)
    return torch.gather(vals, 1, order), torch.gather(idx, 1, order)


def _radius_sq(radius: float, device) -> torch.Tensor:
    """``radius * radius`` squared in double, then rounded to f32 for the
    compare, exactly as the reference compares an f32 array with a Python
    float."""
    return torch.tensor(radius * radius, dtype=torch.float32, device=device)


def select_topk(scores: torch.Tensor, k: int, metric: str = "euclidean"):
    """Top-k on a score matrix: ascending for euclidean distances,
    descending for similarities.  ``k`` clamps to N; the excess slots pad
    with the worst score (+inf / -inf) and index -1."""
    k = check_k(k)
    kk = min(k, scores.shape[-1])
    key = order_key(scores)
    if metric == "euclidean":  # top_k(-scores): ~key is the key of -scores
        key, idx = topk_keys(key.bitwise_not_(), kk)
        out, fill = -key_value(key), float("inf")
    else:
        key, idx = topk_keys(key, kk)
        out, fill = key_value(key), float("-inf")
    return _pad_slots(out, k, fill), _pad_slots(idx.to(torch.int32), k, -1)


def select_within(scores: torch.Tensor, radius: float, k: int,
                  metric: str = "euclidean"):
    """Range-limited top-k: the best ``k`` candidates inside the radius.
    Returns ``(scores, indices, within)``; slots outside the radius carry
    the reference's values (+inf / -inf score, ``within`` False, and the
    index ``top_k`` gave them)."""
    k = check_k(k)
    radius = check_radius(radius, metric)
    kk = min(k, scores.shape[-1])
    ninf = order_key(torch.tensor([float("-inf")], device=scores.device))
    if metric == "euclidean":  # top_k(where(inside, -scores, -inf))
        inside = scores <= _radius_sq(radius, scores.device)
        key = torch.where(inside, order_key(scores).bitwise_not_(), ninf)
        key, idx = topk_keys(key, kk)
        neg = key_value(key)
        out, within, fill = -neg, torch.isfinite(neg), float("inf")
    elif metric == "cosine":
        inside = scores >= torch.tensor(radius, dtype=torch.float32,
                                        device=scores.device)
        key, idx = topk_keys(torch.where(inside, order_key(scores), ninf), kk)
        out = key_value(key)
        within, fill = torch.isfinite(out), float("-inf")
    else:
        raise ValueError(
            f"unknown radius metric: {metric} (want one of {RADIUS_METRICS})")
    return (_pad_slots(out, k, fill), _pad_slots(idx.to(torch.int32), k, -1),
            _pad_slots(within, k, False))


def count_within_scores(scores: torch.Tensor, radius: float,
                        metric: str = "euclidean") -> torch.Tensor:
    """Number of candidates inside the radius, per query row (M,N)->(M,)."""
    radius = check_radius(radius, metric)
    if metric == "euclidean":
        inside = scores <= _radius_sq(radius, scores.device)
    elif metric == "cosine":
        inside = scores >= torch.tensor(radius, dtype=torch.float32,
                                        device=scores.device)
    else:
        raise ValueError(
            f"unknown radius metric: {metric} (want one of {RADIUS_METRICS})")
    return inside.sum(-1).to(torch.int32)


# ---------------------------------------------------------------------------
# Free functions (score + select per call)
# ---------------------------------------------------------------------------


def radius_search(queries, database, radius: float, k: int,
                  metric: str = "euclidean", *, c_sq_norms=None):
    """Up to ``k`` neighbours within ``radius``: ``(scores, indices,
    within)``; for cosine, ``radius`` is the minimum similarity."""
    if metric not in RADIUS_METRICS:
        raise ValueError(f"unknown radius_search metric: {metric}")
    scores = pairwise_scores(queries, database, metric, c_sq_norms=c_sq_norms)
    return select_within(scores, radius, k, metric)


def radius_count(queries, database, radius: float, metric: str = "euclidean",
                 *, c_sq_norms=None) -> torch.Tensor:
    """Number of database points within ``radius`` of each query."""
    if metric not in RADIUS_METRICS:
        raise ValueError(f"unknown radius_count metric: {metric}")
    scores = pairwise_scores(queries, database, metric, c_sq_norms=c_sq_norms)
    return count_within_scores(scores, radius, metric)


def knn(queries, database, k: int, metric: str = "euclidean", *,
        c_sq_norms=None):
    """Exact k-nearest neighbours: ``(scores, indices)``, ascending for
    euclidean, descending for angular/cosine."""
    if metric not in METRICS:
        raise ValueError(f"unknown metric: {metric}")
    scores = pairwise_scores(queries, database, metric, c_sq_norms=c_sq_norms)
    return select_topk(scores, k, metric)
