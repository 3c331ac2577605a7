"""Request coalescing for the ray-query server (DESIGN.md §10).

The port's own copy of ``repro/serving/batching.py``: a pure-Python
state machine, the same in both packages.

The compiled query kernels want full lane-multiple tiles; users send
four-ray requests.  The coalescer is the adapter: requests to the same
``(method, static-params)`` bucket accumulate until one of three
triggers flushes the bucket as a single batch —

* **full** — accumulated rows reached ``max_batch_rows`` (a whole batch
  is ready; waiting longer only adds latency),
* **timer** — the bucket's *oldest* request has waited ``max_wait``
  (bounded time-to-first-flush under trickle traffic),
* **deadline** — the bucket's *earliest* request deadline is within
  ``deadline_margin`` of now (deadline pressure overrides the timer:
  flush before the promise is broken, not after).

Everything here is a plain synchronous state machine driven by explicit
``now`` timestamps — no sleeps, no event loop, no wall clock — so the
flush semantics are unit-tested with a fake clock
(``tests/test_torch_serving.py``); ``repro_torch.serving.query_server``
wraps it with real asyncio timers.  Batch *shapes* come from the engine's own
planner (``QueryEngine.plan_for`` / ``core.dispatch.make_plan``), and
responses are split back per request with the dispatch layer's
``slice_rows`` — the same pad/unpad contract every backend already
honors, which is what makes coalesced execution bit-identical to
per-request execution.
"""
from __future__ import annotations

import itertools
from typing import Any, NamedTuple, Optional

__all__ = [
    "FLUSH_DEADLINE",
    "FLUSH_DRAIN",
    "FLUSH_FULL",
    "FLUSH_TIMER",
    "Batch",
    "Coalescer",
    "Request",
]

FLUSH_FULL = "full"  # max_batch_rows reached
FLUSH_TIMER = "timer"  # oldest request waited max_wait
FLUSH_DEADLINE = "deadline"  # earliest deadline within deadline_margin
FLUSH_DRAIN = "drain"  # explicit flush_all (shutdown / drain)

_ids = itertools.count()


class Request(NamedTuple):
    """One admitted query request, as the coalescer sees it.

    ``params`` is the hashable static-argument tuple (the bucket key is
    ``(method, params)``: only requests that one engine call can serve
    ever share a batch).  ``payload`` holds the per-row tensors (a
    ``Ray`` bundle or an ``(n_rows, d)`` query block).  ``deadline`` is
    absolute, on the coalescer's clock.  ``future``/``n_rows`` travel
    through untouched so the server can split and deliver the response.
    """

    id: int
    method: str
    params: tuple
    payload: Any
    n_rows: int
    enqueued: float
    deadline: Optional[float]
    future: Any


def make_request(method: str, params: tuple, payload, n_rows: int,
                 now: float, deadline: Optional[float] = None,
                 future=None) -> Request:
    return Request(next(_ids), method, params, payload, int(n_rows),
                   float(now), deadline, future)


class Batch(NamedTuple):
    """A flushed bucket: the requests whose payloads will be row-
    concatenated into one engine call, plus why the flush fired."""

    method: str
    params: tuple
    requests: tuple  # of Request, arrival order
    rows: int
    reason: str

    @property
    def sizes(self) -> list:
        """Per-request row counts — the ``slice_rows`` split spec."""
        return [r.n_rows for r in self.requests]


class _Bucket:
    __slots__ = ("method", "params", "requests", "rows", "oldest",
                 "earliest_deadline")

    def __init__(self, method: str, params: tuple):
        self.method = method
        self.params = params
        self.requests: list = []
        self.rows = 0
        self.oldest: Optional[float] = None
        self.earliest_deadline: Optional[float] = None

    def add(self, req: Request) -> None:
        self.requests.append(req)
        self.rows += req.n_rows
        if self.oldest is None:
            self.oldest = req.enqueued
        if req.deadline is not None:
            d = self.earliest_deadline
            self.earliest_deadline = (req.deadline if d is None
                                      else min(d, req.deadline))

    def refresh(self) -> None:
        """Recompute the cached extrema after an eviction."""
        self.oldest = min((r.enqueued for r in self.requests), default=None)
        ds = [r.deadline for r in self.requests if r.deadline is not None]
        self.earliest_deadline = min(ds) if ds else None

    def as_batch(self, reason: str) -> Batch:
        return Batch(self.method, self.params, tuple(self.requests),
                     self.rows, reason)


class Coalescer:
    """Per-(method, params) request buckets with full/timer/deadline
    flushing.  Drive it with ``add(req)`` (returns the request's bucket
    as a :class:`Batch` iff it just went full), ``poll(now)`` (returns
    every bucket whose timer or deadline fired), and ``next_due()``
    (when ``poll`` next needs to run — the async layer's wake-up time).
    """

    def __init__(self, *, max_batch_rows: int = 1024,
                 max_wait: float = 2e-3, deadline_margin: float = 1e-3):
        max_batch_rows = int(max_batch_rows)
        if max_batch_rows < 1:
            raise ValueError(
                f"max_batch_rows must be >= 1, got {max_batch_rows}")
        if max_wait < 0:
            raise ValueError(f"max_wait must be >= 0, got {max_wait}")
        if deadline_margin < 0:
            raise ValueError(
                f"deadline_margin must be >= 0, got {deadline_margin}")
        self.max_batch_rows = max_batch_rows
        self.max_wait = float(max_wait)
        self.deadline_margin = float(deadline_margin)
        self._buckets: dict = {}  # (method, params) -> _Bucket

    # -- state ------------------------------------------------------------

    @property
    def depth(self) -> int:
        """Requests currently waiting in buckets."""
        return sum(len(b.requests) for b in self._buckets.values())

    @property
    def pending_rows(self) -> int:
        return sum(b.rows for b in self._buckets.values())

    def depth_for(self, method: str) -> int:
        """Requests currently waiting in ``method``'s buckets."""
        return sum(len(b.requests)
                   for (m, _), b in self._buckets.items() if m == method)

    def __len__(self) -> int:
        return self.depth

    # -- the three flush triggers -----------------------------------------

    def add(self, req: Request) -> Optional[Batch]:
        """Queue ``req``; if its bucket just reached ``max_batch_rows``
        the whole bucket flushes immediately (reason ``"full"``) and is
        returned.  A single oversized request (> max_batch_rows rows)
        flushes by itself — the engine's ``chunk_size`` knob, not the
        coalescer, is the memory bound."""
        key = (req.method, req.params)
        bucket = self._buckets.get(key)
        if bucket is None:
            bucket = self._buckets[key] = _Bucket(req.method, req.params)
        bucket.add(req)
        if bucket.rows >= self.max_batch_rows:
            del self._buckets[key]
            return bucket.as_batch(FLUSH_FULL)
        return None

    def _flush_reason(self, bucket: _Bucket, now: float) -> Optional[str]:
        d = bucket.earliest_deadline
        if d is not None and d - self.deadline_margin <= now:
            return FLUSH_DEADLINE
        if bucket.oldest is not None and now - bucket.oldest >= self.max_wait:
            return FLUSH_TIMER
        return None

    def poll(self, now: float) -> list:
        """Flush every bucket whose max-wait timer expired or whose
        earliest deadline is within ``deadline_margin`` (deadline
        pressure wins the reason label when both hold)."""
        out = []
        for key in list(self._buckets):
            bucket = self._buckets[key]
            reason = self._flush_reason(bucket, now)
            if reason is not None:
                del self._buckets[key]
                out.append(bucket.as_batch(reason))
        return out

    def next_due(self) -> Optional[float]:
        """The earliest instant at which :meth:`poll` would flush
        something (None = nothing pending)."""
        due = None
        for bucket in self._buckets.values():
            t = bucket.oldest + self.max_wait
            if bucket.earliest_deadline is not None:
                t = min(t, bucket.earliest_deadline - self.deadline_margin)
            due = t if due is None else min(due, t)
        return due

    # -- drain / shed -----------------------------------------------------

    def flush_all(self, reason: str = FLUSH_DRAIN) -> list:
        """Flush every bucket now, regardless of triggers (server drain
        and shutdown)."""
        out = [b.as_batch(reason) for b in self._buckets.values()]
        self._buckets.clear()
        return out

    def evict_oldest(self) -> Optional[Request]:
        """Remove and return the longest-waiting queued request (the
        ``"shed"`` admission policy's victim) — None if nothing is
        queued.  Only *queued* requests are sheddable; once a batch has
        flushed its requests are in flight and untouchable."""
        victim_key, victim_bucket = None, None
        for key, bucket in self._buckets.items():
            if victim_bucket is None or bucket.oldest < victim_bucket.oldest:
                victim_key, victim_bucket = key, bucket
        if victim_bucket is None:
            return None
        victim = min(victim_bucket.requests, key=lambda r: r.enqueued)
        victim_bucket.requests.remove(victim)
        victim_bucket.rows -= victim.n_rows
        if victim_bucket.requests:
            victim_bucket.refresh()
        else:
            del self._buckets[victim_key]
        return victim

    def __repr__(self):
        return (f"Coalescer(buckets={len(self._buckets)}, "
                f"depth={self.depth}, rows={self.pending_rows}, "
                f"max_batch_rows={self.max_batch_rows}, "
                f"max_wait={self.max_wait}, "
                f"deadline_margin={self.deadline_margin})")
