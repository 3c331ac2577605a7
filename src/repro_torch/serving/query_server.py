"""Async ray-query server: continuous batching over ``QueryEngine``
(DESIGN.md §10).

The port's counterpart of ``repro/serving/query_server.py``.  The query
kernels want whole 128-row blocks; users send four-ray requests.
:class:`QueryServer` is the request-level adapter:

    queue -> coalesce -> pad -> dispatch -> split

* **queue**: requests enter through :class:`~repro_torch.serving.
  admission.AdmissionController` (bounded; ``policy="block" | "reject" |
  "shed"``).
* **coalesce**: :class:`~repro_torch.serving.batching.Coalescer` groups
  them per ``(method, static-params)`` bucket and flushes on batch-full /
  max-wait / deadline pressure.
* **pad**: the flushed batch is concatenated on the engine's device and
  padded to whole blocks of the engine's own plan (``QueryEngine.
  plan_for``) for its row count quantized up a power-of-two ladder,
  repeating row 0 as ``core.dispatch.pad_leading`` does.  The engine keys
  a query by its plan's block, so the ladder bounds the keys a live
  server adds to O(log max_batch_rows) per bucket.
* **dispatch**: one ``QueryEngine`` call per batch, on a worker thread
  whose current device is the engine's, so the event loop keeps
  admitting while the card computes; the worker synchronizes the device
  before it hands the responses back.
* **split**: each request's rows are sliced out on the device (views of
  the batch's result), and a trace's ``rounds`` is re-reduced per request
  as ``max(quadbox_jobs)``.

The reference assembles and splits payloads on the host, through numpy,
so that XLA compiles no program per batch composition.  The port has no
such compile to avoid, so its payloads never leave the device.

**The bit-parity contract** (``tests/test_torch_serving.py``, and
``chip_smoke.py`` phase 12 on the card): every response is bit-identical,
hits, indices, scores *and* job counters, to calling ``QueryEngine``
directly with that request's payload.  Rows are independent in every
backend, padding repeats row 0, and a ray is active for exactly
``quadbox_jobs`` consecutive rounds, so the per-request round count is the
max over its own rays wherever those rays execute.

A request whose tensors lie on another device than the engine's data is
refused when it is submitted, before it can poison a shared batch.
"""
from __future__ import annotations

import asyncio
import math
import time
from contextlib import nullcontext
from typing import NamedTuple, Optional

import torch

from ..core.dispatch import slice_rows
from ..core.knn import METRICS, RADIUS_METRICS, check_k, check_radius
from ..core.session import QueryEngine
from ..core.types import as_f32
from ..core.wavefront import RAY_TYPES, default_t_min
from ..obs import register_source
from ..obs.metrics import MetricsRegistry
from ..obs.trace import default_buffer
from .admission import (
    ADMIT,
    REJECT,
    SHED,
    AdmissionController,
    AdmissionStats,
    QueueFull,
    RequestShed,
)
from .batching import (
    FLUSH_DEADLINE,
    FLUSH_DRAIN,
    FLUSH_FULL,
    FLUSH_TIMER,
    Batch,
    Coalescer,
    make_request,
)

__all__ = ["QueryServer", "ServerStats"]


class ServerStats(NamedTuple):
    """Per-method serving statistics (:meth:`QueryServer.stats`)."""

    requests: int  # completed requests
    rows: int  # completed rows
    batches: int  # engine calls made
    queue_depth: int  # requests coalescing right now
    requests_per_batch: float  # mean occupancy (> 1 = coalescing happens)
    mean_batch_rows: float  # mean user rows per engine call
    mean_fill: float  # user rows / padded rows actually executed
    flush_full: int
    flush_timer: int
    flush_deadline: int
    flush_drain: int
    shed: int  # requests dropped by the shed policy
    p50_ms: float
    p99_ms: float


class _MethodStats:
    """Pre-resolved per-method instruments on the server's private
    registry (``serving.{method}.*`` names).  The registry is always
    enabled, so ``stats()`` counts with global telemetry off, and each
    instrument has a single writer (the event loop or the one worker), so
    the counts stay exact.  ``repro_torch.obs.snapshot()`` reads the same
    numbers through the server's registered snapshot source."""

    __slots__ = ("requests", "rows", "batches", "batch_rows", "padded_rows",
                 "flushes", "shed", "latency_ms")

    def __init__(self, reg: MetricsRegistry, method: str):
        pre = f"serving.{method}."
        self.requests = reg.counter(pre + "requests")
        self.rows = reg.counter(pre + "rows")
        self.batches = reg.counter(pre + "batches")
        self.batch_rows = reg.counter(pre + "batch_rows")
        self.padded_rows = reg.counter(pre + "padded_rows")
        self.flushes = {reason: reg.counter(pre + "flush." + reason)
                        for reason in (FLUSH_FULL, FLUSH_TIMER,
                                       FLUSH_DEADLINE, FLUSH_DRAIN)}
        self.shed = reg.counter(pre + "shed")
        self.latency_ms = reg.histogram(pre + "latency_ms")


def _leaves(payload) -> tuple:
    """A payload's per-row tensors: a (Named)tuple's fields, or the one
    tensor."""
    return (payload,) if isinstance(payload, torch.Tensor) else tuple(payload)


def _n_rows(payload) -> int:
    return int(_leaves(payload)[0].shape[0])


def _assemble_payload(requests, target: int):
    """Concatenate the requests' payloads on their device and pad to
    ``target`` rows by repeating row 0, exactly
    :func:`~repro_torch.core.dispatch.pad_leading`'s rule."""
    if len(requests) == 1 and requests[0].n_rows == target:
        return requests[0].payload
    rows = sum(r.n_rows for r in requests)

    def build(*xs):
        parts = list(xs)
        if target > rows:
            parts.append(xs[0][:1].expand((target - rows,) + tuple(xs[0].shape[1:])))
        return torch.cat(parts, dim=0)

    first = requests[0].payload
    if isinstance(first, torch.Tensor):
        return build(*(r.payload for r in requests))
    return type(first)(*(build(*xs) for xs in zip(*(r.payload for r in requests))))


class QueryServer:
    """Continuous-batching request server over a :class:`QueryEngine`.

    Use as an async context manager (or ``await start()`` /
    ``await stop()``)::

        async with QueryServer(engine) as server:
            hit, near = await asyncio.gather(
                server.trace(rays),                  # (tiny) requests from
                server.nearest(points, k=8))         # many clients coalesce

    Knobs:

    * ``max_batch_rows``: flush a bucket as soon as it holds this many
      rows (the "full" trigger; also the batch the kernels see under
      load, so size it to a few 128-row blocks).
    * ``max_wait``: seconds the oldest request in a bucket may wait
      before a timer flush (the latency cost of coalescing under trickle
      traffic).
    * ``deadline_margin``: flush early when a request's deadline is this
      close (requests carry deadlines via ``timeout=``).
    * ``queue_limit`` / ``policy``: admission control: ``"block"``
      (backpressure), ``"reject"`` (fast-fail :class:`QueueFull`),
      ``"shed"`` (drop the oldest queued request, failing it with
      :class:`RequestShed`).
    * ``quantize_batches``: pad flushed batches up a power-of-two row
      ladder (each step to the engine's own ``plan_for`` block) so a live
      server adds O(log max_batch_rows) engine keys per bucket instead of
      one per distinct row count.  Padded rows repeat row 0 and are
      sliced away, so responses are unchanged.
    """

    def __init__(self, engine: QueryEngine, *, max_batch_rows: int = 1024,
                 max_wait: float = 2e-3, deadline_margin: float = 1e-3,
                 queue_limit: int = 4096, policy: str = "block",
                 quantize_batches: bool = True, clock=time.monotonic):
        self.engine = engine
        self.coalescer = Coalescer(max_batch_rows=max_batch_rows,
                                   max_wait=max_wait,
                                   deadline_margin=deadline_margin)
        self.admission = AdmissionController(queue_limit, policy)
        self.quantize_batches = bool(quantize_batches)
        self._clock = clock
        self._stats: dict = {}
        # exact request accounting on a private always-enabled registry
        # (DESIGN.md §11); the global snapshot sees it as a weakly held
        # named source, and request-lifecycle spans go to the global trace
        # buffer (which records only while telemetry is enabled)
        self._obs = MetricsRegistry(enabled=True, name="serving")
        self._trace = default_buffer()
        self._source_name = register_source("serving", self._obs_source)
        self._ready: Optional[asyncio.Queue] = None
        self._wake: Optional[asyncio.Event] = None
        self._capacity: Optional[asyncio.Condition] = None
        self._timer_task = None
        self._worker_task = None
        self._started = False
        self._closed = False

    # -- lifecycle ---------------------------------------------------------

    async def start(self) -> "QueryServer":
        if self._started:
            raise RuntimeError("QueryServer already started")
        self._ready = asyncio.Queue()
        self._wake = asyncio.Event()
        self._capacity = asyncio.Condition()
        self._timer_task = asyncio.create_task(self._timer_loop())
        self._worker_task = asyncio.create_task(self._worker_loop())
        self._started = True
        self._closed = False
        return self

    async def stop(self, drain: bool = True) -> None:
        """Shut down: by default drain (flush + execute + deliver every
        queued request) first, then cancel the loops."""
        if not self._started or self._closed:
            return
        if drain:
            await self.drain()
        self._closed = True
        for task in (self._timer_task, self._worker_task):
            task.cancel()
            try:
                await task
            except asyncio.CancelledError:
                pass
        # fail anything still queued (drain=False shutdowns)
        n = 0
        for batch in self.coalescer.flush_all():
            for req in batch.requests:
                n += 1
                if not req.future.done():
                    req.future.set_exception(RuntimeError("QueryServer stopped"))
        if n:
            self.admission.release(n)
        async with self._capacity:
            self._capacity.notify_all()
        self._started = False

    async def drain(self) -> None:
        """Flush every coalescing bucket now and wait until the worker
        has delivered every in-flight response."""
        for batch in self.coalescer.flush_all(FLUSH_DRAIN):
            self._push(batch)
        await self._ready.join()

    async def __aenter__(self) -> "QueryServer":
        return await self.start()

    async def __aexit__(self, *exc) -> None:
        await self.stop()

    # -- typed request surface (one method per servable query) ------------

    async def trace(self, rays, ray_type: str = "closest", *,
                    t_min: float | None = None,
                    max_rounds: int | None = None,
                    backend: str | None = None,
                    timeout: float | None = None):
        """Serve one traced ray bundle; resolves to a
        :class:`~repro_torch.core.session.TraceResult` bit-identical to
        ``engine.trace(rays, ...)`` (per-ray job counters included, and
        ``rounds`` reduced over *this request's* rays)."""
        if ray_type not in RAY_TYPES:
            raise ValueError(f"ray_type must be one of {RAY_TYPES}, got {ray_type!r}")
        # canonicalize t_min as the engine does, so equal queries share a
        # bucket however the caller spelled them
        if t_min is None:
            t_min = default_t_min(ray_type)
        params = (("backend", backend), ("max_rounds", max_rounds),
                  ("ray_type", ray_type), ("t_min", float(t_min)))
        fut = await self.enqueue("trace", rays, params, timeout=timeout)
        return await fut

    async def nearest(self, queries, k: int, metric: str = "euclidean", *,
                      backend: str | None = None,
                      timeout: float | None = None):
        if metric not in METRICS:
            raise ValueError(f"unknown metric: {metric}")
        k = check_k(k)
        params = (("backend", backend), ("k", k), ("metric", metric))
        fut = await self.enqueue("nearest", self._queries("nearest", queries),
                                 params, timeout=timeout)
        return await fut

    async def within(self, queries, radius: float, k: int,
                     metric: str = "euclidean", *,
                     backend: str | None = None,
                     timeout: float | None = None):
        if metric not in RADIUS_METRICS:
            raise ValueError(f"unknown radius metric: {metric}")
        radius = check_radius(radius, metric)
        k = check_k(k)
        params = (("backend", backend), ("k", k), ("metric", metric),
                  ("radius", float(radius)))
        fut = await self.enqueue("within", self._queries("within", queries),
                                 params, timeout=timeout)
        return await fut

    async def count_within(self, queries, radius: float,
                           metric: str = "euclidean", *,
                           backend: str | None = None,
                           timeout: float | None = None):
        if metric not in RADIUS_METRICS:
            raise ValueError(f"unknown radius metric: {metric}")
        radius = check_radius(radius, metric)
        params = (("backend", backend), ("metric", metric),
                  ("radius", float(radius)))
        fut = await self.enqueue("count_within",
                                 self._queries("count_within", queries),
                                 params, timeout=timeout)
        return await fut

    async def scores(self, queries, metric: str = "euclidean", *,
                     backend: str | None = None,
                     timeout: float | None = None):
        if metric not in METRICS:
            raise ValueError(f"unknown metric: {metric}")
        params = (("backend", backend), ("metric", metric))
        fut = await self.enqueue("scores", self._queries("scores", queries),
                                 params, timeout=timeout)
        return await fut

    def _queries(self, method: str, queries) -> torch.Tensor:
        """A query block as f32 on the engine's device (numpy goes there;
        a tensor on another device is checked by :meth:`enqueue`)."""
        if isinstance(queries, torch.Tensor):
            return queries.to(torch.float32)
        return as_f32(queries, self.engine._method_device(method))

    # -- request intake ----------------------------------------------------

    async def enqueue(self, method: str, payload, params: tuple, *,
                      timeout: float | None = None) -> asyncio.Future:
        """Admit + coalesce one request and return the asyncio future its
        response will be delivered on: the streaming-friendly surface
        (fire many, ``await`` in any order); the typed methods above are
        ``await (await enqueue(...))`` conveniences."""
        if not self._started or self._closed:
            raise RuntimeError("QueryServer is not running (use "
                               "'async with QueryServer(engine):' or "
                               "await start())")
        if method not in self.engine.SERVABLE_METHODS:
            raise ValueError(f"unknown method {method!r} (servable: "
                             f"{self.engine.SERVABLE_METHODS})")
        device = self.engine._method_device(method)
        for x in _leaves(payload):
            if x.device != device:
                raise ValueError(f"{method} request on {x.device}, the engine's "
                                 f"data on {device}")
        n_rows = _n_rows(payload)
        fut = asyncio.get_running_loop().create_future()
        if n_rows == 0:
            # typed empty result straight from the engine: nothing to
            # coalesce, nothing launched, bit-identical trivially
            fut.set_result(self._call_engine(method, payload, dict(params)))
            return fut
        t_admit = self._clock()
        await self._admit()
        now = self._clock()
        deadline = None if timeout is None else now + float(timeout)
        req = make_request(method, params, payload, n_rows, now,
                           deadline=deadline, future=fut)
        if self._trace.enabled:
            self._trace.record("admit", t_admit, now - t_admit, tid=req.id,
                               cat="serving",
                               args={"method": method, "rows": n_rows})
        full = self.coalescer.add(req)
        if full is not None:
            self._push(full)
        self._wake.set()  # retime the flush timer around the new bucket
        return fut

    async def _admit(self) -> None:
        while True:
            verdict = self.admission.try_admit()
            if verdict == ADMIT:
                return
            if verdict == REJECT:
                raise QueueFull(f"admission queue at limit {self.admission.limit} "
                                f"(policy='reject')")
            if verdict == SHED:
                victim = self.coalescer.evict_oldest()
                if victim is None:
                    self.admission.shed_failed()
                    raise QueueFull(
                        f"admission queue at limit {self.admission.limit} "
                        "and nothing left to shed (all in flight)")
                self.admission.admit_after_shed()
                self._mstats(victim.method).shed.inc()
                if not victim.future.done():
                    victim.future.set_exception(RequestShed(
                        "request shed to admit newer work "
                        f"(queued {self._clock() - victim.enqueued:.4f}s)"))
                return
            # WAIT: park until a batch completes and frees capacity
            async with self._capacity:
                await self._capacity.wait_for(
                    lambda: self.admission.has_capacity or self._closed)
            if self._closed:
                raise RuntimeError("QueryServer stopped while waiting "
                                   "for queue capacity")
            self.admission.admit_after_wait()
            return

    # -- flush + execute ---------------------------------------------------

    def _push(self, batch: Batch) -> None:
        self._mstats(batch.method).flushes[batch.reason].inc()
        self._ready.put_nowait(batch)

    async def _timer_loop(self) -> None:
        while True:
            for batch in self.coalescer.poll(self._clock()):
                self._push(batch)
            due = self.coalescer.next_due()
            delay = None if due is None else max(due - self._clock(), 0.0)
            try:
                await asyncio.wait_for(self._wake.wait(), delay)
            except asyncio.TimeoutError:
                pass
            self._wake.clear()

    async def _worker_loop(self) -> None:
        loop = asyncio.get_running_loop()
        while True:
            batch = await self._ready.get()
            try:
                results = await loop.run_in_executor(None, self._execute, batch)
                now = self._clock()
                ms = self._mstats(batch.method)
                for req, res in zip(batch.requests, results):
                    ms.requests.inc()
                    ms.rows.inc(req.n_rows)
                    ms.latency_ms.observe((now - req.enqueued) * 1e3)
                    if not req.future.done():
                        req.future.set_result(res)
            except Exception as exc:  # fail the batch, keep serving
                for req in batch.requests:
                    if not req.future.done():
                        req.future.set_exception(exc)
            finally:
                self.admission.release(len(batch.requests))
                async with self._capacity:
                    self._capacity.notify_all()
                self._ready.task_done()

    def _target_rows(self, batch: Batch) -> int:
        """Rows the engine call will execute: whole blocks of the plan of
        the batch's row count quantized up a power-of-two ladder, so that
        row-count jitter between batches reuses the engine's keys.  The
        engine keys a query by its plan's block, not by the number of
        blocks, so once the ladder reaches the engine's ``chunk_size`` the
        batch pads to whole blocks only (the reference pads to the ladder
        step: 8192 rows for a batch of 4097 in 1024-row chunks, where this
        pads to 5120)."""
        rows = batch.rows
        ladder = (1 << (rows - 1).bit_length()
                  if self.quantize_batches and rows > 1 else rows)
        p = dict(batch.params)
        block = self.engine.plan_for(
            batch.method, ladder, backend=p.get("backend"),
            ray_type=p.get("ray_type", "closest"),
            metric=p.get("metric", "euclidean"), k=p.get("k"),
            radius=p.get("radius")).block
        return block * -(-rows // block)

    def _execute(self, batch: Batch):
        """One engine call for the whole batch (worker thread), split back
        per request.  Bit-parity with per-request execution is the
        contract; the module docstring says why it holds."""
        device = self.engine._method_device(batch.method)
        on_card = device.type == "cuda"
        with torch.cuda.device(device) if on_card else nullcontext():
            target = self._target_rows(batch)
            t_exec = self._clock()
            payload = _assemble_payload(batch.requests, target)
            result = self._call_engine(batch.method, payload, dict(batch.params))
            if on_card:
                torch.cuda.synchronize(device)
            t_split = self._clock()
            parts = self._split(batch.method, result, batch.sizes)
            if on_card:
                torch.cuda.synchronize(device)
        ms = self._mstats(batch.method)
        ms.batches.inc()
        ms.batch_rows.inc(batch.rows)
        ms.padded_rows.inc(max(target, batch.rows))
        if self._trace.enabled:
            # one span chain per request (tid = request id): how long it
            # coalesced, the shared engine execution, the split
            t_done = self._clock()
            for req in batch.requests:
                self._trace.record(
                    "coalesce", req.enqueued, t_exec - req.enqueued,
                    tid=req.id, cat="serving",
                    args={"reason": batch.reason,
                          "batch_requests": len(batch.requests)})
                self._trace.record(
                    "execute", t_exec, t_split - t_exec, tid=req.id,
                    cat="serving",
                    args={"method": batch.method, "batch_rows": batch.rows,
                          "target_rows": target})
                self._trace.record("split", t_split, t_done - t_split,
                                   tid=req.id, cat="serving")
        return parts

    def _call_engine(self, method: str, payload, p: dict):
        e = self.engine
        if method == "trace":
            return e.trace(payload, p.get("ray_type", "closest"),
                           backend=p.get("backend"), t_min=p.get("t_min"),
                           max_rounds=p.get("max_rounds"))
        if method == "nearest":
            return e.nearest(payload, p["k"], p.get("metric", "euclidean"),
                             backend=p.get("backend"))
        if method == "within":
            return e.within(payload, p["radius"], p["k"],
                            p.get("metric", "euclidean"), backend=p.get("backend"))
        if method == "count_within":
            return e.count_within(payload, p["radius"],
                                  p.get("metric", "euclidean"),
                                  backend=p.get("backend"))
        if method == "scores":
            return e.scores(payload, p.get("metric", "euclidean"),
                            backend=p.get("backend"))
        raise ValueError(f"unknown method {method!r}")

    def _split(self, method: str, result, sizes):
        """Each request's rows of the batch's result, as views on the
        device; a trace's ``rounds``, the one batch-coupled field, is
        re-reduced per request as ``max(quadbox_jobs)`` in the engine's
        dtype (a ray is active for exactly ``quadbox_jobs`` consecutive
        rounds, so a request's round count is the max over its own rays,
        the invariant chunked dispatch relies on too)."""
        if isinstance(result, torch.Tensor):
            return [p for (p,) in slice_rows((result,), sizes)]
        if method != "trace":
            return slice_rows(result, sizes)
        cls, dtype = type(result), result.rounds.dtype
        qb = cls._fields.index("quadbox_jobs")
        return [cls(*p, rounds=p[qb].max().to(dtype))
                for p in slice_rows(tuple(result)[:-1], sizes)]

    # -- observability -----------------------------------------------------

    def _mstats(self, method: str) -> _MethodStats:
        ms = self._stats.get(method)
        if ms is None:
            ms = self._stats[method] = _MethodStats(self._obs, method)
        return ms

    def stats(self) -> dict:
        """Per-method :class:`ServerStats` for every method seen: a view
        over the server's metrics registry (the instrument values *are*
        the counts)."""
        out = {}
        for method, ms in self._stats.items():
            requests, batches = ms.requests.value, ms.batches.value
            batch_rows, padded = ms.batch_rows.value, ms.padded_rows.value
            out[method] = ServerStats(
                requests=requests, rows=ms.rows.value, batches=batches,
                queue_depth=self.coalescer.depth_for(method),
                requests_per_batch=(requests / batches if batches else 0.0),
                mean_batch_rows=(batch_rows / batches if batches else 0.0),
                mean_fill=(batch_rows / padded if padded else 0.0),
                flush_full=ms.flushes[FLUSH_FULL].value,
                flush_timer=ms.flushes[FLUSH_TIMER].value,
                flush_deadline=ms.flushes[FLUSH_DEADLINE].value,
                flush_drain=ms.flushes[FLUSH_DRAIN].value,
                shed=ms.shed.value,
                p50_ms=ms.latency_ms.percentile(0.50),
                p99_ms=ms.latency_ms.percentile(0.99))
        return out

    def admission_stats(self) -> AdmissionStats:
        return self.admission.stats()

    def _obs_source(self) -> dict:
        """This server's section of ``repro_torch.obs.snapshot()``
        (JSON-able: the non-finite percentile placeholders become None)."""

        def clean(v):
            return None if (isinstance(v, float) and not math.isfinite(v)) else v

        out = {method: {k: clean(v) for k, v in s._asdict().items()}
               for method, s in self.stats().items()}
        out["admission"] = self.admission.stats()._asdict()
        return out

    def __repr__(self):
        return (f"QueryServer(engine={self.engine!r}, "
                f"coalescer={self.coalescer!r}, "
                f"admission={self.admission!r}, "
                f"started={self._started})")
