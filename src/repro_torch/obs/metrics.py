"""Metrics registry: counters, gauges, and streaming histograms.

The port's own copy of ``repro/obs/metrics.py`` (dependency-free, so it
runs unchanged; kept here because the port imports nothing of
``repro``).  One registry for every counter the port keeps (DESIGN.md
§11): the engine's call, row, cache and job accounting, the serving
layer's request accounting, and the compile counter.

Design constraints, in order:

1. **Disabled is free.**  The process-global default registry starts
   ``enabled=False``.  Instruments exist either way (callers pre-create
   them at import time and hold direct references), but every hot-path
   mutator (``Counter.inc`` / ``Gauge.set`` / ``Histogram.observe``)
   begins with one attribute read + branch and returns without touching
   any state.  ``tests/test_torch_obs.py`` pins the no-op behavior and
   the engine-result bit-parity on/off.
2. **Dependency-free.**  Plain Python; histograms are fixed
   log-spaced bins, not a sketch library.
3. **JSON-able.**  ``MetricsRegistry.snapshot()`` returns nothing but
   dicts / lists / numbers / strings.

Instruments are identified by flat dotted names (``engine.cache.hits``,
``serving.trace.requests``); asking a registry for the same name twice
returns the *same* instrument object.

Thread-safety: increments are plain Python read-modify-writes under the
GIL.  Concurrent writers can lose an increment under contention; that is
the standard telemetry trade and never perturbs query results.  The
serving layer keeps its exact request accounting on a private
always-enabled registry with a single writer per instrument.
"""
from __future__ import annotations

import math
from typing import Optional

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "default_registry",
]

#: histogram bucket geometry: value -> bucket ``floor(log2(v / V0))``,
#: clamped to [0, BINS).  V0 = 1e-6 with 64 doubling bins spans 1e-6 ..
#: ~1.8e13 in whatever unit the caller observes (ms, rows, jobs) — wide
#: enough that the clamp is never the interesting signal.
HIST_V0 = 1e-6
HIST_BINS = 64


class Counter:
    """Monotonic counter.  ``inc`` is a no-op while the owning registry
    is disabled."""

    __slots__ = ("name", "_reg", "value")

    def __init__(self, name: str, reg: "MetricsRegistry"):
        self.name = name
        self._reg = reg
        self.value = 0

    def inc(self, n: int = 1) -> None:
        if self._reg.enabled:
            self.value += n

    def __repr__(self):
        return f"Counter({self.name}={self.value})"


class Gauge:
    """Last-write-wins scalar (shard fan-out, queue depth, ...)."""

    __slots__ = ("name", "_reg", "value")

    def __init__(self, name: str, reg: "MetricsRegistry"):
        self.name = name
        self._reg = reg
        self.value = 0.0

    def set(self, v: float) -> None:
        if self._reg.enabled:
            self.value = float(v)

    def __repr__(self):
        return f"Gauge({self.name}={self.value})"


class Histogram:
    """Streaming histogram over fixed log2-spaced bins.

    O(1) ``observe``, O(bins) percentile queries.  A percentile answer is
    the *upper edge* of the bucket holding that rank, clamped to the
    observed [min, max] — so ``percentile(q)`` is always within one
    bucket factor (2x) of the true order statistic, which is the
    resolution latency telemetry needs (``tests/test_torch_obs.py``
    pins the bound).  Values below ``HIST_V0`` (including 0) land in bucket 0 and
    report via the min clamp exactly.
    """

    __slots__ = ("name", "_reg", "count", "sum", "min", "max", "buckets")

    def __init__(self, name: str, reg: "MetricsRegistry"):
        self.name = name
        self._reg = reg
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf
        self.buckets = [0] * HIST_BINS

    def observe(self, v: float) -> None:
        if not self._reg.enabled:
            return
        v = float(v)
        self.count += 1
        self.sum += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v
        if v <= HIST_V0:
            idx = 0
        else:
            idx = min(HIST_BINS - 1, int(math.log2(v / HIST_V0)))
        self.buckets[idx] += 1

    def percentile(self, q: float) -> float:
        """Upper-edge estimate of the ``q``-quantile (0 <= q <= 1);
        NaN when nothing was observed."""
        if self.count == 0:
            return math.nan
        rank = max(1, math.ceil(q * self.count))
        seen = 0
        for i, b in enumerate(self.buckets):
            seen += b
            if seen >= rank:
                upper = HIST_V0 * (2.0 ** (i + 1))
                return max(self.min, min(self.max, upper))
        return self.max  # unreachable: counts sum to self.count

    def mean(self) -> float:
        return self.sum / self.count if self.count else math.nan

    def __repr__(self):
        return (f"Histogram({self.name}: n={self.count}, "
                f"p50={self.percentile(0.5):.4g})")


class MetricsRegistry:
    """A named family of instruments with one on/off switch.

    The process-global default (``default_registry()``) ships disabled;
    ``repro_torch.obs.enable()`` flips it.  Subsystems that must always count
    (the serving layer's request accounting, whose ``stats()`` surface
    predates telemetry) own private ``MetricsRegistry(enabled=True)``
    instances and attach them to the global snapshot as *sources*
    (``repro_torch.obs.register_source``).
    """

    def __init__(self, enabled: bool = False, name: str = ""):
        self.enabled = bool(enabled)
        self.name = name
        self._counters: dict[str, Counter] = {}
        self._gauges: dict[str, Gauge] = {}
        self._histograms: dict[str, Histogram] = {}

    # -- instrument resolution (same name -> same object, any time) -------

    def counter(self, name: str) -> Counter:
        c = self._counters.get(name)
        if c is None:
            c = self._counters[name] = Counter(name, self)
        return c

    def gauge(self, name: str) -> Gauge:
        g = self._gauges.get(name)
        if g is None:
            g = self._gauges[name] = Gauge(name, self)
        return g

    def histogram(self, name: str) -> Histogram:
        h = self._histograms.get(name)
        if h is None:
            h = self._histograms[name] = Histogram(name, self)
        return h

    # -- lifecycle ---------------------------------------------------------

    def enable(self) -> None:
        self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    def reset(self) -> None:
        """Zero every instrument (identity preserved: held references
        stay valid — their values reset in place)."""
        for c in self._counters.values():
            c.value = 0
        for g in self._gauges.values():
            g.value = 0.0
        for h in self._histograms.values():
            h.count = 0
            h.sum = 0.0
            h.min = math.inf
            h.max = -math.inf
            h.buckets = [0] * HIST_BINS

    # -- export ------------------------------------------------------------

    def snapshot(self) -> dict:
        """Stable JSON-able view: ``{"counters": {...}, "gauges": {...},
        "histograms": {name: {count,sum,min,max,mean,p50,p99}}}``.
        Instruments that never fired are included at their zero state, so
        the key set is stable once the process has created them."""
        hists = {}
        for name, h in sorted(self._histograms.items()):
            hists[name] = {
                "count": h.count,
                "sum": h.sum,
                "min": None if h.count == 0 else h.min,
                "max": None if h.count == 0 else h.max,
                "mean": None if h.count == 0 else h.mean(),
                "p50": None if h.count == 0 else h.percentile(0.50),
                "p99": None if h.count == 0 else h.percentile(0.99),
            }
        return {
            "counters": {n: c.value
                         for n, c in sorted(self._counters.items())},
            "gauges": {n: g.value for n, g in sorted(self._gauges.items())},
            "histograms": hists,
        }

    def __repr__(self):
        return (f"MetricsRegistry(name={self.name!r}, "
                f"enabled={self.enabled}, "
                f"instruments={len(self._counters) + len(self._gauges) + len(self._histograms)})")


#: the process-global registry every built-in subsystem records into
#: (disabled by default: telemetry is strictly opt-in)
_DEFAULT = MetricsRegistry(enabled=False, name="default")


def default_registry() -> MetricsRegistry:
    return _DEFAULT
