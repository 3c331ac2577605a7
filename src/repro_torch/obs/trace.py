"""Request-lifecycle trace spans + Chrome-trace/Perfetto export.

Metrics say *how much*; traces say *where the time went*.  This module
keeps a bounded in-memory buffer of completed spans — each a named
``(ts, dur)`` interval on a track — and exports them in the Chrome trace
event format (the JSON both ``chrome://tracing`` and Perfetto load
directly), so a serving run can be opened as a timeline: every request a
track, its admit → coalesce → execute → split phases laid end to end
(DESIGN.md §11).

Recording is gated the same way as metrics: the global buffer follows
the default registry's enabled flag, so with telemetry off a
``record()`` call is one attribute check + branch and touches nothing.
Timestamps are caller-provided floats in *seconds* on whatever monotonic
clock the caller runs (the serving layer records on its own injectable
clock — fake-clock tests produce perfectly consistent traces); export
converts to the microseconds the trace format wants.  Spans on one track
share a clock by construction; tracks from different subsystems may use
different clocks, which Chrome renders fine (each track is internally
ordered — the cross-track offset just isn't meaningful).

``annotate(name)`` additionally scopes a ``torch.profiler.record_function``
around device work when telemetry is enabled, so an active
``torch.profiler.profile`` labels the engine's execute windows beside its
kernels on the device timeline; with telemetry off it is a
``nullcontext``.  (The reference scopes a ``jax.profiler.TraceAnnotation``
there.)
"""
from __future__ import annotations

import json
import threading
from collections import deque
from contextlib import nullcontext
from typing import Optional

import torch

from .metrics import default_registry

__all__ = ["Span", "TraceBuffer", "annotate", "default_buffer",
           "export_chrome_trace"]

#: spans kept in the bounded global buffer (oldest dropped first — a
#: long-lived server exports windows, not unbounded history)
MAX_SPANS = 200_000


class Span:
    """One completed interval: ``name`` on track ``tid`` from ``ts`` for
    ``dur`` (seconds), with JSON-able ``args`` attached."""

    __slots__ = ("name", "cat", "ts", "dur", "tid", "args")

    def __init__(self, name: str, cat: str, ts: float, dur: float,
                 tid: int, args: Optional[dict] = None):
        self.name = name
        self.cat = cat
        self.ts = float(ts)
        self.dur = float(dur)
        self.tid = int(tid)
        self.args = args

    def to_event(self) -> dict:
        """This span as one Chrome trace 'complete' (``ph: "X"``) event;
        seconds -> integer microseconds."""
        ev = {
            "name": self.name,
            "cat": self.cat,
            "ph": "X",
            "ts": int(round(self.ts * 1e6)),
            "dur": int(round(self.dur * 1e6)),
            "pid": 0,
            "tid": self.tid,
        }
        if self.args:
            ev["args"] = self.args
        return ev

    def __repr__(self):
        return (f"Span({self.name!r}, tid={self.tid}, ts={self.ts:.6f}, "
                f"dur={self.dur:.6f})")


class TraceBuffer:
    """Bounded, thread-safe span sink.

    ``enabled=None`` (the global default buffer) follows the default
    metrics registry's switch; an explicit bool pins it (tests construct
    private always-on buffers).  ``record`` may be called from any
    thread — the serving worker records execute/split spans off the event
    loop."""

    def __init__(self, enabled: Optional[bool] = None,
                 max_spans: int = MAX_SPANS):
        self._enabled = enabled
        self._spans: deque = deque(maxlen=max_spans)
        self._lock = threading.Lock()

    @property
    def enabled(self) -> bool:
        if self._enabled is None:
            return default_registry().enabled
        return self._enabled

    def record(self, name: str, ts: float, dur: float, *, tid: int = 0,
               cat: str = "repro", args: Optional[dict] = None) -> None:
        if not self.enabled:
            return
        with self._lock:
            self._spans.append(Span(name, cat, ts, dur, tid, args))

    def spans(self) -> list:
        with self._lock:
            return list(self._spans)

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()

    def __len__(self) -> int:
        return len(self._spans)

    # -- export ------------------------------------------------------------

    def to_chrome_trace(self) -> dict:
        """The buffer as a Chrome trace object: ``{"traceEvents": [...],
        "displayTimeUnit": "ms"}`` — the shape Perfetto and
        chrome://tracing both open as-is."""
        return {
            "traceEvents": [s.to_event() for s in self.spans()],
            "displayTimeUnit": "ms",
        }

    def export_chrome_trace(self, path: str) -> int:
        """Write the Chrome-trace JSON to ``path``; returns the number of
        events written."""
        trace = self.to_chrome_trace()
        with open(path, "w") as f:
            json.dump(trace, f)
            f.write("\n")
        return len(trace["traceEvents"])

    def __repr__(self):
        return f"TraceBuffer(spans={len(self)}, enabled={self.enabled})"


_DEFAULT = TraceBuffer(enabled=None)


def default_buffer() -> TraceBuffer:
    return _DEFAULT


def export_chrome_trace(path: str,
                        buffer: Optional[TraceBuffer] = None) -> int:
    """Export a trace buffer (the global one by default) as Chrome-trace
    JSON at ``path``; returns the event count."""
    return (buffer or _DEFAULT).export_chrome_trace(path)


def annotate(name: str):
    """A ``torch.profiler.record_function`` scope when telemetry is
    enabled (so an active profiler labels the device work), a no-op
    context otherwise."""
    if not default_registry().enabled:
        return nullcontext()
    return torch.profiler.record_function(name)
