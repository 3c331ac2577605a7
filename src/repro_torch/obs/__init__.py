"""``repro_torch.obs``: the port's telemetry plane (DESIGN.md §11).

The counterpart of ``repro.obs``, with its names and semantics.  One
switch, three signals, one export surface:

* **Metrics**: :class:`MetricsRegistry` counters / gauges / streaming
  histograms (``obs/metrics.py``).  The engine records per-call wall
  time (after synchronizing its device), run-function cache hits vs
  misses, pad waste (padded vs real rows), chunk and shard fan-out, and
  datapath job totals per backend; the serving layer routes its request
  accounting through a registry of its own.
* **Compile events**: :class:`CompileTracker` (``obs/compile.py``), a
  window over the process's count of kernel-library builds and new
  engine keys, so "steady-state compiles == 0" is a servable metric.
* **Traces**: request-lifecycle spans (admit -> coalesce -> execute ->
  split per served request) in a bounded buffer, exported as
  Chrome-trace / Perfetto JSON (``obs/trace.py``); while telemetry is on,
  the engine's calls are ``torch.profiler.record_function`` scopes.

Everything is **off by default** and free while off: recording sites
pre-resolve their instruments and the disabled path is one attribute
check + branch, so engine and serving results are bit-identical with
telemetry disabled and enabled (``tests/test_torch_obs.py``).

Quickstart::

    from repro_torch import obs

    obs.enable()
    ... run queries / serve traffic ...
    print(obs.snapshot())                    # JSON-able dict
    obs.export_chrome_trace("trace.json")    # open in Perfetto

    with obs.CompileTracker() as t:
        engine.trace(rays)                   # warm steady state
    assert t.compiles == 0

``python -m repro_torch.obs.dump`` pretty-prints a snapshot (current
process, or a previously saved file).
"""
from __future__ import annotations

import weakref
from typing import Callable

from .compile import CompileTracker, hook_installed, install_hook, total_compiles  # noqa: F401
from .metrics import Counter, Gauge, Histogram, MetricsRegistry, default_registry  # noqa: F401
from .trace import TraceBuffer, annotate, default_buffer, export_chrome_trace  # noqa: F401

__all__ = [
    "CompileTracker",
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "TraceBuffer",
    "annotate",
    "default_buffer",
    "default_registry",
    "disable",
    "enable",
    "export_chrome_trace",
    "install_hook",
    "is_enabled",
    "register_source",
    "registry",
    "snapshot",
    "total_compiles",
    "unregister_source",
    "write_snapshot",
]

#: named snapshot sources: subsystems that keep their own always-on
#: registries (the serving layer) attach a zero-arg dict provider here;
#: stored as weak references so a dropped QueryServer vanishes from
#: snapshots instead of pinning the object alive
_SOURCES: dict[str, object] = {}


def registry() -> MetricsRegistry:
    """The process-global default registry (disabled until
    :func:`enable`)."""
    return default_registry()


def enable() -> None:
    """Turn the telemetry plane on: the default registry records, the
    span buffer records, and the compile hook goes in (so
    ``snapshot()['jit']['compiles']`` counts from here on)."""
    install_hook()
    default_registry().enable()


def disable() -> None:
    """Turn recording off.  The compile hook stays installed, as the
    reference's does: it only bumps one integer per compile event."""
    default_registry().disable()


def is_enabled() -> bool:
    return default_registry().enabled


def register_source(name: str, provider: Callable[[], dict]) -> str:
    """Attach a named snapshot section: ``provider()`` must return a
    JSON-able dict; it is held weakly (bound methods via ``WeakMethod``)
    and called at :func:`snapshot` time.  Returns the (possibly
    ``#n``-suffixed, if taken) name actually registered."""
    base, n = name, 1
    while name in _SOURCES and _deref(_SOURCES[name]) is not None:
        n += 1
        name = f"{base}#{n}"
    try:
        ref: object = weakref.WeakMethod(provider)  # bound method
    except TypeError:
        ref = weakref.ref(provider)  # plain function / callable object
    _SOURCES[name] = ref
    return name


def unregister_source(name: str) -> None:
    _SOURCES.pop(name, None)


def _deref(ref):
    try:
        return ref()
    except Exception:
        return None


def snapshot() -> dict:
    """One stable JSON-able view of the whole telemetry plane::

        {
          "enabled": bool,
          "jit": {"hook_installed": bool, "compiles": int},
          "counters" / "gauges" / "histograms": {...},   # default registry
          "derived": {"pad_waste_fraction": float|None,
                      "cache_hit_rate": float|None},
          "trace": {"spans": int},
          "sources": {"serving": {...}, ...},            # live attachments
        }

    ``pad_waste_fraction`` is 1 - real/padded over every engine call
    recorded so far; ``cache_hit_rate`` is hits/(hits+misses) of the
    engine's run-function keys (``QueryEngine.cache_info``).  Both are
    None until the engine has recorded at least one call.
    """
    reg = default_registry()
    snap = reg.snapshot()
    counters = snap["counters"]
    real = counters.get("engine.rows.real", 0)
    padded = counters.get("engine.rows.padded", 0)
    hits = counters.get("engine.cache.hits", 0)
    misses = counters.get("engine.cache.misses", 0)
    sources = {}
    for name, ref in list(_SOURCES.items()):
        provider = _deref(ref)
        if provider is None:
            _SOURCES.pop(name, None)
            continue
        sources[name] = provider()
    return {
        "enabled": reg.enabled,
        "jit": {"hook_installed": hook_installed(),
                "compiles": total_compiles()},
        "counters": counters,
        "gauges": snap["gauges"],
        "histograms": snap["histograms"],
        "derived": {
            "pad_waste_fraction": (1.0 - real / padded) if padded else None,
            "cache_hit_rate": (hits / (hits + misses)
                               if (hits + misses) else None),
        },
        "trace": {"spans": len(default_buffer())},
        "sources": sources,
    }


def write_snapshot(path: str) -> dict:
    """Dump :func:`snapshot` as JSON at ``path`` (CI artifact form);
    returns the snapshot."""
    import json
    snap = snapshot()
    with open(path, "w") as f:
        json.dump(snap, f, indent=2, sort_keys=True)
        f.write("\n")
    return snap
