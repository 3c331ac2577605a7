"""Compile-event tracking: count what the port compiles as a first-class
metric.

The port's counterpart of ``repro/obs/compile.py``, with its API
(:func:`install_hook`, :func:`hook_installed`, :func:`total_compiles`,
:class:`CompileTracker`) and its instrument names, so that a snapshot
reads the same keys in both packages.  The reference counts jit retraces
through a hook around jax's jaxpr creation.  The port has no jit; what it
compiles, process-wide, is

* a build of the CUDA kernel library (``kernels/nvcc.build``), counted
  when ``nvcc`` really runs, not when a built library is found on disk;
* a run function built for an engine key it has not seen before (a miss
  of ``QueryEngine._cached_run``: the step whose counterpart in the
  reference traces and compiles a program).

Both sites call :func:`record_compile`.  :func:`install_hook` patches
nothing: it switches the counting on, and until something calls it
:func:`total_compiles` reads 0, as the reference's does before its hook
is in.  Once installed it stays installed.  ``snapshot()["jit"]
["compiles"]`` and the ``jit.retraces`` counter of the default registry
(while it is enabled) both count these events.

:class:`CompileTracker` is a window over the monotonic process total::

    with CompileTracker() as t:
        engine.trace(rays)        # steady state: every key seen before
    assert t.compiles == 0

Nested and overlapping trackers are fine: each subtracts its own
baseline.
"""
from __future__ import annotations

from typing import Optional

from .metrics import default_registry

__all__ = ["CompileTracker", "hook_installed", "install_hook", "record_compile",
           "total_compiles"]

#: monotonic process-wide compile count (valid once the hook is in)
_COUNT = [0]
_INSTALLED = False

#: pre-created so the recording path is one attribute check
_RETRACES = default_registry().counter("jit.retraces")


def install_hook() -> bool:
    """Switch compile counting on (idempotent).  Always available in the
    port: returns True."""
    global _INSTALLED
    _INSTALLED = True
    return True


def hook_installed() -> bool:
    return _INSTALLED


def record_compile() -> None:
    """Count one compile event (a kernel-library build or a new engine
    key); a no-op until :func:`install_hook`."""
    if _INSTALLED:
        _COUNT[0] += 1
        _RETRACES.inc()


def total_compiles() -> int:
    """Process-wide compile events since the hook went in (0 before)."""
    return _COUNT[0]


class CompileTracker:
    """A window over the process compile counter.

    Use as a context manager or via explicit :meth:`start` /
    :meth:`stop`; :attr:`compiles` is the number of compile events inside
    the window.  Constructing a tracker installs the hook if it is not in
    yet.
    """

    def __init__(self):
        self.available = install_hook()
        self._start: Optional[int] = None
        self._stop: Optional[int] = None

    def start(self) -> "CompileTracker":
        self._start = _COUNT[0]
        self._stop = None
        return self

    def stop(self) -> int:
        self._stop = _COUNT[0]
        return self.compiles

    @property
    def compiles(self) -> int:
        """Compile events since :meth:`start` (live while the window is
        open, frozen once stopped; 0 before the window opens)."""
        if self._start is None:
            return 0
        end = _COUNT[0] if self._stop is None else self._stop
        return end - self._start

    def __enter__(self) -> "CompileTracker":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def __repr__(self):
        return (f"CompileTracker(compiles={self.compiles}, "
                f"available={self.available})")
