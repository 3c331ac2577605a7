"""Admission control for the ray-query server (DESIGN.md §10).

The port's own copy of ``repro/serving/admission.py``: a pure-Python
state machine, the same in both packages.

A serving system dies by queue, not by kernel: under overload the only
choices are to make someone wait, to tell someone "no" fast, or to drop
the oldest work that nobody will wait for anyway.  This module is that
decision, factored out of the async machinery so it is a plain state
machine — unit-testable without an event loop, clock, or a single real
request (``tests/test_torch_serving.py``).

:class:`AdmissionController` tracks one number — requests admitted but
not yet completed (queued in the coalescer **plus** in flight on the
engine) — against a fixed ``limit``, under one of three policies:

* ``"block"`` — the submitter waits for capacity (classic backpressure;
  the async server parks the caller on a condition variable).
* ``"reject"`` — fast-fail: the submitter gets :class:`QueueFull`
  immediately, keeping the queue short and tail latency bounded.
* ``"shed"`` — admit the new request by dropping the *oldest still
  coalescing* request (its future fails with :class:`RequestShed`);
  when nothing is sheddable (everything admitted is already executing)
  the verdict degrades to ``"reject"`` — in-flight work is never killed.
"""
from __future__ import annotations

from typing import NamedTuple

__all__ = [
    "POLICIES",
    "AdmissionController",
    "AdmissionStats",
    "QueueFull",
    "RequestShed",
]

#: verdicts :meth:`AdmissionController.try_admit` can return
ADMIT, WAIT, REJECT, SHED = "admit", "wait", "reject", "shed"

POLICIES = ("block", "reject", "shed")


class QueueFull(RuntimeError):
    """The admission queue is at its limit and the policy fast-fails."""


class RequestShed(RuntimeError):
    """This request was dropped from the queue to admit newer work
    (``policy="shed"``)."""


class AdmissionStats(NamedTuple):
    depth: int  # admitted - completed (queued + in flight), right now
    limit: int
    admitted: int  # total ever admitted
    rejected: int  # total fast-failed at the door
    shed: int  # total evicted from the queue to admit newer work
    blocked: int  # total admissions that had to wait for capacity first


class AdmissionController:
    """Bounded-queue accounting + overload policy (no event-loop state:
    the async server owns the actual waiting and eviction; this object
    only rules on them and keeps the counters)."""

    def __init__(self, limit: int, policy: str = "block"):
        limit = int(limit)
        if limit < 1:
            raise ValueError(f"admission limit must be >= 1, got {limit}")
        if policy not in POLICIES:
            raise ValueError(
                f"unknown admission policy {policy!r} (want one of "
                f"{POLICIES})")
        self.limit = limit
        self.policy = policy
        self._depth = 0
        self._admitted = 0
        self._rejected = 0
        self._shed = 0
        self._blocked = 0

    @property
    def depth(self) -> int:
        return self._depth

    @property
    def has_capacity(self) -> bool:
        return self._depth < self.limit

    def try_admit(self) -> str:
        """Rule on one incoming request.  ``"admit"`` takes the slot
        immediately; ``"wait"`` / ``"reject"`` / ``"shed"`` tell the
        caller what the policy demands — the caller performs it and (for
        wait/shed) comes back via :meth:`admit_after_wait` /
        :meth:`admit_after_shed`."""
        if self._depth < self.limit:
            self._depth += 1
            self._admitted += 1
            return ADMIT
        if self.policy == "block":
            return WAIT
        if self.policy == "reject":
            self._rejected += 1
            return REJECT
        return SHED

    def admit_after_wait(self) -> None:
        """A blocked submitter found capacity: take the slot (counted as
        a blocked admission)."""
        if self._depth >= self.limit:
            raise RuntimeError("admit_after_wait without capacity")
        self._depth += 1
        self._admitted += 1
        self._blocked += 1

    def admit_after_shed(self) -> None:
        """A queued victim was evicted to admit the newcomer: the
        victim's slot transfers, so depth is unchanged."""
        self._admitted += 1
        self._shed += 1

    def shed_failed(self) -> None:
        """Nothing was sheddable (all admitted work is in flight): the
        newcomer is rejected instead."""
        self._rejected += 1

    def release(self, n: int = 1) -> None:
        """``n`` admitted requests completed (responded, failed, or were
        shed): their slots free up."""
        if n < 0 or n > self._depth:
            raise ValueError(
                f"release({n}) with depth {self._depth}")
        self._depth -= n

    def stats(self) -> AdmissionStats:
        return AdmissionStats(self._depth, self.limit, self._admitted,
                              self._rejected, self._shed, self._blocked)

    def __repr__(self):
        return (f"AdmissionController(limit={self.limit}, "
                f"policy={self.policy!r}, depth={self._depth})")
