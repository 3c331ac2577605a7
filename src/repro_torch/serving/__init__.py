"""Serving layer of the port: the LM token engine and the ray-query server.

* :class:`Engine` -- batched prefill + decode for the model stack.
* :class:`QueryServer` (+ :class:`Coalescer`, :class:`AdmissionController`)
  -- the async request-level server over ``repro_torch.api.QueryEngine``:
  continuous batching of many small trace / nearest / within /
  count_within / scores requests into whole batches, bit-identical to
  direct engine calls (DESIGN.md §10).
"""
from .admission import (  # noqa: F401
    AdmissionController,
    AdmissionStats,
    QueueFull,
    RequestShed,
)
from .batching import (  # noqa: F401
    FLUSH_DEADLINE,
    FLUSH_DRAIN,
    FLUSH_FULL,
    FLUSH_TIMER,
    Batch,
    Coalescer,
    Request,
)
from .engine import Engine  # noqa: F401
from .query_server import QueryServer, ServerStats  # noqa: F401

__all__ = [
    "AdmissionController",
    "AdmissionStats",
    "Batch",
    "Coalescer",
    "Engine",
    "FLUSH_DEADLINE",
    "FLUSH_DRAIN",
    "FLUSH_FULL",
    "FLUSH_TIMER",
    "QueryServer",
    "QueueFull",
    "Request",
    "RequestShed",
    "ServerStats",
]
