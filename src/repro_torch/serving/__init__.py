"""Serving layer of the port: the ray-query server.

:class:`QueryServer` (+ :class:`Coalescer`, :class:`AdmissionController`)
is the async request-level server over ``repro_torch.api.QueryEngine``:
continuous batching of many small trace / nearest / within /
count_within / scores requests into whole batches, bit-identical to
direct engine calls (DESIGN.md §10).  The reference's LM token engine
(``repro.serving.Engine``) is not ported yet: it waits for the LM stack.
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
from .query_server import QueryServer, ServerStats  # noqa: F401

__all__ = [
    "AdmissionController",
    "AdmissionStats",
    "Batch",
    "Coalescer",
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
