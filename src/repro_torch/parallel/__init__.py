"""Parallelism context of the port (one device for now)."""
from .ctx import NO_PARALLEL, ParallelCtx  # noqa: F401
