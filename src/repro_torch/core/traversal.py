"""Traversal constants shared by the port's engines.

The port's counterpart of ``repro/core/traversal.py``.  Only the stack
size is ported so far; the per-ray ``trace_ray`` oracle comes in a later
slice.
"""
STACK_SIZE = 64  # DatapathConfig default (DEFAULT_CONFIG.stack_size)
