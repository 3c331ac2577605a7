"""Chunked query execution mechanics, single device.

The port's counterpart of ``repro/core/dispatch.py``.  One query runs as
``pad -> query -> unpad``: the batch is cut into fixed-size blocks (the
whole batch, or ``chunk_size`` rows), each padded to the backend's row
multiple by repeating the block's row 0 (always a valid element), and
the per-row results are stitched back and sliced to the caller's rows.
Per-block scalar statistics (``rounds``) reduce by ``max``, which equals
the one-call value (a ray is active for exactly ``quadbox_jobs``
consecutive rounds wherever it runs).

``shard="auto" | int`` resolves through :func:`resolve_shards`.  As in
the reference, ``"auto"`` is the devices the engine shards over, capped
at the batch, and an explicit count above the data's device count raises
``ValueError``.  The fan-out over several cards is not ported yet, so the
port shards over one card: ``"auto"`` resolves to 1 on a host with any
number of cards, and an explicit count above 1 that the cards could serve
raises ``NotImplementedError``.
"""
from __future__ import annotations

import math
import numbers
from typing import NamedTuple, Optional

import torch


def check_count(name: str, value, minimum: int = 1) -> Optional[int]:
    """Validate an integral execution knob: ``None`` passes through;
    anything else must be a true integer ``>= minimum``."""
    if value is None:
        return None
    if isinstance(value, bool) or not isinstance(value, numbers.Integral):
        raise ValueError(f"{name} must be an int >= {minimum}, got {value!r} "
                         f"({type(value).__name__})")
    if value < minimum:
        raise ValueError(f"{name} must be >= {minimum}, got {value!r}")
    return int(value)


def available_devices(device=None) -> int:
    """The devices that hold data on ``device`` (default CUDA): the CUDA
    device count, 1 on the CPU.  An explicit shard count may not exceed
    it."""
    device = torch.device("cuda" if device is None else device)
    return torch.cuda.device_count() if device.type == "cuda" else 1


#: the devices one query fans out over; the fan-out over several cards is
#: not ported yet
SHARDABLE_DEVICES = 1


def resolve_shards(shard, n_rows: Optional[int] = None, device=None) -> int:
    """``shard="auto" | int | None`` -> a concrete shard count for data on
    ``device``.  ``"auto"`` is :data:`SHARDABLE_DEVICES` capped at the
    batch; an explicit count must be a positive integer no larger than
    :func:`available_devices` (``ValueError`` otherwise), and a count
    above 1 raises ``NotImplementedError``."""
    if shard is None:
        return 1
    if isinstance(shard, str):
        if shard != "auto":
            raise ValueError(f"shard must be 'auto' or an int >= 1, got {shard!r}")
        shards = SHARDABLE_DEVICES
        if n_rows is not None:
            shards = min(shards, n_rows)
        return max(1, shards)
    shards = check_count("shard", shard)
    n_dev = available_devices(device)
    if shards > max(n_dev, 1):
        raise ValueError(f"shard={shards} exceeds the {n_dev} available device(s)")
    if shards > 1:
        raise NotImplementedError(
            f"shard={shards}: the fan-out over several cards is not ported "
            "yet (repro_torch runs on one)")
    return shards


def ceil_to(n: int, multiple: int) -> int:
    return max(1, -(-n // multiple) * multiple)


def _make(like, leaves):
    """A tuple or NamedTuple of the same type as ``like`` over ``leaves``."""
    return type(like)(*leaves) if hasattr(like, "_fields") else tuple(leaves)


def _map(fn, tree):
    """Apply ``fn`` to every tensor leaf of a (Named)tuple of tensors."""
    return _make(tree, [fn(x) for x in tree])


def pad_leading(tree, n_to: int):
    """Pad every leading-axis leaf to ``n_to`` rows by repeating row 0
    (zeros for an empty batch)."""
    def pad(x):
        n = x.shape[0]
        if n == n_to:
            return x
        if n:
            rep = x[:1].expand((n_to - n,) + tuple(x.shape[1:]))
        else:
            rep = torch.zeros((n_to - n,) + tuple(x.shape[1:]), dtype=x.dtype,
                              device=x.device)
        return torch.cat([x, rep], dim=0)

    return _map(pad, tree)


class ExecPlan(NamedTuple):
    """A resolved (rows, chunking) schedule for one query."""

    n: int  # caller's row count (> 0)
    block: int  # rows per executed call, a multiple of the row multiple
    n_blocks: int  # ceil(n / block)
    shards: int = 1

    @property
    def key(self) -> tuple:
        """The plan's part of a built-function cache key."""
        return (self.shards, self.block)


def make_plan(n: int, *, pad_multiple: int, shards: int = 1,
              chunk_size: Optional[int] = None,
              lane_multiple: Optional[int] = None) -> ExecPlan:
    """Schedule ``n`` rows into fixed-size blocks of ``chunk_size`` (the
    whole batch when None) rounded up to ``max(pad_multiple,
    lane_multiple)``."""
    if n <= 0:
        raise ValueError("make_plan needs n >= 1; guard empty batches first")
    shards = check_count("shards", shards)
    chunk_size = check_count("chunk_size", chunk_size)
    multiple = (pad_multiple if lane_multiple is None
                else max(pad_multiple, int(lane_multiple)))
    rows = n if chunk_size is None else min(chunk_size, n)
    block = ceil_to(math.ceil(rows / shards), multiple) * shards
    return ExecPlan(n=n, block=block, n_blocks=-(-n // block), shards=shards)


def split_blocks(tree, plan: ExecPlan):
    """Yield the plan's padded blocks, each exactly ``plan.block`` rows."""
    for i in range(plan.n_blocks):
        lo = i * plan.block
        yield pad_leading(_map(lambda x: x[lo:lo + plan.block], tree),
                          plan.block)


def slice_rows(tree, sizes):
    """Split per-row leaves into consecutive row groups of ``sizes``;
    rows beyond ``sum(sizes)`` are dropped."""
    out, lo = [], 0
    for s in sizes:
        s = int(s)
        if s < 0:
            raise ValueError(f"slice sizes must be >= 0, got {s}")
        out.append(_map(lambda x, lo=lo, hi=lo + s: x[lo:hi], tree))
        lo += s
    return out


def concat_rows(blocks: list, n: int):
    """Stitch per-row block results together and slice to ``n`` rows."""
    out = blocks[0] if len(blocks) == 1 else _make(
        blocks[0], [torch.cat(xs, dim=0) for xs in zip(*blocks)])
    return _map(lambda x: x[:n], out)
