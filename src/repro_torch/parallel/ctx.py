"""Parallelism context threaded through the model stack.

The reference's ``ParallelCtx`` places sharding constraints by logical
axis names resolved against a device mesh; without a mesh every helper is
an identity.  The port runs on one device, so every helper here is that
identity.  A context given a mesh raises: sharding over several cards
(``torch.distributed`` ``DeviceMesh``) is still to port (``ROADMAP.md``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional


@dataclasses.dataclass(frozen=True)
class ParallelCtx:
    mesh: Optional[Any] = None

    def __post_init__(self):
        if self.mesh is not None:
            raise NotImplementedError(
                "repro_torch runs on one device: a ParallelCtx over a mesh "
                "waits for parallel/* on DeviceMesh (ROADMAP.md)")

    def shard(self, x, *axes):
        """Constrain ``x`` to the named axes: the identity on one device."""
        return x

    def act_btd(self, x):
        """(batch, seq, d_model)."""
        return x

    def act_bthd(self, x):
        """(batch, seq, heads, head_dim)."""
        return x

    def act_btf(self, x):
        """(batch, seq, d_ff)."""
        return x

    def act_btv(self, x):
        """(batch, seq, vocab)."""
        return x

    def kv_cache(self, x):
        """(batch, s_max, kv_heads, head_dim) KV cache."""
        return x


NO_PARALLEL = ParallelCtx()
