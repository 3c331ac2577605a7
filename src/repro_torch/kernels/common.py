"""Shared kernel-side constants and comparator semantics.

The port's counterpart of ``repro/kernels/common.py``.  ``LANES`` is the
CUDA backend's batch multiple: 128 rays per thread block.  It is kept
equal to the reference's tile width for plan parity (the session layer
pads every batch to whole blocks exactly as the reference pads to whole
tiles), not for the TPU's lane-width reasons.

The reference's row helpers (``fmax_rows``, ``fmin_rows``,
``quadsort_rows``, ``select_dim``) have no Python counterpart here: their
semantics (a false compare, as every compare with NaN is, keeps the
second operand; the sort network exchanges on a false compare) live in
``core/datapath.py`` for the plain path and in ``csrc/datapath.cuh`` for
the kernels.
"""
from __future__ import annotations

import torch

LANES = 128  # rays per thread block of the CUDA kernels


def ceil_to(x: int, m: int) -> int:
    return -(-x // m) * m


def pad_cols(x: torch.Tensor, n_to: int, value=0.0) -> torch.Tensor:
    """Pad the last (job) axis to ``n_to`` columns with a constant."""
    pad = n_to - x.shape[-1]
    if pad == 0:
        return x
    fill = torch.full(x.shape[:-1] + (pad,), value, dtype=x.dtype,
                      device=x.device)
    return torch.cat([x, fill], dim=-1)
