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


# ---------------------------------------------------------------------------
# Unified operand layout (rows x jobs), one job per column: the paper's
# single union input bundle (Table V / §III-C).  Every mode's fields live at
# fixed rows; modes ignore rows they do not use.  The port's own copy of
# the reference's layout (``repro/kernels/common.py``).
# ---------------------------------------------------------------------------
ROW_ORG = 0  # rows 0..2   ray origin            (quadbox, triangle)
ROW_INV = 3  # rows 3..5   ray inverse direction (quadbox)
ROW_NEG = 6  # rows 6..8   ray direction sign    (quadbox: 1.0 if signbit)
ROW_SHEAR = 3  # rows 3..5   ray shear Sx,Sy,Sz  (triangle; shares the INV rows)
ROW_K = 6  # rows 6..8   kx,ky,kz as f32          (triangle; shares the NEG rows)
ROW_BOX_LO = 9  # rows 9..20   4 boxes x 3 dims (quadbox; shares VEC_A rows)
ROW_BOX_HI = 25  # rows 25..36  4 boxes x 3 dims (quadbox; shares VEC_B rows)
ROW_TRI_A = 9  # rows 9..11   vertex A (triangle)
ROW_TRI_B = 12  # rows 12..14  vertex B
ROW_TRI_C = 15  # rows 15..17  vertex C
ROW_VEC_A = 9  # rows 9..24   vector a / q, 16 lanes-of-dimension (euclid/ang)
ROW_VEC_B = 25  # rows 25..40  vector b / c
ROW_MASK = 41  # row 41       live-lane count (lanes i < count are live)
ROW_RESET = 42  # row 42      accumulator reset flag (1.0/0.0)
N_OPERAND_ROWS = 48

# Unified output layout (rows x jobs).
OUT_TMIN = 0  # rows 0..3   sorted tmin          (quadbox)
OUT_IDX = 4  # rows 4..7    sorted box indices   (quadbox, as f32)
OUT_HIT = 8  # rows 8..11   sorted hit mask      (quadbox, as f32)
OUT_TNUM = 0  # row 0       t_num                (triangle)
OUT_TDENOM = 1  # row 1     t_denom              (triangle)
OUT_THIT = 2  # row 2       hit                  (triangle)
OUT_EUCLID = 0  # row 0     accumulator          (euclidean)
OUT_DOT = 0  # row 0        dot product          (angular)
OUT_NORM = 1  # row 1       norm                 (angular)
OUT_RESET = 12  # row 12    propagated reset     (euclid/angular)
N_OUTPUT_ROWS = 16


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
