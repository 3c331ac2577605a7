"""Unified mixed-opcode stream kernel wrapper (``csrc/unified.cu``) and its
plain version.

The port's counterpart of ``repro/kernels/unified.py``: one beat per
opcode, 128 lane-streams per beat, operands and outputs in the union row
layout of :mod:`.common` (column ``beat * 128 + lane``).  On CUDA tensors
:func:`unified` launches the hand-written kernel; on CPU tensors it runs
:func:`unified_plain`.

The semantics are the TPU kernel's, which differ from the in-order oracle
``core.stream.unified_stream`` in two ways that both packages share: the
lane mask arrives as a count (lanes ``i < count`` are live, so a mask with
holes counts as its prefix), and every output row the opcode does not
write is zero.  An opcode outside 0..3 is clamped, as ``lax.switch``
clamps the reference's branch index.
"""
from __future__ import annotations

import torch

from ..core.datapath import angular_partial, euclidean_partial
from ..core.types import (
    ANGULAR_LANES,
    OP_ANGULAR,
    OP_EUCLIDEAN,
    OP_QUADBOX,
    OP_TRIANGLE,
    VECTOR_LANES,
)
from . import nvcc
from .common import (
    LANES,
    N_OPERAND_ROWS,
    N_OUTPUT_ROWS,
    OUT_DOT,
    OUT_EUCLID,
    OUT_HIT,
    OUT_IDX,
    OUT_NORM,
    OUT_RESET,
    OUT_TDENOM,
    OUT_THIT,
    OUT_TMIN,
    OUT_TNUM,
    ROW_BOX_HI,
    ROW_BOX_LO,
    ROW_INV,
    ROW_K,
    ROW_MASK,
    ROW_NEG,
    ROW_ORG,
    ROW_RESET,
    ROW_SHEAR,
    ROW_TRI_A,
    ROW_TRI_B,
    ROW_TRI_C,
    ROW_VEC_A,
    ROW_VEC_B,
)
from .raybox import raybox_plain
from .raytri import raytri_plain


def _check_shapes(opcodes: torch.Tensor, operands: torch.Tensor) -> int:
    if opcodes.dim() != 1:
        raise ValueError(f"opcodes: expected (T,), got {tuple(opcodes.shape)}")
    t = opcodes.shape[0]
    if tuple(operands.shape) != (N_OPERAND_ROWS, t * LANES):
        raise ValueError(f"operands: expected {(N_OPERAND_ROWS, t * LANES)} for "
                         f"{t} beats, got {tuple(operands.shape)}")
    return t


def _accumulate(partials: list[torch.Tensor], reset: torch.Tensor) -> list[torch.Tensor]:
    """The in-order accumulator chains of one mode: each of ``partials``
    and ``reset`` is (beats, LANES).  An accumulator starts at +0.0; a
    reset adds +0.0 in place of the running sum."""
    accs = [torch.empty_like(p) for p in partials]
    for p, acc in zip(partials, accs):
        run = torch.zeros(LANES, dtype=torch.float32, device=reset.device)
        for j in range(reset.shape[0]):
            run = torch.add(p[j], torch.where(reset[j], 0.0, run), out=acc[j])
    return accs


def unified_plain(opcodes: torch.Tensor, operands: torch.Tensor) -> torch.Tensor:
    """:func:`unified` in plain PyTorch (any device).

    The stateless work (box and triangle beats, the vector beats' partials)
    runs on all beats of an opcode at once through the ``core.datapath``
    units; only the accumulator chain loops, over the vector beats."""
    t = _check_shapes(opcodes, operands)
    dev = operands.device
    out = torch.zeros((N_OUTPUT_ROWS, t * LANES), dtype=torch.float32, device=dev)
    mode = opcodes.to(torch.int64).clamp(0, 3)
    lanes = torch.arange(LANES, device=dev)

    def columns(op):
        beats = torch.nonzero(mode == op).squeeze(1)
        return beats.shape[0], (beats[:, None] * LANES + lanes).reshape(-1)

    nb, cols = columns(OP_TRIANGLE)
    if nb:
        x = operands[:, cols]
        kf = x[ROW_K:ROW_K + 3]
        k = torch.where(kf == 0.0, 0, torch.where(kf == 1.0, 1, 2)).to(torch.int32)
        t_num, t_denom, hit = raytri_plain(
            x[ROW_ORG:ROW_ORG + 3], x[ROW_SHEAR:ROW_SHEAR + 3], k,
            x[ROW_TRI_A:ROW_TRI_A + 3], x[ROW_TRI_B:ROW_TRI_B + 3],
            x[ROW_TRI_C:ROW_TRI_C + 3])
        out[OUT_TNUM, cols] = t_num
        out[OUT_TDENOM, cols] = t_denom
        out[OUT_THIT, cols] = hit.to(torch.float32)

    nb, cols = columns(OP_QUADBOX)
    if nb:
        x = operands[:, cols]
        tmin, idx, hit = raybox_plain(
            x[ROW_ORG:ROW_ORG + 3], x[ROW_INV:ROW_INV + 3], x[ROW_NEG:ROW_NEG + 3],
            x[ROW_BOX_LO:ROW_BOX_LO + 12], x[ROW_BOX_HI:ROW_BOX_HI + 12])
        out[OUT_TMIN:OUT_TMIN + 4, cols] = tmin
        out[OUT_IDX:OUT_IDX + 4, cols] = idx.to(torch.float32)
        out[OUT_HIT:OUT_HIT + 4, cols] = hit.to(torch.float32)

    for op, width in ((OP_EUCLIDEAN, VECTOR_LANES), (OP_ANGULAR, ANGULAR_LANES)):
        nb, cols = columns(op)
        if not nb:
            continue
        x = operands[:, cols]
        live = x[ROW_MASK][:, None] > torch.arange(width, dtype=torch.float32, device=dev)
        a = x[ROW_VEC_A:ROW_VEC_A + width].T
        b = x[ROW_VEC_B:ROW_VEC_B + width].T
        if op == OP_EUCLIDEAN:
            partials, rows = [euclidean_partial(a, b, live)], [OUT_EUCLID]
        else:
            partials, rows = list(angular_partial(a, b, live)), [OUT_DOT, OUT_NORM]
        reset = (x[ROW_RESET] > 0.5).reshape(nb, LANES)
        accs = _accumulate([p.reshape(nb, LANES) for p in partials], reset)
        for r, acc in zip(rows, accs):
            out[r, cols] = acc.reshape(-1)
        out[OUT_RESET, cols] = x[ROW_RESET]
    return out


def unified(opcodes: torch.Tensor, operands: torch.Tensor) -> torch.Tensor:
    """opcodes: (T,) i32, one per beat; operands: (48, T*128) f32 in the
    union layout.  Returns (16, T*128) f32 in the union output layout."""
    if not operands.is_cuda:
        return unified_plain(opcodes, operands)
    t = _check_shapes(opcodes, operands)
    dev = operands.device
    ptrs = [nvcc.check_cuda("opcodes", opcodes, torch.int32, (t,), dev),
            nvcc.check_cuda("operands", operands, torch.float32,
                            (N_OPERAND_ROWS, t * LANES))]
    out = torch.empty((N_OUTPUT_ROWS, t * LANES), dtype=torch.float32, device=dev)
    # scratch: the first euclidean and angular beat, then each beat's mode
    scratch = torch.full((t + 2,), t, dtype=torch.int32, device=dev)
    nvcc.launch("rayflex_unified", dev, *ptrs, out.data_ptr(), scratch.data_ptr(), t)
    return out
