"""Distance and norm kernel wrappers (``csrc/distance.cu``) and their plain
versions.

The port's counterpart of ``repro/kernels/distance.py``.  The batched
OpEuclidean / OpAngular form is a GEMM with a distance epilogue, over a
feature axis cut into blocks of :data:`K_BLOCK` (the reference's ``bk``
as ``kernels/ops.py`` calls it):

    euclidean:  D[m, n] = max(sum_b (|q_b|^2 - 2 q_b.c_b) + |c_b|^2, 0)
    angular:    S[m, n] = q_m.c_n            and   N[n] = |c_n|^2

On CUDA tensors :func:`distance_cuda` / :func:`norms_cuda` launch the
hand-written kernels; on CPU tensors they run :func:`distance_plain` /
:func:`norms_plain`, which compute the same blocked form with one
``torch.matmul`` per block (TF32 off).  Unlike ``distance_pallas``, the
wrappers take any M, N and D: the kernels mask the ragged edges.

The distance kernel computes q.c as 3xTF32 on the tensor cores, as the
reference's ``Precision.HIGHEST`` emulates f32 on the MXU: each operand is
split once as ``x = hi + lo`` (:func:`split_tf32`) and q.c is
``hi.hi + (hi.lo + lo.hi)``, with ``lo`` truncated to TF32 by the tensor
cores.  It is held to the plain version within a tolerance, not to its
bits.  :func:`distance_3xtf32` models that arithmetic in plain PyTorch for
the tests; the main path calls neither of the two.
"""
from __future__ import annotations

import torch

from ..core.knn import full_f32_matmul
from . import nvcc

K_BLOCK = 128
MODES = ("euclidean", "angular")


def _check_mode(mode: str) -> None:
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")


def distance_plain(q: torch.Tensor, c: torch.Tensor,
                   mode: str = "euclidean") -> torch.Tensor:
    """The blocked distance form on any device: one matmul per K block."""
    _check_mode(mode)
    m, d = q.shape
    acc = torch.zeros((m, c.shape[0]), dtype=torch.float32, device=q.device)
    for k0 in range(0, d, K_BLOCK):
        qb, cb = q[:, k0:k0 + K_BLOCK], c[:, k0:k0 + K_BLOCK]
        with full_f32_matmul():
            qc = qb @ cb.T
        if mode == "euclidean":
            q2 = (qb * qb).sum(1, keepdim=True)
            c2 = (cb * cb).sum(1)[None, :]
            qc = qc.mul_(-2.0).add_(q2).add_(c2)  # (q2 - 2 qc) + c2
        acc.add_(qc)
    return acc.clamp_min_(0.0) if mode == "euclidean" else acc


#: f32 mantissa bits that TF32 drops
_TF32_DROP = 0x1FFF
#: rows with a value beyond this (or non-finite) are recomputed in plain
#: f32 by the kernel: hi may overflow there, and inf - inf or inf * 0 in
#: the split products give NaN where the plain sum gives +-inf
SPLIT_LIMIT = 2.0 ** 126


def split_tf32(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The distance kernel's operand split (``cvt.rna.tf32.f32``), as plain
    PyTorch: ``hi`` is f32 ``x`` rounded to TF32 (10 mantissa bits) to
    nearest, ties away from zero, and ``lo = x - hi``, exact for finite
    ``x`` below :data:`SPLIT_LIMIT`.  The main path never calls it."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    hi = ((bits + 0x1000) & ~_TF32_DROP).view(torch.float32)
    return hi, x - hi


def _truncate_tf32(x: torch.Tensor) -> torch.Tensor:
    """What the tensor cores read of an f32 operand: its TF32 truncation."""
    return (x.contiguous().view(torch.int32) & ~_TF32_DROP).view(torch.float32)


def split_flags(x: torch.Tensor) -> torch.Tensor:
    """Rows the kernel recomputes in plain f32: any value non-finite or
    beyond :data:`SPLIT_LIMIT` in magnitude."""
    return ~(x.abs() <= SPLIT_LIMIT).all(1)


def _sequential_pairs(q: torch.Tensor, c: torch.Tensor, mode: str) -> torch.Tensor:
    """Scores of row pairs (q[i], c[i]) in the kernel's plain f32 order:
    one fused multiply-add per feature, each 128-wide block closed and
    added to a total.  A product of two f32 values is exact in f64, so
    each step is ``fma`` up to a rare double rounding."""
    total = torch.zeros(q.shape[0], dtype=torch.float32)

    def fma(a, b, acc):
        return (a.double() * b.double() + acc.double()).float()

    for k0 in range(0, q.shape[1], K_BLOCK):
        part = torch.zeros_like(total)
        q2, c2 = torch.zeros_like(total), torch.zeros_like(total)
        for k in range(k0, min(k0 + K_BLOCK, q.shape[1])):
            a, b = q[:, k], c[:, k]
            part = fma(a, b, part)
            if mode == "euclidean":
                q2, c2 = fma(a, a, q2), fma(b, b, c2)
        total = total + ((q2 - 2.0 * part) + c2 if mode == "euclidean" else part)
    if mode == "euclidean":
        total = torch.where(total > 0, total, torch.where(torch.isnan(total), total, 0.0))
    return total


def distance_3xtf32(q: torch.Tensor, c: torch.Tensor,
                    mode: str = "euclidean") -> torch.Tensor:
    """The distance kernel's arithmetic as plain PyTorch, for the tests:
    per K block ``hi.hi + (hi.lo + lo.hi)`` from :func:`split_tf32` with
    ``lo`` truncated to TF32 (three f32 matmuls), the euclidean close of
    :func:`distance_plain`, and the pairs of flagged rows
    (:func:`split_flags`) recomputed in the kernel's plain f32 order."""
    _check_mode(mode)
    m, d = q.shape
    qh, ql = split_tf32(q)
    ch, cl = split_tf32(c)
    ql, cl = _truncate_tf32(ql), _truncate_tf32(cl)
    acc = torch.zeros((m, c.shape[0]), dtype=torch.float32, device=q.device)
    for k0 in range(0, d, K_BLOCK):
        b = slice(k0, k0 + K_BLOCK)
        with full_f32_matmul():
            qc = qh[:, b] @ ch[:, b].T + (qh[:, b] @ cl[:, b].T + ql[:, b] @ ch[:, b].T)
        if mode == "euclidean":
            qb, cb = q[:, b], c[:, b]
            qc = (qb * qb).sum(1, keepdim=True) - 2.0 * qc + (cb * cb).sum(1)[None, :]
        acc.add_(qc)
    if mode == "euclidean":
        acc = acc.clamp_min_(0.0)
    fq, fc = split_flags(q), split_flags(c)
    pairs = fq[:, None] | fc[None, :]
    if bool(pairs.any()):
        i, j = torch.nonzero(pairs, as_tuple=True)
        acc[i, j] = _sequential_pairs(q[i].cpu(), c[j].cpu(), mode).to(acc.device)
    return acc


def norms_plain(c: torch.Tensor) -> torch.Tensor:
    """|c_n|^2 per row, summed block by block: (N, D) -> (1, N)."""
    acc = torch.zeros((1, c.shape[0]), dtype=torch.float32, device=c.device)
    for k0 in range(0, c.shape[1], K_BLOCK):
        cb = c[:, k0:k0 + K_BLOCK]
        acc.add_((cb * cb).sum(1)[None, :])
    return acc


def _operands(q: torch.Tensor, c: torch.Tensor) -> tuple[int, int, int]:
    if q.ndim != 2 or c.ndim != 2 or q.shape[1] != c.shape[1]:
        raise ValueError(f"expected q (M, D) and c (N, D), got "
                         f"{tuple(q.shape)} and {tuple(c.shape)}")
    return q.shape[0], c.shape[0], q.shape[1]


def distance_cuda(q: torch.Tensor, c: torch.Tensor, *,
                  mode: str = "euclidean") -> torch.Tensor:
    """Pairwise scores: q (M, D), c (N, D) f32 -> (M, N) f32, squared
    euclidean distances or dot products."""
    _check_mode(mode)
    m, n, d = _operands(q, c)
    if not q.is_cuda:
        return distance_plain(q, c, mode)
    f32 = torch.float32
    dev = q.device
    ptr_q = nvcc.check_cuda("q", q, f32, (m, d))
    ptr_c = nvcc.check_cuda("c", c, f32, (n, d), dev)
    out = torch.empty((m, n), dtype=f32, device=dev)
    nvcc.launch("rayflex_distance", dev, ptr_q, ptr_c, out.data_ptr(), m, n, d,
                MODES.index(mode))
    return out


#: the norm kernel's variants (``csrc/distance.cu`` ``rayflex_norm``)
NORM_WARP_ROW, NORM_SHORT_WIDE = 0, 1
#: rows below which a warp a row leaves the card short of bytes in flight
NORM_WIDE_ROWS = 2048
#: the short-wide variant keeps a row's block sums in 48 KB of shared memory
NORM_WIDE_MAX_BLOCKS = 48 * 1024 // 4


def norm_variant(n: int, d: int) -> int:
    """The norm kernel variant for an (n, d) table: short-wide below
    :data:`NORM_WIDE_ROWS` rows of two or more 128-feature blocks, else a
    warp a row.

    A warp a row walks its row's blocks one after another, one 512-byte
    block of each row in flight at a time, so fewer than 2048 rows keep
    less than 1 MiB in flight: short of what the 132 SMs need to read at
    the card's rate, its 3.35 TB/s times a round trip (0.31 us: the warp a
    row takes 9.9 us for 16 x 4096, 32 trips), ~1 MB.  There the
    short-wide variant puts a row's blocks on the warps of a block of
    threads, all in flight together.  A row of one block is one trip
    either way, and the block sums of a row wider than
    :data:`NORM_WIDE_MAX_BLOCKS` blocks do not fit shared memory.
    Measured (``chip_smoke.py`` phase 7's sweep, each variant's device
    time; H100 80GB HBM3, 700 W): short-wide 1.9 / 8.9 us against a warp
    a row's 9.9 / 11.8 at 16 x 4096 / 1056 x 4096, a warp a row 14.8 /
    47.1 us against 15.7 / 57.9 at 2112 x 4096 / 8448 x 4096; the two
    cross between 1056 and 4224 rows at every width from 1024 to 8192
    (``PERF.md`` §6, the norm kernel's variants)."""
    if n < 0 or d < 1:
        raise ValueError(f"expected n >= 0 rows of d >= 1 features, got ({n}, {d})")
    blocks = -(-d // K_BLOCK)
    if 2 <= blocks <= NORM_WIDE_MAX_BLOCKS and n < NORM_WIDE_ROWS:
        return NORM_SHORT_WIDE
    return NORM_WARP_ROW


def norms_cuda(c: torch.Tensor) -> torch.Tensor:
    """|c_n|^2 for every row: (N, D) f32 -> (1, N) f32, through the
    variant :func:`norm_variant` picks (both give the same bits)."""
    if c.ndim != 2:
        raise ValueError(f"expected c (N, D), got {tuple(c.shape)}")
    if not c.is_cuda:
        return norms_plain(c)
    n, d = c.shape
    ptr_c = nvcc.check_cuda("c", c, torch.float32, (n, d))
    out = c.new_empty((1, n))
    nvcc.launch("rayflex_norm", c.device, ptr_c, out.data_ptr(), n, d, norm_variant(n, d))
    return out
