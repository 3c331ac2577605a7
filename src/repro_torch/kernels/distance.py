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
wrappers take any M, N and D: the kernels mask the ragged edges.  The
kernel is held to the plain version within a tolerance, not to its bits
(the sums run in another order).
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
    ptr_q = nvcc.check_cuda("q", q, f32, (m, d))
    ptr_c = nvcc.check_cuda("c", c, f32, (n, d))
    out = torch.empty((m, n), dtype=f32, device=q.device)
    nvcc.launch("rayflex_distance", ptr_q, ptr_c, out.data_ptr(), m, n, d,
                MODES.index(mode))
    return out


def norms_cuda(c: torch.Tensor) -> torch.Tensor:
    """|c_n|^2 for every row: (N, D) f32 -> (1, N) f32."""
    if c.ndim != 2:
        raise ValueError(f"expected c (N, D), got {tuple(c.shape)}")
    if not c.is_cuda:
        return norms_plain(c)
    n, d = c.shape
    ptr_c = nvcc.check_cuda("c", c, torch.float32, (n, d))
    out = torch.empty((1, n), dtype=torch.float32, device=c.device)
    nvcc.launch("rayflex_norm", ptr_c, out.data_ptr(), n, d)
    return out
