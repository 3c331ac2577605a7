"""Unified datapath stream: heterogeneous in-order job processing.

The port's counterpart of ``repro/core/stream.py``, the paper's top-level
``UnifiedDatapath`` module: jobs of all four opcodes enter one pipeline in
order; per-mode accumulators persist across (and only across) jobs of
their own mode, so multi-beat Euclidean/angular jobs can be interleaved
with box/triangle work over an indefinite time frame (Table V).

:func:`unified_stream` is the in-order oracle.  Time is the leading axis
of every leaf; any trailing batch axes (lane-streams) are written out, and
the state takes the batch shape, so independent lane-streams run side by
side with no vmap.  The reference's ``lax.scan`` becomes a Python loop
over time.  Every job computes every mode's outputs on the shared units;
the opcode only decides which accumulators move.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .datapath import angular_partial, euclidean_partial, ray_box_test, ray_triangle_test
from .device import resolve_device
from .types import (
    OP_ANGULAR,
    OP_EUCLIDEAN,
    QUAD,
    VECTOR_LANES,
    Box,
    DatapathState,
    Ray,
    Triangle,
    init_datapath_state,
)


class DatapathJob(NamedTuple):
    """Union input bundle (Table V inputs), batched over leading axes."""

    opcode: torch.Tensor  # (N,) i32
    ray: Ray  # fields (N, ...) -- OpTriangle / OpQuadbox
    boxes: Box  # (N, 4, 3) -- OpQuadbox
    triangle: Triangle  # (N, 3) -- OpTriangle
    vec_a: torch.Tensor  # (N, 16) -- OpEuclidean (a) / OpAngular (q, lanes 0..7)
    vec_b: torch.Tensor  # (N, 16) -- OpEuclidean (b) / OpAngular (c, lanes 0..7)
    mask: torch.Tensor  # (N, 16) bool
    reset_accum: torch.Tensor  # (N,) bool


class DatapathOutput(NamedTuple):
    """Union output bundle (Table V outputs).  Fields are valid per opcode."""

    opcode: torch.Tensor  # (N,)
    # OpQuadbox
    tmin: torch.Tensor  # (N, 4) sorted
    box_index: torch.Tensor  # (N, 4)
    is_intersect: torch.Tensor  # (N, 4) bool
    # OpTriangle
    t_num: torch.Tensor  # (N,)
    t_denom: torch.Tensor  # (N,)
    triangle_hit: torch.Tensor  # (N,) bool
    # OpEuclidean
    euclidean_accumulator: torch.Tensor  # (N,)
    # OpAngular
    angular_dot_product: torch.Tensor  # (N,)
    angular_norm: torch.Tensor  # (N,)
    reset_accum: torch.Tensor  # (N,) bool (propagated)


def make_jobs(n, *, device=None) -> DatapathJob:
    """An all-zero job batch of batch shape ``n`` (an int or a tuple) to be
    filled in, as ``repro.core.stream.make_jobs``.

    ``device=None`` puts it on CUDA (raising without a GPU); pass
    ``device="cpu"`` for the plain path.
    """
    device = resolve_device(device)
    shape = (n,) if isinstance(n, int) else tuple(n)
    f32, i32 = torch.float32, torch.int32

    def zeros(*tail, dtype=f32):
        return torch.zeros(shape + tail, dtype=dtype, device=device)

    def ones(*tail):
        return torch.ones(shape + tail, dtype=f32, device=device)

    ray = Ray(origin=zeros(3), direction=ones(3), inv=ones(3),
              extent=torch.full(shape, float("inf"), device=device),
              kx=zeros(dtype=i32), ky=zeros(dtype=i32), kz=zeros(dtype=i32),
              shear=ones(3))
    return DatapathJob(
        opcode=zeros(dtype=i32), ray=ray,
        boxes=Box(zeros(QUAD, 3), zeros(QUAD, 3)),
        triangle=Triangle(zeros(3), zeros(3), zeros(3)),
        vec_a=zeros(VECTOR_LANES), vec_b=zeros(VECTOR_LANES),
        mask=torch.ones(shape + (VECTOR_LANES,), dtype=torch.bool, device=device),
        reset_accum=zeros(dtype=torch.bool))


def _job_compute(state: DatapathState, job: DatapathJob):
    """One pipeline traversal: all four mode datapaths run on the shared
    units; outputs and accumulator updates are selected by opcode (Table V
    validity).  ``job`` leaves carry the state's batch shape."""
    op = job.opcode
    qb = ray_box_test(job.ray, job.boxes)
    tr = ray_triangle_test(job.ray, job.triangle)
    e_partial = euclidean_partial(job.vec_a, job.vec_b, job.mask)
    a_dot, a_nrm = angular_partial(job.vec_a, job.vec_b, job.mask)

    reset = job.reset_accum
    is_e = op == OP_EUCLIDEAN
    is_a = op == OP_ANGULAR
    e_out = e_partial + torch.where(reset, 0.0, state.euclid_accum)
    d_out = a_dot + torch.where(reset, 0.0, state.dot_accum)
    n_out = a_nrm + torch.where(reset, 0.0, state.norm_accum)

    # Per-mode accumulator isolation: a mode's accumulator only moves when
    # a job of that mode passes through.
    new_state = DatapathState(
        euclid_accum=torch.where(is_e, e_out, state.euclid_accum),
        dot_accum=torch.where(is_a, d_out, state.dot_accum),
        norm_accum=torch.where(is_a, n_out, state.norm_accum),
    )
    out = DatapathOutput(
        opcode=op, tmin=qb.tmin, box_index=qb.box_index,
        is_intersect=qb.is_intersect, t_num=tr.t_num, t_denom=tr.t_denom,
        triangle_hit=tr.hit, euclidean_accumulator=e_out,
        angular_dot_product=d_out, angular_norm=n_out, reset_accum=reset)
    return new_state, out


def _at(tree, t: int):
    """Time step ``t`` of every leaf of a (nested) record."""
    if isinstance(tree, torch.Tensor):
        return tree[t]
    return type(tree)(*(_at(x, t) for x in tree))


def unified_stream(jobs: DatapathJob, state: DatapathState | None = None):
    """Process a job stream in order; returns (final_state, outputs).

    jobs: leading axis T = time order (one job per initiation interval),
    then the batch axes of the lane-streams, if any.  ``state=None`` starts
    every accumulator at +0.0, on the jobs' device.
    """
    if state is None:
        state = init_datapath_state(jobs.opcode.shape[1:],
                                    device=jobs.opcode.device)
    if jobs.opcode.shape[0] == 0:  # empty outputs of the right shapes
        empty = init_datapath_state(jobs.opcode.shape, device=jobs.opcode.device)
        return state, _job_compute(empty, jobs)[1]
    outs = []
    for t in range(jobs.opcode.shape[0]):
        state, out = _job_compute(state, _at(jobs, t))
        outs.append(out)
    return state, DatapathOutput(*(torch.stack(f) for f in zip(*outs)))
