#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

1. build the CUDA kernels from ``src/repro_torch/csrc`` (nvcc, sm_90a) and
   print the card's name and power limit;
2. OpQuadbox kernel vs its plain version on 1,048,576 jobs (with
   ``dir = +-0.0`` and 0 * inf slabs): every field bit-equal;
3. OpTriangle kernel vs its plain version on 1,048,576 jobs: bit-equal;
4. the golden scenes ``tests/golden/{tetra,sheet,cluster}.npz`` through
   ``Scene.from_triangles(...).engine().trace(...)`` on the cuda backend
   for closest / any / shadow rays: every field exact, ``t`` within
   ``GOLDEN_T_ULPS``;
5. the main path at full size: a 1,048,576-triangle clustered soup built
   by the port's LBVH on the card, 1024 x 1024 pinhole primary rays
   (closest), the primary rays against four box-shaped lights that are
   not in the tree (OpQuadbox), a light-facing test of every hit
   (OpTriangle), and shadow rays from every hit point toward one point
   light; timings and jobs per ray.  The frame's closest and shadow
   traces are held against ``trace_wavefront`` on the card on every ray;
6. each kernel timed at the main path's shapes on the main path's own
   inputs, its output held bit-equal to its plain version's on those
   inputs; one JSON ``kernels`` line (launches on the main path, times,
   errors, bounds), then the ``{"ok": true, "device": ...}`` line.

It imports nothing of JAX and nothing of the JAX package ``repro``.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
GOLDEN = ROOT / "tests" / "golden"

SEED = 20240906
N_JOBS = 1 << 20  # stage-kernel comparison size (phases 2 and 3)
N_CLUSTERS, PER_CLUSTER = 1024, 1024  # 1,048,576 triangles
RES = 1024  # primary rays: RES x RES pinhole camera
TIMED_REPS = 5
#: the goldens were traced by the reference on a CPU, where XLA contracts
#: mul -> add into FMAs inside jitted code; t_num and t_denom each carry
#: that rounding, so the quotient t may sit up to 2 ulps from the port's
#: round-every-op value (measured on the CPU path: 2 ulps on tetra and
#: sheet, 0 on cluster).  Every other field is exact.
GOLDEN_T_ULPS = 2

# H100 SXM peaks (NVIDIA data sheet): HBM bandwidth and f32 (non-tensor) rate
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# bytes each kernel must move per job, and f32 operations per job
RAYBOX_BYTES, RAYBOX_OPS = (9 + 24 + 12) * 4, 4 * (6 + 6 + 6 + 1) + 5
#: OpTriangle reads org, shear, k (i32) and three vertices, 6 rows of 3
#: words, and writes t_num, t_denom and hit
RAYTRI_BYTES, RAYTRI_OPS = (18 + 3) * 4, 9 + 9 + 6 + 6 + 3 + 3 + 4 + 5
#: fused kernel: a ray reads 16 operand floats and writes 5 words; a box
#: job reads 4 child boxes; a triangle job reads a leaf slot and 9 floats
TRAV_RAY_BYTES, TRAV_QB_BYTES, TRAV_TRI_BYTES = 84, 96, 40
#: f32 ops of a triangle job inside traversal: the unit, the divide, and
#: the 4 compares of the commit
TRAV_TRI_OPS = RAYTRI_OPS + 1 + 4


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def say(msg: str) -> None:
    print(msg, flush=True)


def bits(x):
    import torch
    return x.contiguous().view(torch.int32)


def ulp_distance(a, b):
    """|a - b| in units in the last place, for finite f32 tensors."""
    import torch

    def ordered(x):
        i = x.contiguous().view(torch.int32).to(torch.int64)
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)
    return (ordered(a) - ordered(b)).abs()


def bound_ms(n_bytes: float, n_ops: float) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def event_ms(fn, reps: int = TIMED_REPS):
    """Median device time of ``fn`` over ``reps`` runs after one warm-up,
    and the output of the last run."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times), out


def same_bits(label: str, got, ref) -> float:
    """Fail unless every field of ``got`` is bit-equal to ``ref``'s; return
    the largest |got - ref| over the float fields' finite values."""
    import torch
    err = 0.0
    for i, (a, b) in enumerate(zip(got, ref)):
        name = ref._fields[i] if hasattr(ref, "_fields") else str(i)
        if a.dtype == torch.float32:
            fin = torch.isfinite(a) & torch.isfinite(b)
            if fin.any():
                err = max(err, float((a[fin] - b[fin]).abs().max()))
            if not torch.equal(bits(a), bits(b)):
                fail(f"{label}: {name} differs in "
                     f"{int((bits(a) != bits(b)).sum())} values")
        elif not torch.equal(a, b):
            fail(f"{label}: {name} differs in {int((a != b).sum())} values")
    return err


def wall_ms(fn, reps: int = TIMED_REPS) -> float:
    """Median host time of ``fn`` ending in a synchronize, after a warm-up."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def rand_stage_inputs(rng: np.random.Generator, n: int):
    """Rays with +-0.0 direction components, boxes with 0 * inf slabs, and
    triangles around the rays, all f32 numpy."""
    org = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    dirs = rng.normal(size=(n, 3)).astype(np.float32)
    zero = rng.uniform(size=(n, 3))
    dirs[zero < 0.08] = 0.0
    dirs[(zero >= 0.08) & (zero < 0.16)] = -0.0
    lo = rng.uniform(-3, 2, (n, 4, 3)).astype(np.float32)
    hi = (lo + rng.uniform(0, 3, (n, 4, 3))).astype(np.float32)
    # a box plane through the origin on a zero-direction axis: 0 * inf
    slab = (rng.uniform(size=(n, 4, 3)) < 0.25) & (dirs[:, None, :] == 0)
    lo = np.where(slab, org[:, None, :], lo)
    tri = [(org + rng.normal(size=(n, 3)) * 2).astype(np.float32)
           for _ in range(3)]
    return org, dirs, lo, hi, tri


def phase_stage_kernels(torch, rng):
    from repro_torch.core.types import make_ray
    from repro_torch.kernels import raybox as rb, raytri as rt

    org, dirs, lo, hi, tri = rand_stage_inputs(rng, N_JOBS)
    ray = make_ray(org, dirs, device="cuda")
    n = N_JOBS
    # ---- phase 2: OpQuadbox ------------------------------------------------
    ops_org = ray.origin.T.contiguous()
    ops_inv = ray.inv.T.contiguous()
    ops_neg = torch.signbit(ray.direction).to(torch.float32).T.contiguous()
    box_lo = torch.as_tensor(lo.reshape(n, 12).T.copy(), device="cuda")
    box_hi = torch.as_tensor(hi.reshape(n, 12).T.copy(), device="cuda")
    args = (ops_org, ops_inv, ops_neg, box_lo, box_hi)
    k = rb.raybox(*args)
    p = rb.raybox_plain(*args)
    torch.cuda.synchronize()
    lo_t = torch.as_tensor(lo, device="cuda")
    nan_slabs = int(torch.isnan((lo_t - ray.origin[:, None, :])
                                * ray.inv[:, None, :]).sum())
    for name, a, b in zip(("tmin", "idx", "hit"), k, p):
        if not torch.equal(bits(a), bits(b)):
            fail(f"OpQuadbox kernel differs from ray_box_test in {name}: "
                 f"{int((bits(a) != bits(b)).sum())} values")
    say(f"phase 2 OpQuadbox: {n} jobs ({nan_slabs} NaN slabs from 0*inf, "
        f"{int((ray.direction == 0).sum())} zero direction components): "
        f"tmin/idx/hit bit-equal to ray_box_test")

    # ---- phase 3: OpTriangle -----------------------------------------------
    k_rows = torch.stack([ray.kx, ray.ky, ray.kz]).to(torch.int32).contiguous()
    verts = [torch.as_tensor(v.T.copy(), device="cuda") for v in tri]
    args = (ops_org, ray.shear.T.contiguous(), k_rows, *verts)
    k = rt.raytri(*args)
    p = rt.raytri_plain(*args)
    torch.cuda.synchronize()
    for name, a, b in zip(("t_num", "t_denom", "hit"), k, p):
        if not torch.equal(bits(a), bits(b)):
            diff = bits(a) != bits(b)
            msg = f"{int(diff.sum())} values differ"
            if a.dtype == torch.float32:
                fin = torch.isfinite(a) & torch.isfinite(b)
                msg += f", max {int(ulp_distance(a[fin], b[fin]).max())} ulps"
            fail(f"OpTriangle kernel differs from ray_triangle_test in "
                 f"{name}: {msg}")
    say(f"phase 3 OpTriangle: {n} jobs, {int(k[2].sum())} hits: "
        f"t_num/t_denom/hit bit-equal to ray_triangle_test")


def phase_goldens(torch):
    from repro_torch.api import Scene, make_ray

    fields = ("tri_index", "hit", "quadbox_jobs", "triangle_jobs",
              "stack_overflow")
    worst = 0
    for name in ("tetra", "sheet", "cluster"):
        data = np.load(GOLDEN / f"{name}.npz")
        scene = Scene.from_triangles(data["tris"], device="cuda")
        engine = scene.engine()
        rays = make_ray(data["ray_org"], data["ray_dir"], data["ray_extent"],
                        device="cuda")
        for ray_type in ("closest", "any", "shadow"):
            stem = f"bvh4_s64_fp32_fp32__lbvh__{ray_type}"
            got = engine.trace(rays, ray_type, backend="cuda")
            for f in fields:
                exp = data[f"{stem}__{f}"]
                if not np.array_equal(getattr(got, f).cpu().numpy(), exp):
                    fail(f"golden {name}/{stem}: {f} differs")
            if int(got.rounds) != int(data[f"{stem}__rounds"]):
                fail(f"golden {name}/{stem}: rounds {int(got.rounds)} != "
                     f"{int(data[stem + '__rounds'])}")
            exp_t = torch.as_tensor(data[f"{stem}__t"], device="cuda")
            fin = torch.isfinite(exp_t)
            if not torch.equal(fin, torch.isfinite(got.t)):
                fail(f"golden {name}/{stem}: t finiteness differs")
            d = int(ulp_distance(got.t[fin], exp_t[fin]).max()) if fin.any() else 0
            if d > GOLDEN_T_ULPS:
                fail(f"golden {name}/{stem}: t is {d} ulps from the golden "
                     f"(allowed {GOLDEN_T_ULPS})")
            worst = max(worst, d)
    say(f"phase 4 goldens: tetra/sheet/cluster x closest/any/shadow on the "
        f"cuda backend: tri_index/hit/jobs/overflow/rounds exact, t within "
        f"{worst} ulp(s) of the goldens (allowed {GOLDEN_T_ULPS}: reference "
        f"FMA contraction)")


def camera_rays(scene):
    """RES x RES pinhole rays from in front of the scene box, looking +z."""
    lo = scene.bvh.node_lo[0].cpu().numpy()
    hi = scene.bvh.node_hi[0].cpu().numpy()
    center = 0.5 * (lo + hi)
    eye = np.asarray([center[0], center[1], lo[2] - 2.0 * (hi[2] - lo[2])],
                     np.float32)
    half = 0.5 * float(max(hi[0] - lo[0], hi[1] - lo[1]))
    dist = float(center[2] - eye[2])
    s = np.linspace(-1.0, 1.0, RES, dtype=np.float32) * half / dist
    ys, xs = np.meshgrid(s[::-1], s, indexing="ij")
    dirs = np.stack([xs.ravel(), ys.ravel(), np.ones(RES * RES, np.float32)],
                    axis=1).astype(np.float32)
    org = np.broadcast_to(eye, dirs.shape).astype(np.float32)
    return org, dirs


def emitter_boxes(scene, n: int):
    """Four box-shaped lights (not in the tree) between the camera and the
    scene, in a 2 x 2 grid inside the frame; as a :class:`Box` of (n, 4, 3)
    that gives every ray the same four boxes."""
    import torch
    from repro_torch.core.types import Box
    lo, hi = scene.bvh.node_lo[0], scene.bvh.node_hi[0]
    span = hi - lo
    grid = torch.tensor([[-1.0, -1.0], [1.0, -1.0], [-1.0, 1.0], [1.0, 1.0]],
                        device=lo.device)
    c = (0.5 * (lo + hi)).expand(4, 3).clone()
    c[:, :2] += 0.25 * grid * span[:2]
    c[:, 2] = lo[2] - 0.25 * span[2]
    half = span * torch.tensor([0.04, 0.04, 0.02], device=lo.device)
    return Box((c - half).expand(n, 4, 3), (c + half).expand(n, 4, 3))


def phase_main_path(torch):
    from repro_torch.api import Scene, make_ray
    from repro_torch.core.build.quality import clustered_soup
    from repro_torch.core.bvh import num_nodes
    from repro_torch.core.types import Triangle
    from repro_torch.core.wavefront import trace_wavefront
    from repro_torch.kernels import nvcc, raybox as rb, raytri as rt
    from repro_torch.kernels.ops import (ray_box_kernel, ray_box_operands,
                                         ray_triangle_kernel,
                                         ray_triangle_operands)
    from repro_torch.kernels.traverse import pack_bvh, traverse_packed

    rng = np.random.default_rng(SEED)
    tri = clustered_soup(rng, N_CLUSTERS, PER_CLUSTER, device="cuda")
    light = torch.tensor([9.0, 11.0, -13.0], device="cuda")

    def frame(stages: dict | None = None) -> dict:
        """The main path a user runs for one frame.  With ``stages``, each
        stage ends in a synchronize and its host time (ms) is recorded."""
        clock = [time.perf_counter()]

        def mark(name):
            if stages is not None:
                torch.cuda.synchronize()
                now = time.perf_counter()
                stages[name] = (now - clock[0]) * 1e3
                clock[0] = now

        scene = Scene.from_triangles(tri, device="cuda")
        engine = scene.engine()
        mark("build")
        org, dirs = camera_rays(scene)
        primary = make_ray(org, dirs, device="cuda")
        mark("camera rays")
        hits = engine.trace(primary)  # closest
        mark("primary trace")
        # box-shaped lights outside the tree: OpQuadbox of every camera ray
        # against the four; the nearest one hit in front of the surface
        # shows on the pixel
        emitters = emitter_boxes(scene, primary.origin.shape[0])
        seen = ray_box_kernel(primary, emitters)
        t_seen = torch.where(seen.is_intersect, seen.tmin, float("inf"))
        near, slot = t_seen.min(dim=1)
        emitter = torch.where(near < hits.t,
                              seen.box_index.gather(1, slot[:, None])[:, 0], -1)
        mark("emitters")
        idx = torch.nonzero(hits.hit).squeeze(1)
        p = primary.origin[idx] + hits.t[idx, None] * primary.direction[idx]
        hit_tri = hits.tri_index[idx].long()
        corners = Triangle(*[v[hit_tri] for v in scene.bvh.triangles])
        centroid = (corners.a + corners.b + corners.c) / 3.0
        # light-facing test: OpTriangle from the light toward the hit
        # triangle's centroid hits its front face iff the light sees it
        to_tri = make_ray(light.expand_as(centroid), centroid - light,
                          device="cuda")
        facing = ray_triangle_kernel(to_tri, corners).hit
        mark("light-facing test")
        to_light = light - p
        dist = torch.linalg.vector_norm(to_light, dim=1)
        shadow = make_ray(p, to_light / dist[:, None], dist, device="cuda")
        mark("shadow rays")
        occluded = engine.trace(shadow, "shadow")
        mark("shadow trace")
        image = torch.zeros(hits.hit.shape, device="cuda")
        image[idx] = (facing & ~occluded.hit).float()
        image = torch.where(emitter >= 0, 2.0, image)
        mark("shade")
        return dict(scene=scene, engine=engine, primary=primary, hits=hits,
                    emitters=emitters, emitter=emitter, to_tri=to_tri,
                    corners=corners, shadow=shadow, occluded=occluded,
                    image=image)

    # ---- one counted drive of the main path --------------------------------
    torch.cuda.synchronize()
    nvcc.reset_launches()
    fr = frame()
    torch.cuda.synchronize()
    launches = nvcc.launch_counts()
    for name in ("raybox", "raytri", "traverse"):
        if launches.get(name, 0) < 1:
            fail(f"the main path launched no {name} kernel ({launches})")

    scene, engine, primary, hits = fr["scene"], fr["engine"], fr["primary"], fr["hits"]
    shadow, occluded = fr["shadow"], fr["occluded"]
    n_tri = scene.num_triangles
    if n_tri != N_CLUSTERS * PER_CLUSTER or scene.depth != 10 or \
            scene.bvh.node_lo.shape[0] != num_nodes(10):
        fail(f"unexpected tree: {n_tri} triangles, depth {scene.depth}, "
             f"{scene.bvh.node_lo.shape[0]} nodes")
    bvh = scene.bvh
    tree_bytes = sum(x.numel() * x.element_size() for x in
                     (bvh.node_lo, bvh.node_hi, bvh.leaf_tri, *bvh.triangles))
    for name, rec in (("primary", hits), ("shadow", occluded)):
        if rec.t.shape != (rec.hit.shape[0],) or bool(torch.isnan(rec.t).any()):
            fail(f"{name} trace: malformed t")
        if not bool(((rec.t > 0) | ~rec.hit).all()):
            fail(f"{name} trace: a hit with t <= 0")
        if bool(rec.stack_overflow.any()):
            fail(f"{name} trace: stack overflow at depth {scene.depth}")
    n_hit, n_shadow = int(hits.hit.sum()), shadow.origin.shape[0]
    n_emit = int((fr["emitter"] >= 0).sum())
    if n_hit == 0 or n_hit == RES * RES or n_emit == 0:
        fail(f"degenerate frame: {n_hit} primary hits, {n_emit} emitter pixels")
    if fr["image"].shape != (RES * RES,) or not bool(torch.isfinite(fr["image"]).all()):
        fail("malformed image")
    say(f"phase 5 main path: {n_tri} triangles, LBVH depth {scene.depth}, "
        f"{bvh.node_lo.shape[0]} nodes, {tree_bytes / 1e6:.1f} MB of nodes + "
        f"leaf table + triangles on the card")
    say(f"phase 5 frame: {RES * RES} primary rays, {n_hit} hits, {n_emit} "
        f"pixels show a box light, {int(occluded.hit.sum())} of {n_shadow} "
        f"shadow rays occluded, {int((fr['image'] == 1).sum())} hits lit")

    # ---- the frame's traces held against trace_wavefront on every ray ------
    packed = pack_bvh(bvh)
    trav_ms, rec_k = event_ms(lambda: traverse_packed(packed, primary, scene.depth))
    trav_plain_ms, rec_p = event_ms(
        lambda: trace_wavefront(bvh, primary, scene.depth), reps=3)
    trav_err = same_bits(f"fused kernel vs trace_wavefront on all {RES * RES} "
                         f"primary rays", rec_k, rec_p)
    same_bits("the frame's closest trace vs trace_wavefront", hits, rec_p)
    sh_ref = trace_wavefront(bvh, shadow, scene.depth, ray_type="shadow")
    same_bits(f"the frame's shadow trace vs trace_wavefront on all {n_shadow} "
              f"shadow rays", occluded, sh_ref)
    say(f"phase 5 check: the frame's closest trace ({RES * RES} rays, rounds "
        f"{int(rec_p.rounds)}) and shadow trace ({n_shadow} rays, rounds "
        f"{int(sh_ref.rounds)}) bit-equal to trace_wavefront on every field")

    # ---- timings at the main-path shapes -----------------------------------
    build_ms = wall_ms(lambda: Scene.from_triangles(tri, device="cuda"))
    trace_ms = {
        "closest": wall_ms(lambda: engine.trace(primary)),
        "shadow": wall_ms(lambda: engine.trace(shadow, "shadow")),
    }
    for rtype, rec, rays in (("closest", hits, primary), ("shadow", occluded, shadow)):
        n = rays.origin.shape[0]
        say(f"phase 5 {rtype}: {n} rays, trace {trace_ms[rtype]:.3f} ms (median "
            f"of {TIMED_REPS}), {n / trace_ms[rtype] * 1e3:.4g} rays/s, "
            f"quadbox_jobs/ray {rec.quadbox_jobs.double().mean().item():.3f}, "
            f"triangle_jobs/ray {rec.triangle_jobs.double().mean().item():.3f}, "
            f"rounds {int(rec.rounds)}")
    say(f"phase 5 build: {build_ms:.3f} ms for {n_tri} triangles (LBVH on the "
        f"card, median of {TIMED_REPS})")
    frame_ms = wall_ms(frame, reps=3)
    say(f"phase 5 frame: {frame_ms:.3f} ms end to end (build, camera rays, "
        f"primary trace, box lights, light-facing test, shadow trace, shade; "
        f"median of 3)")
    stages: dict = {}
    frame(stages)
    say("phase 5 frame stages (ms, each ending in a synchronize): "
        + ", ".join(f"{k} {v:.3f}" for k, v in stages.items()))

    # ---- phase 6: each kernel on the main path's own inputs ----------------
    n_rays = RES * RES
    sum_qb = float(rec_k.quadbox_jobs.double().sum())
    sum_tri = float(rec_k.triangle_jobs.double().sum())
    trav_bound = bound_ms(n_rays * TRAV_RAY_BYTES + sum_qb * TRAV_QB_BYTES
                          + sum_tri * TRAV_TRI_BYTES,
                          sum_qb * RAYBOX_OPS + sum_tri * TRAV_TRI_OPS)
    say(f"phase 6 traverse: {n_rays} primary rays; kernel {trav_ms:.3f} ms, "
        f"bound {trav_bound[0]:.3f} ms ({trav_bound[1]}; an upper estimate "
        f"of traffic: every job's bytes from HBM, which L2 can cut)")

    rb_args = ray_box_operands(primary, fr["emitters"])
    rb_ms, rb_k = event_ms(lambda: rb.raybox(*rb_args))
    rb_plain_ms, rb_p = event_ms(lambda: rb.raybox_plain(*rb_args))
    rb_err = same_bits("OpQuadbox kernel vs ray_box_test on the frame's "
                       "box-light jobs", rb_k, rb_p)
    rt_args = ray_triangle_operands(fr["to_tri"], fr["corners"])
    rt_ms, rt_k = event_ms(lambda: rt.raytri(*rt_args))
    rt_plain_ms, rt_p = event_ms(lambda: rt.raytri_plain(*rt_args))
    rt_err = same_bits("OpTriangle kernel vs ray_triangle_test on the frame's "
                       "light-facing jobs", rt_k, rt_p)
    n_rb, n_rt = rb_args[0].shape[1], rt_args[0].shape[1]
    say(f"phase 6 stage kernels on the frame's inputs: OpQuadbox {n_rb} jobs, "
        f"OpTriangle {n_rt} jobs, each bit-equal to its plain version")

    def row(name, source, replaces, ms, plain_ms, err, bound):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches[name],
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound[0], "bound_by": bound[1], "library_ms": None}

    return [
        row("raybox", "src/repro_torch/csrc/raybox.cu",
            "src/repro/kernels/raybox.py:22", rb_ms, rb_plain_ms, rb_err,
            bound_ms(n_rb * RAYBOX_BYTES, n_rb * RAYBOX_OPS)),
        row("raytri", "src/repro_torch/csrc/raytri.cu",
            "src/repro/kernels/raytri.py:19", rt_ms, rt_plain_ms, rt_err,
            bound_ms(n_rt * RAYTRI_BYTES, n_rt * RAYTRI_OPS)),
        row("traverse", "src/repro_torch/csrc/traverse.cu",
            "src/repro/kernels/traverse.py:95", trav_ms, trav_plain_ms,
            trav_err, trav_bound),
    ]


def main() -> None:
    if not (SRC / "repro_torch").is_dir() or not GOLDEN.is_dir():
        fail(f"{SRC / 'repro_torch'} or {GOLDEN} missing: run from a "
             "checkout of the repository")
    sys.path.insert(0, str(SRC))
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.kernels import nvcc

    # ---- phase 1: build -------------------------------------------------------
    t0 = time.perf_counter()
    lib_path = nvcc.build()
    nvcc.library()
    say(f"phase 1 build: {lib_path.name} in {time.perf_counter() - t0:.1f} s "
        f"(nvcc {' '.join(nvcc.ARCH_FLAGS + nvcc.NVCC_FLAGS)})")
    for src, log in sorted(nvcc.build_log.items()):
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                say(f"  ptxas {src}: {line.strip()}")
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as exc:
        fail(f"nvidia-smi: {exc}")
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi exited {smi.returncode}: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    say(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")

    rng = np.random.default_rng(SEED)
    phase_stage_kernels(torch, rng)
    phase_goldens(torch)
    kernels = phase_main_path(torch)

    say(card)
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
