#!/usr/bin/env python3
"""Time the traversal, neighbour and OpQuadbox kernels of two builds of
the port's kernel library in turns, on the same operands, on one GPU.

    python3 chip_ab.py LIB_A LIB_B [--rounds 10]

``LIB_A`` and ``LIB_B`` are shared libraries that ``repro_torch.kernels.
nvcc.build()`` built from two checkouts (say a parent commit and a
change); their C entry points must take the arguments this checkout's
``nvcc.SIGNATURES`` gives them.  The operands are ``chip_smoke.py``'s
main-path ones, built by this checkout: clustered-1M (LBVH, BVH4 fp32)
and its 1024 x 1024 camera rays (closest; kernel table row 3), the camera
rays against the four box lights (OpQuadbox; row 1), and cloud-1M, every
point a ``nearest`` k=16 query in the Z-order schedule (row 6).  Each
round times both libraries, A first in even rounds and B first in odd
ones: a time is ``REPS[kernel]`` back-to-back launches of the C entry
point between two CUDA events, divided by the count.  Prints, per kernel
and library, the median, min and max ms a launch over the rounds, and in
how many rounds B was faster; fails unless the two libraries' outputs are
bit-equal.  The card's name and power limit are printed first.
"""
from __future__ import annotations

import argparse
import ctypes
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
#: back-to-back launches per timing, by kernel (each window ~30-70 ms)
REPS = {"traverse": 20, "neighbor": 5, "raybox": 500}


def fail(msg: str) -> None:
    print(f"chip_ab: FAIL: {msg}", flush=True)
    sys.exit(1)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("lib_a")
    ap.add_argument("lib_b")
    ap.add_argument("--rounds", type=int, default=10)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this run needs a GPU")
    import chip_smoke as cs
    from repro_torch.api import PointCloudScene, Scene, make_ray
    from repro_torch.core.build.quality import clustered_soup
    from repro_torch.core.bvh import level_offset
    from repro_torch.core.neighbor import PRUNE_SLACK, point_queries
    from repro_torch.kernels import nvcc
    from repro_torch.kernels.common import LANES, ceil_to
    from repro_torch.kernels.ops import ray_box_operands
    from repro_torch.kernels.traverse import (pack_bvh, pack_point_bvh, pack_rays,
                                              query_order)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else "nvidia-smi: none")

    libs = []
    for path in (args.lib_a, args.lib_b):
        lib = ctypes.CDLL(str(Path(path).resolve()))
        for name, argtypes in nvcc.SIGNATURES.items():
            getattr(lib, name).argtypes = argtypes
            getattr(lib, name).restype = ctypes.c_int
        libs.append(lib)

    dev = torch.device("cuda")
    f32, i32 = torch.float32, torch.int32

    # ---- row 3: closest camera rays through clustered-1M ---------------------
    tri = clustered_soup(np.random.default_rng(cs.SEED), cs.N_CLUSTERS, cs.PER_CLUSTER,
                         device="cuda")
    scene = Scene.from_triangles(tri, device="cuda")
    primary = make_ray(*cs.camera_rays(scene), device="cuda")
    n = primary.origin.shape[0]
    n_pad = ceil_to(n, LANES)
    packed = pack_bvh(scene.bvh, scene.config)
    ray_op = pack_rays(primary, n_pad)
    depth = scene.depth

    def traverse_args():
        outs = [torch.empty((n,), dtype=dt, device=dev) for dt in (f32, i32, i32, i32, i32)]
        return outs, (ray_op.data_ptr(), n_pad, n, packed.kids.data_ptr(),
                      packed.slots.data_ptr(), level_offset(depth - 1, 4),
                      level_offset(depth, 4), 0, 0.0, scene.config.stack_size, 4, 0, None,
                      *(o.data_ptr() for o in outs))

    # ---- row 1: the camera rays against the four box lights -----------------
    box_ops = ray_box_operands(primary, cs.emitter_boxes(scene, n))
    n_box = box_ops[0].shape[1]

    def raybox_args():
        outs = [torch.empty((4, n_box), dtype=dt, device=dev) for dt in (f32, i32, i32)]
        return outs, (*(x.data_ptr() for x in box_ops), *(o.data_ptr() for o in outs), n_box)

    # ---- row 6: nearest k=16 of every point of cloud-1M ---------------------
    points = clustered_soup(np.random.default_rng(cs.SEED + 3), cs.TREE_CLUSTERS,
                            cs.TREE_PER_CLUSTER, device="cuda").a
    cloud = PointCloudScene.from_points(points, device="cuda")
    cpack = pack_point_bvh(cloud.bvh)
    queries = point_queries(points, None, device="cuda")
    q_op = pack_rays(queries, ceil_to(points.shape[0], LANES))
    order = query_order(queries.origin, cpack.root[0], cpack.root[1])
    m, k, cdepth = points.shape[0], cs.K_TREE, cloud.depth

    def neighbor_args():
        outs = [torch.empty((k, m), dtype=f32, device=dev),
                torch.empty((k, m), dtype=i32, device=dev),
                *(torch.empty((m,), dtype=i32, device=dev) for _ in range(3))]
        return outs, (q_op.data_ptr(), q_op.shape[1], m, order.data_ptr(),
                      cpack.kids.data_ptr(), cpack.leaf.data_ptr(), cpack.pts.data_ptr(),
                      level_offset(cdepth - 1), level_offset(cdepth), k, 1,
                      float(np.float32(1.0 + PRUNE_SLACK)), float(np.float32(PRUNE_SLACK)),
                      16, *(o.data_ptr() for o in outs), None, None)

    kernels = {"raybox": ("rayflex_raybox", raybox_args),
               "traverse": ("rayflex_traverse", traverse_args),
               "neighbor": ("rayflex_neighbor", neighbor_args)}
    stream = torch.cuda.current_stream().cuda_stream
    times = {(name, side): [] for name in kernels for side in (0, 1)}
    for name, (entry, make) in kernels.items():
        runs = []
        for lib in libs:
            outs, call_args = make()
            fn = getattr(lib, entry)
            err = fn(*call_args, stream)  # warm-up, and the outputs compared below
            if err != 0:
                fail(f"{entry} returned CUDA error {err}")
            runs.append((fn, call_args, outs))
        torch.cuda.synchronize()
        for a, b in zip(runs[0][2], runs[1][2]):
            if not torch.equal(cs.bits(a) if a.dtype == f32 else a,
                               cs.bits(b) if b.dtype == f32 else b):
                fail(f"{name}: the two libraries' outputs differ")
        for r in range(args.rounds):
            for side in ((0, 1) if r % 2 == 0 else (1, 0)):
                fn, call_args, _ = runs[side]
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(REPS[name]):
                    fn(*call_args, stream)
                end.record()
                torch.cuda.synchronize()
                times[(name, side)].append(start.elapsed_time(end) / REPS[name])
    for name in kernels:
        a, b = times[(name, 0)], times[(name, 1)]
        wins = sum(tb < ta for ta, tb in zip(a, b))
        print(f"{name}: A median {statistics.median(a):.4f} ms (min {min(a):.4f}, max "
              f"{max(a):.4f}), B median {statistics.median(b):.4f} ms (min {min(b):.4f}, "
              f"max {max(b):.4f}), B/A {statistics.median(b) / statistics.median(a):.4f}; "
              f"B faster in {wins} of {len(a)} rounds; {REPS[name]} launches a timing; "
              "outputs bit-equal")


if __name__ == "__main__":
    main()
