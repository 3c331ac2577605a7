#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

1. build the CUDA kernels from ``src/repro_torch/csrc`` (nvcc, sm_90a),
   print ptxas's registers, spills and stack frame (for each neighbour
   kernel variant and each traversal kernel variant) and the card's name
   and power limit;
2. OpQuadbox kernel vs its plain version on 1,048,576 jobs (with
   ``dir = +-0.0`` and 0 * inf slabs): every field bit-equal;
3. OpTriangle kernel vs its plain version on 1,048,576 jobs: bit-equal;
4. the golden scenes ``tests/golden/{tetra,sheet,cluster}.npz`` through
   ``Scene.from_triangles(..., builder, config).engine().trace(...)`` on
   the cuda backend, all 18 entries of each (BVH4 fp32, BVH8 fp32, BVH4
   bf16-compressed x LBVH, SAH x closest / any / shadow): every field
   exact, ``t`` within ``GOLDEN_T_ULPS``;
5. the main path at full size: a 1,048,576-triangle clustered soup built
   by the port's LBVH on the card, 1024 x 1024 pinhole primary rays
   (closest), the primary rays against four box-shaped lights that are
   not in the tree (OpQuadbox), a light-facing test of every hit
   (OpTriangle), and shadow rays from every hit point toward one point
   light; timings and jobs per ray.  The frame's closest and shadow
   traces are held against ``trace_wavefront`` on the card on every ray;
6. each kernel timed at the main path's shapes on the main path's own
   inputs, its output held bit-equal to its plain version's on those
   inputs.  The traversal kernel's bound (distinct bytes against
   job-counted operations, box tests at inner pops only) with its share at
   the unfused f32 rate and the 32 B sectors its jobs gather;
7. brute-force vector search at the shapes of two public ann-benchmarks
   sets, synthesised from a seed as clustered Gaussians:
   ``sift-128-euclidean`` (1,000,000 x 128, 10,000 queries; ``nearest``
   k=10, ``within`` and ``count_within`` at a radius fixed from the data)
   and ``glove-100-angular`` (1,183,514 x 100, 10,000 queries; cosine
   ``nearest`` k=10), through ``VectorIndex.from_database(...).engine(
   chunk_size=1024)``.  The distance kernel (3xTF32 on the tensor cores;
   one ``kernels`` row per mode, its bound set by the TF32 rate or the
   bytes, the old f32 bound beside it) and the norm kernel are held to
   their plain versions on the path's own full-size inputs within
   ``1e-5 (|q|^2 + |c|^2)`` (distances), ``1e-5 |q| |c|`` (dots) and
   ``1e-5 |c|^2`` (norms); ``nearest`` equals the ``mxu`` backend's
   indices on every query whose top-11 scores are further apart than that.
   At both tables the norm kernel's two variants (warp a row, short-wide)
   are held bit-equal to each other and within ``1e-5 |c|^2`` of
   ``norms_plain``, and ``norms_cuda``'s device time a call (the
   profiler's kernel events, which must name ``norm_variant``'s kernel),
   event window and host time a call are printed beside
   ``torch.linalg.vector_norm``'s and ``(c * c).sum(1)``'s; then both
   variants' device times over a sweep of rows and widths (``NORM_SWEEP_*``);
8. tree search over a 2^20-point cloud (``clustered_soup``'s centres),
   every point also a query: ``nearest`` k=16, ``within`` and
   ``count_within`` through ``PointCloudScene.from_points(...).engine()``
   on ``backend="auto"``, which must resolve to ``tree_cuda``.  The
   neighbour kernel is held bit-equal to ``neighbor_wavefront``, every
   field, on all 2^20 queries (nearest k=16 and within), on the 2^20
   queries in a seeded random order (nearest k=16) and on the first
   65,536 at k=65 (the general list); the tree is held against exact
   brute force (float64, direct form) on the first 65,536 queries outside
   a band of the tree's own f32 rounding, ``16 u (|q|^2 + (|q| + rho)^2)``,
   which must stay below r^2 on every checked query; ``nearest``
   rank-equivalent.  Timed: the kernel alone (min / median / max of 5),
   the kernel in the caller's order, its Z-order prologue,
   ``neighbor_packed`` (pack, order and launch: the span earlier versions
   timed), ``nearest`` in caller and in random order, and a
   SIMT-efficiency proxy per order;
9. the unified mixed-opcode stream (Table V) through
   ``kernels.ops.unified_datapath``: 128 lane-streams, ~105k beats merged
   in a seeded random order from four sources that each keep their own
   order: 2^20 OpEuclidean pairs of phase 7's sift-shape vectors (8 beats
   each), 2^18 OpAngular pairs of its glove-shape vectors (13 beats), the
   OpQuadbox jobs of phase 5's box lights and its OpTriangle light-facing
   jobs.  The kernel's output is held bit-equal to ``unified_plain`` on
   every row; each pair's final accumulators bit-equal to the port's
   multi-beat forms and within a bound of a float64 witness; the box and
   triangle beats bit-equal to the standalone stage kernels.  A stream of
   the same length with no reset (the kernel's worst case) is timed too;

10. dynamic scenes at full size: clustered-1M's soup built, refit with its
    own triangles (bit-equal to the build on every ``BVH4`` array), then
    animated for 4 frames of rigid per-cluster motion, each frame
    ``Scene.refit``, a closest ``engine.trace`` on ``backend="auto"``
    (``cuda``) and ``engine.occluded`` of its shadow rays; on the last frame
    the trace is bit-equal to ``trace_wavefront`` on all 2^20 rays, and
    ``hit`` / ``t`` bit-equal to a rebuild's (``tri_index`` equal but where
    both triangles give the ray the same ``t``); the ``per_ray`` oracle
    equals the ``cuda`` backend on the frame's first 256 hit rays; one cache
    miss per trace key and one re-pack per version.  Cloud-1M jittered and
    ``PointCloudScene.refit``: ``tree_cuda`` bit-equal to ``tree_wavefront``,
    ``dist_sq`` bit-equal to a rebuild's.  Timed: refit against rebuild,
    the first trace after a refit against a steady one, the cloud refit
    against ``from_points``;
11. the datapath twins on clustered-1M: ``Scene.from_triangles(..., builder,
    config)`` for LBVH and SAH at BVH4 fp32, BVH8 fp32 and BVH4
    bf16-compressed, and LBVH at BVH4 stack 16 bf16 (a stack that
    overflows) and BVH4 stack 100 (a stack past the kernel's local array);
    each traces the 2^20 camera rays closest and any and their shadow
    rays through ``backend="cuda"``.  Gates: every trace bit-equal to
    ``trace_wavefront`` on every ray and field; closest ``hit`` / ``t``
    bit-equal to the same builder's BVH4 fp32 twin where neither
    overflowed (a differing ``tri_index`` only where both triangles give
    the same ``t``); the codec twins' job counters at least those of the
    exact twin of the same builder, arity and stack, traced under that
    twin's own config, on every ray that hits nothing and overflows in
    neither (a hit ray may visit fewer nodes: the widened boxes reorder its
    children, so it prunes in another order; those rays are counted and
    printed); ``Scene.refit`` with the
    build's triangles bit-equal to the build under BVH8 and
    bf16-compressed; a soup with +-0.0 vertices built by both builders
    under every golden config on the card bit-equal to its build on the
    CPU, and its refit to its build (the signed-zero order of the box
    reductions).  Printed per config: build, trace, kernel and plain ms,
    jobs per ray, rounds, overflowed rays, the packed child records' and
    leaf slots' bytes, the kernel's bound (distinct bytes against
    job-counted operations; also with the codec's analytic box bytes), its
    share at the unfused f32 rate and the sectors its jobs gather;
12. the query server (``repro_torch.serving.QueryServer``) over one engine
    holding clustered-1M, the sift-shape index and cloud-1M: a trace of
    ``SERVE_REQUESTS`` requests drawn with ``SEED`` (half closest traces
    and a fifth shadow traces of 256-4096 of phase 5's camera rays and
    their shadow rays, a fifth ``nearest`` k=10 of 1-64 sift-shape queries
    on the ``cuda`` backend, a tenth ``nearest`` k=16 of 64-1024 of the
    cloud's points on ``tree_cuda``), served closed loop (every request
    at once), then open loop with Poisson arrivals at 50% and 90% of the
    closed loop's rate, then closed loop with telemetry on.  Printed per
    run: requests/s, latency p50 / p99 (overall and per kind), requests a
    batch, mean fill, flush reasons.  Gates: every response of every run
    bit-equal to a direct engine call on its own rows (a trace's
    ``rounds`` its own ``max(quadbox_jobs)``); the closed-loop run
    launches the traversal, distance and neighbour kernels; a
    ``CompileTracker`` reads 0 over each warm open-loop run; the
    telemetry-on run's Chrome trace is written to ``build/`` and its
    event count printed;
13. the LM serving path: ``init_params`` of Phi-3.5-MoE
    (``phi3.5-moe-42b-a6.6b``) at its published widths, cut to 8 of its
    32 layers (42.7 GB of float32 weights), on the card from a seeded
    generator, then ``Engine(max_len=192).generate`` greedy over 8 prompts
    of 128 tokens drawn with ``SEED``, 32 new tokens.  Printed: parameters
    and their GB, peak memory, prefill ms, decode ms a step and tokens/s
    (medians), a ``torch.profiler`` breakdown of a prefill and a decode
    step (device busy share, largest kernels), the norm kernel's launches
    and its time at the router table's shape, and phase 7's norm numbers
    and variant gates at the router tables of Phi-3.5-MoE (its own),
    Jamba-1.5-Large and DeepSeek-V3 (seeded).  Gates: the norm kernel
    launched exactly (MoE layers x forward calls) times and nothing else;
    every layer's router norms within ``1e-5 |c|^2`` of ``norms_plain``;
    layer 0's cosine router on real activations within ``1e-5`` of the
    CPU path, its top-2 routing equal but at near-ties, its dispatch table
    and drops equal on the card and the CPU; decode through the cache
    against one prefill of the whole sequence (capacity raised so that no
    token drops, routing forced to the decode path's) within
    ``LM_DECODE_TOL`` on every row, in float32 (which must also route
    every row alike by itself) and in bf16; ``batch_chunk=4`` over 6 prompts, each chunk bit-equal
    to its rows alone; two sampled runs of one seed bit-equal and in the
    vocabulary; the smoke configs of Phi-3.5-MoE, SmolLM-360M,
    DeepSeek-V3 and Jamba-1.5-Large (attention at layer 4 among Mamba
    layers: KV and conv / SSM caches side by side) in float32 with greedy
    tokens equal to the CPU path's and logits within ``LM_SMOKE_TOL``;
14. DeepSeek-V3 serving: phase 13's weights released (the memory still
    allocated printed), then ``init_params`` of ``deepseek-v3-671b`` at its
    published widths (MLA with q_lora 1536 / kv_lora 512, 128 heads; 256
    routed experts of width 2048 and one shared, sigmoid top-8 routing
    scaled by 2.5; vocab 129280), cut to 4 of its 61 layers (3 dense, the
    first MoE layer) with the MTP head's parameters, 63.19 GB of float32
    weights, and phase 13's load through ``Engine.generate`` under both MLA
    decode paths (``absorb`` off and on).  Printed: prefill ms, decode ms a
    step, tokens/s, peak memory (gate 80 GB), the profiler breakdown of each
    path.  Gates: the norm kernel launched exactly (1 MoE layer x 33
    forwards) times a generate and nothing else, short-wide at the model's
    256 x 7168 router table, within ``1e-5 |c|^2`` of ``norms_plain``; the
    MoE layer's ``moe_local`` at a prefill's inputs bit-equal across two runs
    and its combine bit-equal to a per-token loop in (expert, slot) order;
    the absorbed path against the naive one, teacher-forced with routing
    forced alike, within ``DS_ABSORB_TOL`` in float32 and bf16; decode
    against one prefill (no-drop capacity, routing forced to the decode
    path's, batch ``DS_GATE_BATCH``, peak under 75 GB) within
    ``DS_DECODE_TOL`` under both paths in float32 and bf16 (float32 must
    also route every row alike by itself);
15. Jamba-1.5-Large serving: phase 14's weights released (the memory still
    allocated printed), then ``init_params`` of ``jamba-1.5-large-398b`` at
    its published widths (d_model 8192; 64 heads, 8 KV heads of 128; Mamba
    d_state 16, d_conv 4, expand 2, dt_rank 512, scan chunks of 128; 16
    experts of width 24576, top-2; vocab 65536), cut to 3 of its 72 layers
    (Mamba + dense MLP, Mamba + MoE, Mamba + dense MLP; 13,206,562,400
    parameters, 52.83 GB of float32 weights; 4 layers would be 93.16 GB
    and 5, the first to reach the attention layer, 96.18 GB), and phase
    13's load through ``Engine.generate``.  Printed: parameters and GB,
    prefill ms, decode ms a step, tokens/s, the profiler breakdown of a
    prefill and a decode step and the selective scan's share of each one's
    device time (the scan's calls caught and profiled again alone), peak
    memory.  Gates: the norm kernel launched exactly (1 MoE layer x 33
    forwards) times a generate and nothing else, short-wide at 16 x 8192,
    within ``1e-5 |c|^2`` of ``norms_plain``; layer 0's Mamba mixer at real
    activations on the card within ``JB_MIXER_TOL`` of the CPU path in
    float32 (exact products), output and both states; decode through the
    conv / SSM caches against one prefill of 160 positions (two scan
    chunks, the second padded; no-drop capacity, routing forced to the
    decode path's) within ``LM_DECODE_TOL`` in float32 (every row routed
    alike by itself) and bf16; peak memory over the phase under
    ``JB_PEAK_GB``;

then one JSON ``kernels`` line (launches on each kernel's path, times,
errors, bounds, library times) and the ``{"ok": true, "device": ...}``
line.

It imports nothing of JAX and nothing of the JAX package ``repro``.
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
import json
import math
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
#: back-to-back launches per device-alone timing of a small kernel
DEVICE_REPS = 100
#: the device-alone timings rotate over copies of a kernel's operands and
#: outputs that together hold at least this many times the card's L2, so
#: no launch finds its inputs left in L2 by the one before
L2_SPAN = 4
#: the goldens were traced by the reference on a CPU, where XLA contracts
#: mul -> add into FMAs inside jitted code; t_num and t_denom each carry
#: that rounding, so the quotient t may sit up to 2 ulps from the port's
#: round-every-op value (measured on the CPU path: 2 ulps on tetra and
#: sheet, 0 on cluster).  Every other field is exact.
GOLDEN_T_ULPS = 2
#: the datapath twins the goldens pin (``DatapathConfig.tag``)
GOLDEN_CONFIGS = ("bvh4_s64_fp32_fp32", "bvh8_s64_fp32_fp32", "bvh4_s64_bf16_compressed")

# H100 SXM peaks (NVIDIA data sheet): HBM bandwidth, f32 (non-tensor) rate
# and the dense TF32 tensor-core rate (the distance kernel's 3xTF32)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
TF32_OPS_PER_S = 495e12
# bytes each kernel must move per job, and f32 operations per job
RAYBOX_BYTES, RAYBOX_OPS = (9 + 24 + 12) * 4, 4 * (6 + 6 + 6 + 1) + 5
#: OpTriangle reads org, shear, k (i32) and three vertices, 6 rows of 3
#: words, and writes t_num, t_denom and hit
RAYTRI_BYTES, RAYTRI_OPS = (18 + 3) * 4, 9 + 9 + 6 + 6 + 3 + 3 + 4 + 5
#: fused kernel: a ray reads 16 operand floats and writes 5 words; its
#: jobs gather 32 B sectors of the packed tree (the gathered-sector
#: metric, not the bound)
TRAV_RAY_BYTES, SECTOR_BYTES = 84, 32
#: f32 operations a second without FMA: the kernels build with
#: -fmad=false, and the 67 TFLOP/s peak counts an FMA as two
F32_UNFUSED_OPS_PER_S = F32_OPS_PER_S / 2
#: f32 ops of a triangle job inside traversal: the unit, the divide, and
#: the 4 compares of the commit
TRAV_TRI_OPS = RAYTRI_OPS + 1 + 4

# phase 7: ann-benchmarks shapes (sift-128-euclidean, glove-100-angular)
SIFT_N, SIFT_D = 1_000_000, 128
GLOVE_N, GLOVE_D = 1_183_514, 100
N_QUERIES, N_CLUSTERS_ANN, CHUNK, K_ANN = 10_000, 1000, 1024, 10
#: in-radius count the sift radius is fixed for (median over a sample)
TARGET_IN_RADIUS = 30
SCORE_RTOL = 1e-5
#: the norm kernel's tables: the router tables (experts x d_model) of the
#: MoE configs in ``repro_torch/configs`` -- Phi-3.5-MoE (phase 13's model),
#: Jamba-1.5-Large and DeepSeek-V3 (tables alone) -- beside phase 7's
#: brute-force tables
NORM_ROUTER_TABLES = (("phi3.5-moe", 16, 4096), ("jamba-1.5-large", 16, 8192),
                      ("deepseek-v3", 256, 7168))
#: event windows (median of) and host-time loops (calls a loop) of the
#: norm comparisons
NORM_REPS, HOST_CALLS = 51, 100
#: calls a profiled window of the norm comparisons takes at most, the
#: oldest copies first (the first evicted from L2)
NORM_PROFILED_CALLS = 400
#: phase 7's sweep of the two norm variants' device times
NORM_SWEEP_ROWS = (16, 132, 528, 1056, 2112, 4224, 8448, 16896)
NORM_SWEEP_DIMS = (256, 1024, 4096, 8192)
#: the kernel of each norm variant, as the profiler names it
NORM_KERNELS = {0: "norm_kernel", 1: "norm_wide_kernel"}
# phase 8: 2^20 points, every point a query
TREE_CLUSTERS, TREE_PER_CLUSTER, K_TREE, TREE_RADIUS = 1024, 1024, 16, 0.02
BRUTE_CHECK_QUERIES, BRUTE_CHUNK = 65_536, 512
#: the random order of phase 8's second gate, and its k beyond the
#: kernel's register lists (on the first queries)
TREE_PERM_SEED, K_WIDE, K_WIDE_QUERIES = SEED + 5, 65, 65_536
U_F32 = 2.0 ** -24  # unit roundoff of f32
#: neighbour kernel: a query reads its 4 operand floats and writes k
#: (distance, index) pairs and 3 counters; for the per-job traffic
#: estimate (not the bound), a pop of an inner node reads 4 child boxes
#: and a point job reads a leaf slot and a 4-float packed point
NEIGH_QUERY_BYTES, NEIGH_BOX_BYTES, NEIGH_POINT_BYTES = 16 + 12, 96, 20
#: f32 ops of one point-box job (4 boxes x (6 subtracts, 6 compares, 3
#: multiplies, 2 adds), the 5-comparator sort, the pruning bound and 4
#: push compares) and of one point job (6 products and sums, the
#: expanded form, the clamp, the radius and insertion compares)
NEIGH_BOX_OPS, NEIGH_POINT_OPS = 4 * 17 + 5 + 4 + 4, 12
# phase 9: the unified stream
STREAM_SEED = 20240910
E_PAIRS, A_PAIRS = 1 << 20, 1 << 18  # euclidean (sift-shape), angular (glove-shape)
#: operand rows a job of each opcode reads (triangle, quadbox, euclidean,
#: angular; of the 48) and output rows every job writes
STREAM_ROWS_IN, STREAM_ROWS_OUT = (18, 33, 34, 18), 16
#: f32 operations of a job of each opcode (euclidean: 16 subtracts, 16
#: squares, 15 tree adds, the accumulator add; angular: 16 products, 14
#: tree adds, 2 accumulator adds)
STREAM_OPS = (RAYTRI_OPS, RAYBOX_OPS, 48, 32)
# phase 10: dynamic scenes.  Cluster c moves by f * v_c at frame f, v_c ~
# N(0, 0.1^2) per axis; the cloud's points jitter by N(0, 0.005^2)
FRAMES, ANIM_SEED, ANIM_SIGMA = 4, 20240912, 0.1
CLOUD_JITTER_SEED, CLOUD_JITTER = 20240913, 0.005
ORACLE_RAYS = 256
# phase 11: the datapath twins on clustered-1M, (builder, DatapathConfig.tag)
TWIN_CONFIGS = tuple((b, t) for b in ("lbvh", "sah") for t in GOLDEN_CONFIGS) + (
    ("lbvh", "bvh4_s16_bf16_fp32"),  # a stack that overflows
    ("lbvh", "bvh4_s100_fp32_fp32"))  # a stack deeper than the local array
#: f32 ops of one box-test job at arity A: A boxes x 19, the sort's comparators
SORT_COMPARATORS = {4: 5, 8: 19}
#: a soup whose vertex coordinates are +-0.0 at random (30%), the rest N(0, 1)
SIGNED_ZERO_SEED, SIGNED_ZERO_TRIS, SIGNED_ZERO_SHARE = SEED + 7, 4096, 0.3
# phase 12: the query server over one engine, a mixed trace of requests
# drawn with SEED: (kind, share, rows low, rows high) per request kind
SERVE_REQUESTS = 2000
SERVE_MIX = (("closest", 0.5, 256, 4096), ("shadow", 0.2, 256, 4096),
             ("brute nearest", 0.2, 1, 64), ("tree nearest", 0.1, 64, 1024))
#: each kind's call, the same on the server and the engine: (method, args,
#: keyword args) after the payload
SERVE_CALLS = {"closest": ("trace", (), {}), "shadow": ("trace", ("shadow",), {}),
               "brute nearest": ("nearest", (10,), {"backend": "cuda"}),
               "tree nearest": ("nearest", (16,), {"backend": "tree_cuda"})}
SERVE_MAX_BATCH_ROWS, SERVE_MAX_WAIT = 4096, 2e-3
#: open-loop offered rates, as shares of the closed loop's sustained rate
SERVE_OPEN_SHARES = (0.5, 0.9)
# phase 13: the LM serving path.  Phi-3.5-MoE at its published widths, cut
# to 8 of its 32 layers: a layer holds 1,300,316,160 parameters (5.20 GB of
# float32 master weights), so 8 layers and the embeddings are 42.7 GB of the
# card's 80 and 32 would be 168 GB
LM_ARCH, LM_LAYERS = "phi3.5-moe-42b-a6.6b", 8
LM_BATCH, LM_PROMPT, LM_NEW, LM_MAX_LEN = 8, 128, 32, 192
LM_CHUNK, LM_CHUNK_ROWS, LM_TEMPERATURE = 4, 6, 0.8
#: capacity_factor at which no expert can drop a token (capacity >= tokens
#: needs cf >= E / top_k = 8), for the decode-against-prefill gate
LM_NODROP_CF = 8.0
#: decode through the cache against one prefill over the whole sequence,
#: last step's logits of all rows, the prefill's routing forced to the
#: decode path's.  float32: the two paths differ in summation order only
#: (CPU, 4 layers at width 1024: 2.7e-6 at logits of 3.5; the card, 8
#: layers at full width: 6.3e-6 at logits up to 4.1), so 1e-3 holds with
#: room and bf16 compute (errors of 1e-2 and more) fails it.  bf16, on the
#: card (H100 80GB HBM3) at full width: up to 0.031 on rows that routed
#: alike by themselves, 0.312 on a row routed differently (the control);
#: 0.1 is near the geometric mean of the two, 6 bf16 steps at logits in [2, 4)
LM_DECODE_TOL = {"float32": 1e-3, "bfloat16": 0.1}
#: smoke configs run on the card and on the CPU in float32 (TF32 off): the
#: port's own CPU tests' tolerance against the reference
LM_SMOKE_ARCHS, LM_SMOKE_TOL = (("phi3.5-moe-42b-a6.6b", "smollm-360m", "deepseek-v3-671b",
                                 "jamba-1.5-large-398b"), 1e-4)
# phase 14: DeepSeek-V3 at its published widths, cut to 4 of its 61 layers
# (the 3 dense ones and the first MoE layer) with the MTP head: 15,797,366,784
# parameters, 63.19 GB of float32 master weights (count_params; 5 layers
# would be 109.2 GB).  The largest transient beside them is one expert
# tensor cast to bf16, 256 x 7168 x 2048 x 2 B = 7.5 GB.  Same load as
# phase 13, under both MLA decode paths
DS_ARCH, DS_LAYERS, DS_PARAMS = "deepseek-v3-671b", 4, 15_797_366_784
#: decode against one prefill at no-drop capacity (cf = E / top_k = 32):
#: the prefill's expert block is (256, tokens, 7168), 1.17 GB a row of 160
#: tokens in float32, so 2 rows keep the peak under 75 GB (73.80 measured)
DS_GATE_BATCH, DS_NODROP_CF = 2, 32.0
#: as LM_DECODE_TOL, routing forced to the decode path's.  float32: summation
#: order only (1.3e-5 / 1.4e-5 naive / absorbed at logits up to 3.9, the
#: card, H100 80GB HBM3); bf16 on the card at full width: 0.045-0.055 on
#: forced rows, 0.531 on a row routed differently (the control), so 0.1,
#: 1.8x the worst forced reading and 5x under the control, holds
DS_DECODE_TOL = {"float32": 1e-3, "bfloat16": 0.1}
#: the absorbed decode path against the naive one, teacher-forced on the
#: naive path's greedy tokens at batch 8, routing forced to the naive
#: path's.  float32: the latent query and output in place of expanded keys
#: and values, another summation order (9.9e-6 at logits up to 5.0, the
#: card); bf16 rounds at other places (q_lat, o_lat against k, v): 0.057
#: on the card with every row routed alike by force, while by itself the
#: absorbed path routes all 8 rows differently somewhere; 0.1 as above
DS_ABSORB_TOL = {"float32": 1e-3, "bfloat16": 0.1}
# phase 15: Jamba-1.5-Large at its published widths, cut to 3 of its 72
# layers (Mamba + dense MLP, Mamba + MoE, Mamba + dense MLP): 13,206,562,400
# parameters, 52.83 GB of float32 master weights (count_params).  4 layers
# would be 93.16 GB, and 5, the first depth to reach the attention layer at
# position 4, 96.18 GB: neither fits the card's 80 GB.  The largest
# transients beside the weights: one expert tensor cast to bf16, 16 x 8192 x
# 24576 x 2 B = 6.44 GB, and a prefill's scan, a few (8, 128, 16384, 16)
# float32 tensors of 1.07 GB.  Phase 13's load; decode against one prefill
# at phase 13's no-drop capacity (cf = E / top_k = 8 here too)
JB_ARCH, JB_LAYERS, JB_PARAMS = "jamba-1.5-large-398b", 3, 13_206_562_400
#: layer 0's Mamba mixer on the card against the CPU path, at the real
#: activations of the first rows of the prompts, float32 with exact products:
#: |card - CPU| <= tol (1 + |CPU|), the CPU tests' F32_RTOL / F32_ATOL
JB_MIXER_ROWS, JB_MIXER_TOL = 2, 2e-5
#: peak device memory over the whole phase
JB_PEAK_GB = 78


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


def traverse_ops(sum_qb: float, sum_tri: float, arity: int) -> float:
    """The traversal's job-counted f32 operations: the box test and its sort
    at inner pops only (no record depends on a leaf parent's box test, and
    the kernel runs none), and every triangle job."""
    inner_pops = sum_qb - sum_tri / arity
    return inner_pops * (arity * 19 + SORT_COMPARATORS[arity]) + sum_tri * TRAV_TRI_OPS


def traverse_bound(packed, n_rays: int, sum_qb: float, sum_tri: float, arity: int,
                   node_bytes: float | None = None) -> tuple[float, str]:
    """The fused kernel's bound: its distinct bytes (each ray's operands
    read and record written once, the packed tree -- child records and leaf
    slots -- read once) against :func:`traverse_ops`.  ``node_bytes``
    stands in for the child records' bytes (a codec's analytic size)."""
    kids = packed.kids.numel() * packed.kids.element_size()
    slots = packed.slots.numel() * packed.slots.element_size()
    n_bytes = n_rays * TRAV_RAY_BYTES + (kids if node_bytes is None else node_bytes) + slots
    return bound_ms(n_bytes, traverse_ops(sum_qb, sum_tri, arity))


def sector_span(ptr: int, stride: int, count: int) -> float:
    """Mean 32 B sectors a record of ``stride`` bytes touches, over records
    0 .. count - 1 of an array at address ``ptr``."""
    start = ptr % SECTOR_BYTES + stride * np.arange(count, dtype=np.int64)
    last = start + stride - 1
    return float((last // SECTOR_BYTES - start // SECTOR_BYTES + 1).mean())


def traverse_gathered(packed, n_rays: int, sum_qb: float, sum_tri: float,
                      arity: int) -> tuple[float, float, float]:
    """32 B sectors an inner pop's box job gathers (its child record; a
    leaf parent's box job gathers none), sectors a triangle job gathers (a
    leaf parent's slots, over its ``arity`` jobs), and the bytes of every
    job's sectors plus the rays' own: traffic before L1 / L2 serve any of
    it, printed beside the bound and never as it."""
    kids, slots = packed.kids, packed.slots
    rec = kids.shape[1] * kids.element_size()
    box = sector_span(kids.data_ptr(), rec, kids.shape[0]) if kids.shape[0] else 0.0
    group = arity * slots.shape[1] * slots.element_size()
    tri = sector_span(slots.data_ptr(), group, slots.shape[0] // arity) / arity
    n_bytes = n_rays * TRAV_RAY_BYTES + SECTOR_BYTES * (
        (sum_qb - sum_tri / arity) * box + sum_tri * tri)
    return box, tri, n_bytes


def traverse_metrics(packed, n_rays: int, sum_qb: float, sum_tri: float, arity: int,
                     kern_ms: float) -> str:
    """The kernel's bound, its share at the unfused f32 rate and its
    gathered sectors, as one line's tail."""
    bound = traverse_bound(packed, n_rays, sum_qb, sum_tri, arity)
    ops = traverse_ops(sum_qb, sum_tri, arity)
    unfused_ms = ops / F32_UNFUSED_OPS_PER_S * 1e3
    box, tri, gathered = traverse_gathered(packed, n_rays, sum_qb, sum_tri, arity)
    return (f"bound {bound[0]:.4f} ms ({bound[1]}; distinct bytes against "
            f"{ops:.4g} job-counted operations, box tests at inner pops only): "
            f"{bound[0] / kern_ms:.1%} of its speed; {unfused_ms:.4f} ms at "
            f"{F32_UNFUSED_OPS_PER_S:.3g} unfused f32 operations/s: "
            f"{unfused_ms / kern_ms:.1%}; gathered sectors {box:.3f} an inner "
            f"pop's box job, 0 a leaf parent's, {tri:.3f} a triangle job: "
            f"{gathered / 1e9:.3f} GB, {gathered / HBM_BYTES_PER_S * 1e3:.3f} ms at "
            f"the HBM rate (traffic before L1 / L2, not the bound)")


def distance_bounds(m: int, n: int, d: int, euclidean: bool):
    """The distance kernel's bound, and the old f32 bound beside it.  The
    kernel's f32-accurate product is 3xTF32, three TF32 products a term on
    the tensor cores (2 M N D operations each), plus the euclidean close
    (3 M N f32 operations); the bytes are q, c read once and the M N
    scores written once.  The old bound counts the product at the f32
    rate."""
    n_bytes = 4.0 * (m * d + n * d + m * n)
    close = 3.0 * m * n if euclidean else 0.0
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = (3 * 2.0 * m * n * d / TF32_OPS_PER_S + close / F32_OPS_PER_S) * 1e3
    new = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
    return new, bound_ms(n_bytes, 2.0 * m * n * d + close)


def hgmma_counts(lib_path) -> dict | None:
    """TF32 wgmma instructions (SASS ``HGMMA.*.TF32``) in each distance
    kernel of the built library, or None where the toolkit has no
    cuobjdump."""
    from repro_torch.kernels import nvcc
    tool = Path(nvcc.find_nvcc()).parent / "cuobjdump"
    if not tool.exists():
        return None
    proc = subprocess.run([str(tool), "--dump-sass", str(lib_path)],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        fail(f"cuobjdump --dump-sass exited {proc.returncode}: {proc.stderr.strip()}")
    counts, fn = {}, None
    for line in proc.stdout.splitlines():
        if "Function :" in line:
            name = line.split("Function :", 1)[1].strip()
            fn = None
            if "distance_kernel" in name:
                fn = "euclidean" if "distance_kernelILb1E" in name else "angular"
                counts[fn] = 0
        elif fn and "HGMMA" in line and "TF32" in line:
            counts[fn] += 1
    return counts


def neighbor_ptxas(log: str) -> list[tuple[str, str, str]]:
    """ptxas's stack frame / spill line and register line for each variant
    of the neighbour kernel, labelled by its list capacity."""
    import re
    out, label, stack = [], None, ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '\S*neighbor_kernelILi(\d+)E", line)
        if m:
            cap = m.group(1)
            label = f"[{'general list' if cap == '0' else 'KCAP=' + cap}]"
        elif label and "stack frame" in line:
            stack = line.strip()
        elif label and "Used" in line and "registers" in line:
            out.append((label, stack, line.split(":", 1)[1].strip()))
            label = None
    if not out:
        fail("ptxas printed no neighbour kernel variant")
    return out


def traverse_ptxas(log: str) -> list[tuple[str, str]]:
    """ptxas's register / spill lines for each instantiation of the
    traversal kernel, labelled by arity, node-box type and stack home;
    fails unless all 8 variants are there, each with its registers."""
    import re
    out, label, with_regs = [], None, set()
    for line in log.splitlines():
        m = re.search(r"traverse_kernelILi(\d)E(f|13__nv_bfloat16)Lb(\d)E", line)
        if m and "Compiling entry function" in line:
            box = "f32" if m.group(2) == "f" else "bf16"
            stack = "local stack" if m.group(3) == "1" else "scratch stack"
            label = f"[bvh{m.group(1)} {box} rows, {stack}]"
        elif label and ("registers" in line or "spill" in line):
            out.append((label, line.strip()))
            if "registers" in line:
                with_regs.add(label)
    want = {f"[bvh{a} {b} rows, {s}]" for a in (4, 8) for b in ("f32", "bf16")
            for s in ("local stack", "scratch stack")}
    if with_regs != want:
        fail(f"ptxas reported registers for {sorted(with_regs)}, not the traversal "
             f"kernel's 8 variants; missing {sorted(want - with_regs)}")
    return out


def event_times(fn, reps: int = TIMED_REPS):
    """Device times of ``fn`` over ``reps`` runs after one warm-up, and the
    output of the last run."""
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
    return times, out


def event_ms(fn, reps: int = TIMED_REPS):
    """Median device time of ``fn`` over ``reps`` runs after one warm-up,
    and the output of the last run."""
    times, out = event_times(fn, reps)
    return statistics.median(times), out


def l2_copies(nbytes: int) -> int:
    """How many copies of a ``nbytes`` working set hold :data:`L2_SPAN`
    times the card's L2."""
    import torch
    l2 = torch.cuda.get_device_properties(0).L2_cache_size
    return max(1, -(-L2_SPAN * l2 // nbytes))


def device_ms(entry: str, arg_sets, reps: int = DEVICE_REPS) -> float:
    """The kernel alone on the device: ``reps`` back-to-back calls of C
    entry point ``entry``, rotating over ``arg_sets`` (argument tuples of
    operands and outputs prepared once), between one pair of CUDA events,
    divided by ``reps`` (after one warm-up call on each set); no launch is
    counted.  The stage kernels are idempotent.  This is the kernel's time
    only where it outlasts a ctypes call (4-9 us on the H100 machine's
    host): a kernel of a few microseconds leaves the
    queue empty and this times the host, so :func:`norm_numbers` takes the
    norm kernel's device time from the profiler."""
    import torch
    from repro_torch.kernels import nvcc
    fn = getattr(nvcc.library(), entry)
    stream = torch.cuda.current_stream().cuda_stream

    def call(args):
        err = fn(*args, stream)
        if err != 0:
            fail(f"{entry} returned CUDA error {err}")

    for args in arg_sets:
        call(args)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(reps):
        call(arg_sets[i % len(arg_sets)])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


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
    from repro_torch.convert import config_from_tag

    fields = ("tri_index", "hit", "quadbox_jobs", "triangle_jobs",
              "stack_overflow")
    worst, n_entries = 0, 0
    for name in ("tetra", "sheet", "cluster"):
        data = np.load(GOLDEN / f"{name}.npz")
        rays = make_ray(data["ray_org"], data["ray_dir"], data["ray_extent"],
                        device="cuda")
        for tag in GOLDEN_CONFIGS:
            for builder in ("lbvh", "sah"):
                scene = Scene.from_triangles(data["tris"], builder=builder,
                                             config=config_from_tag(tag), device="cuda")
                engine = scene.engine()
                for ray_type in ("closest", "any", "shadow"):
                    stem = f"{tag}__{builder}__{ray_type}"
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
                    n_entries += 1
    say(f"phase 4 goldens: {n_entries} entries (tetra/sheet/cluster x "
        f"{'/'.join(GOLDEN_CONFIGS)} x lbvh/sah x closest/any/shadow), each scene "
        f"built by the port on the card and traced on the cuda backend: "
        f"tri_index/hit/jobs/overflow/rounds exact, t within {worst} ulp(s) of the "
        f"goldens (allowed {GOLDEN_T_ULPS}: reference FMA contraction)")


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
    trav_bound = traverse_bound(packed, n_rays, sum_qb, sum_tri, 4)
    gathered = traverse_gathered(packed, n_rays, sum_qb, sum_tri, 4)[2]
    say(f"phase 6 traverse: {n_rays} primary rays; kernel {trav_ms:.3f} ms; "
        + traverse_metrics(packed, n_rays, sum_qb, sum_tri, 4, trav_ms))

    f32, i32 = torch.float32, torch.int32
    rb_args = ray_box_operands(primary, fr["emitters"])
    rb_wrap_ms, rb_k = event_ms(lambda: rb.raybox(*rb_args))
    rb_plain_ms, rb_p = event_ms(lambda: rb.raybox_plain(*rb_args))
    rb_err = same_bits("OpQuadbox kernel vs ray_box_test on the frame's "
                       "box-light jobs", rb_k, rb_p)
    rb_ms, rb_same, rb_d = stage_device_ms(torch, "rayflex_raybox", rb_args, (4,),
                                           (f32, i32, i32))
    for outs in rb_d:
        same_bits("OpQuadbox kernel, timed alone, vs ray_box_test", outs, rb_p)
    rt_args = ray_triangle_operands(fr["to_tri"], fr["corners"])
    rt_wrap_ms, rt_k = event_ms(lambda: rt.raytri(*rt_args))
    rt_plain_ms, rt_p = event_ms(lambda: rt.raytri_plain(*rt_args))
    rt_err = same_bits("OpTriangle kernel vs ray_triangle_test on the frame's "
                       "light-facing jobs", rt_k, rt_p)
    rt_ms, rt_same, rt_d = stage_device_ms(torch, "rayflex_raytri", rt_args, (),
                                           (f32, f32, i32))
    for outs in rt_d:
        same_bits("OpTriangle kernel, timed alone, vs ray_triangle_test", outs, rt_p)
    n_rb, n_rt = rb_args[0].shape[1], rt_args[0].shape[1]
    rb_bound = bound_ms(n_rb * RAYBOX_BYTES, n_rb * RAYBOX_OPS)
    rt_bound = bound_ms(n_rt * RAYTRI_BYTES, n_rt * RAYTRI_OPS)
    say(f"phase 6 stage kernels on the frame's inputs: OpQuadbox {n_rb} jobs, "
        f"OpTriangle {n_rt} jobs, each bit-equal to its plain version")
    for name, dev, same, n_sets, wrap, bound in (
            ("OpQuadbox", rb_ms, rb_same, len(rb_d), rb_wrap_ms, rb_bound),
            ("OpTriangle", rt_ms, rt_same, len(rt_d), rt_wrap_ms, rt_bound)):
        say(f"phase 6 {name} kernel alone: {dev:.4f} ms a launch ({DEVICE_REPS} "
            f"back-to-back launches of the C entry point between two events, over "
            f"{n_sets} copies of its operands and outputs holding >= {L2_SPAN}x L2; "
            f"{same:.4f} ms on one set, which L2 may serve in part); the wrapper's "
            f"event window {wrap:.4f} ms (median of {TIMED_REPS}); bound "
            f"{bound[0]:.4f} ms ({bound[1]}): {bound[0] / dev:.1%} of the bound's "
            f"speed alone, {bound[0] / wrap:.1%} through the wrapper")

    rows = [
        kernel_row("raybox", "raybox.cu", "src/repro/kernels/raybox.py:22",
                   launches, rb_ms, rb_plain_ms, rb_err, rb_bound, wrapper_ms=rb_wrap_ms),
        kernel_row("raytri", "raytri.cu", "src/repro/kernels/raytri.py:19",
                   launches, rt_ms, rt_plain_ms, rt_err, rt_bound, wrapper_ms=rt_wrap_ms),
        kernel_row("traverse", "traverse.cu", "src/repro/kernels/traverse.py:95",
                   launches, trav_ms, trav_plain_ms, trav_err, trav_bound),
    ]
    rows[-1]["gathered_ms"] = gathered / HBM_BYTES_PER_S * 1e3
    stage_jobs = {k: fr[k] for k in ("primary", "emitters", "to_tri", "corners")}
    return rows, stage_jobs


def kernel_row(name, source, replaces, launches, ms, plain_ms, err, bound,
               library_ms=None, wrapper_ms=None):
    """One entry of the ``kernels`` line.  ``wrapper_ms``, where given, is
    the wrapper's event window beside ``ms``, the kernel alone."""
    row = {"name": name, "route": "cuda",
           "source": f"src/repro_torch/csrc/{source}", "replaces": replaces,
           "launches": launches[name], "max_abs_err": err, "ms": ms,
           "plain_ms": plain_ms, "bound_ms": bound[0], "bound_by": bound[1],
           "library_ms": library_ms}
    if wrapper_ms is not None:
        row["wrapper_ms"] = wrapper_ms
    return row


def stage_device_ms(torch, entry, operands, rows, dtypes):
    """:func:`device_ms` of a kernel whose operands are (rows, n) columns,
    into outputs of shape ``rows + (n,)`` allocated here, over
    :func:`l2_copies` copies of the operands and outputs; and, beside it,
    the time on one set.  Returns both times and every copy's outputs."""
    n = operands[0].shape[-1]
    nbytes = sum(x.numel() * x.element_size() for x in operands) + n * sum(
        math.prod(rows) * torch.empty((), dtype=dt).element_size() for dt in dtypes)
    sets, outs = [], []
    for i in range(l2_copies(nbytes)):
        ins = operands if i == 0 else tuple(x.clone() for x in operands)
        out = tuple(torch.empty(rows + (n,), dtype=dt, device="cuda") for dt in dtypes)
        sets.append((*(x.data_ptr() for x in ins), *(o.data_ptr() for o in out), n))
        outs.append((ins, out))
    ms = device_ms(entry, sets)
    same_ms = device_ms(entry, sets[:1])
    return ms, same_ms, [out for _, out in outs]


# ---------------------------------------------------------------------------
# the norm kernel's numbers at one table (phases 7 and 13, chip_norm_ab.py)
# ---------------------------------------------------------------------------


def norm_args(c, out, variant: int) -> tuple:
    """``rayflex_norm``'s arguments but the stream; a checkout whose entry
    point has no variant (one kernel, a warp a row) gets none."""
    from repro_torch.kernels import nvcc
    args = (c.data_ptr(), out.data_ptr(), *c.shape)
    return args + (variant,) if len(nvcc.SIGNATURES["rayflex_norm"]) == 6 else args


def host_loop_us(fn, calls: int = HOST_CALLS) -> float:
    """Host time of one call of ``fn``: the wall clock of ``calls`` calls
    issued back to back with no synchronize inside the loop (one before
    it, one after the clock stops; the launch queue holds them all), over
    the count."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


def host_us(fn, loops: int = 11) -> float:
    """The median of ``loops`` :func:`host_loop_us` after a warm-up call."""
    fn()
    return statistics.median(host_loop_us(fn) for _ in range(loops))


def window_ms(fn) -> float:
    """One event window around ``fn`` (the queue empty before it)."""
    import torch
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def profiled_us(calls) -> tuple[float | None, list[str]]:
    """Device time a call from ``torch.profiler``'s CUDA events: the
    kernels' durations summed over the zero-argument ``calls``, over their
    count, and the kernels' names; None where the profiler saw no device
    time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    calls[-1]()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for call in calls:
            call()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    total = sum(e.self_device_time_total for e in events)
    return (total / len(calls) if total else None), sorted(e.key for e in events)


def cold_copies(c) -> list:
    """``c`` and clones of it, together at least :data:`L2_SPAN` x L2."""
    n, d = c.shape
    return [c] + [c.clone() for _ in range(l2_copies(4 * (n * d + n)) - 1)]


def norm_numbers(torch, c) -> dict:
    """The norm wrapper ``norms_cuda`` at table ``c`` beside
    ``torch.linalg.vector_norm`` and ``(c * c).sum(1)``: each one's device
    time a call (:func:`profiled_us` over :func:`cold_copies` of ``c``, at
    least 20 calls and at most ``NORM_PROFILED_CALLS``, so its reads come
    from HBM), event window (median of
    ``NORM_REPS`` on ``c`` itself, warm) and host time a call
    (:func:`host_us`); windows and host loops of the three taken in turns,
    so that drift of the host's speed hits them alike.  The wrapper's
    kernel names too."""
    from repro_torch.kernels.distance import norms_cuda
    fns = {"norms_cuda": norms_cuda,
           "vector_norm": lambda x: torch.linalg.vector_norm(x, dim=1),
           "sumsq": lambda x: (x * x).sum(1)}
    copies = cold_copies(c)
    out = {"shape": list(c.shape)}
    for label, fn in fns.items():
        calls = [lambda x=copies[i % len(copies)]: fn(x) for i in range(
            min(max(len(copies), 20), NORM_PROFILED_CALLS))]
        dev_us, names = profiled_us(calls)
        out[label] = {"device_us": dev_us}
        if label == "norms_cuda":
            out[label]["kernels"] = names
        fn(c)
    del copies
    windows = {label: [] for label in fns}
    hosts = {label: [] for label in fns}
    for _ in range(NORM_REPS):
        for label, fn in fns.items():
            windows[label].append(window_ms(lambda: fn(c)))
    for _ in range(11):
        for label, fn in fns.items():
            hosts[label].append(host_loop_us(lambda: fn(c)))
    for label in fns:
        out[label]["window_ms"] = statistics.median(windows[label])
        out[label]["host_us"] = statistics.median(hosts[label])
    return out


def norm_line(label: str, r: dict) -> str:
    """One printed line of :func:`norm_numbers`' result."""
    def part(k):
        v = r[k]
        dev = "not measured" if v["device_us"] is None else f"{v['device_us']:.3f} us"
        return (f"device {dev}, window {v['window_ms']:.4f} ms, host "
                f"{v['host_us']:.2f} us")
    n, d = r["shape"]
    return (f"{label} {n} x {d}: norms_cuda {part('norms_cuda')} "
            f"{r['norms_cuda']['kernels']}; torch.linalg.vector_norm "
            f"{part('vector_norm')}; (c * c).sum(1) {part('sumsq')}")


def norm_variants_gate(torch, c) -> tuple[float, float]:
    """Both norm variants through the C entry point on table ``c`` (not
    counted): bit-equal to each other, each within ``1e-5 |c|^2`` of
    ``norms_plain``.  Returns the largest |err| and its share of |c|^2."""
    from repro_torch.kernels import nvcc
    from repro_torch.kernels.distance import norms_plain
    fn = nvcc.library().rayflex_norm
    stream = torch.cuda.current_stream().cuda_stream
    outs = []
    for variant in NORM_KERNELS:
        out = torch.empty((1, c.shape[0]), dtype=torch.float32, device="cuda")
        err = fn(*norm_args(c, out, variant), stream)
        if err != 0:
            fail(f"rayflex_norm variant {variant} returned CUDA error {err}")
        outs.append(out)
    torch.cuda.synchronize()
    if not torch.equal(bits(outs[0]), bits(outs[1])):
        fail(f"norm variants differ at {tuple(c.shape)} in "
             f"{int((bits(outs[0]) != bits(outs[1])).sum())} rows")
    ref = norms_plain(c)
    err = max(score_error(o, ref, ref) for o in outs)
    return err, max(scaled_error(o, ref, ref) for o in outs)


def norm_checked(torch, label: str, c) -> dict:
    """:func:`norm_variants_gate` and :func:`norm_numbers` at table ``c``,
    printed; fails unless the wrapper launched ``norm_variant``'s kernel."""
    from repro_torch.kernels.distance import norm_variant
    err, rel = norm_variants_gate(torch, c)
    r = norm_numbers(torch, c)
    want = NORM_KERNELS[norm_variant(*c.shape)]
    names = r["norms_cuda"]["kernels"]
    if r["norms_cuda"]["device_us"] is not None and not (len(names) == 1 and want in names[0]):
        fail(f"norms_cuda at {tuple(c.shape)} launched {names}, not {want}")
    say(f"{norm_line(label, r)}; variants bit-equal, within {rel:.3g} |c|^2 of "
        f"norms_plain (max |err| {err:.3g}; gate {SCORE_RTOL:g})")
    r["max_abs_err"] = err
    return r


def norm_sweep(torch) -> None:
    """Both norm variants through the C entry point at ``NORM_SWEEP_ROWS``
    x ``NORM_SWEEP_DIMS``: each one's device time a launch
    (:func:`profiled_us` over :func:`cold_copies`), the outputs held
    bit-equal; where a warp a row stops losing, printed beside
    ``norm_variant``'s pick."""
    from repro_torch.kernels import nvcc
    from repro_torch.kernels.distance import norm_variant
    fn = nvcc.library().rayflex_norm
    stream = torch.cuda.current_stream().cuda_stream
    gen = torch.Generator(device="cuda").manual_seed(SEED + 24)
    for d in NORM_SWEEP_DIMS:
        for n in NORM_SWEEP_ROWS:
            copies = cold_copies(torch.randn((n, d), generator=gen, device="cuda"))
            outs = [torch.empty((1, n), dtype=torch.float32, device="cuda")
                    for _ in NORM_KERNELS]
            us = []
            for variant, o in zip(NORM_KERNELS, outs):
                calls = [lambda a=copies[i % len(copies)], o=o, v=variant:
                         fn(*norm_args(a, o, v), stream)
                         for i in range(min(max(len(copies), 20), NORM_PROFILED_CALLS))]
                us.append(profiled_us(calls)[0])
                if fn(*norm_args(copies[0], o, variant), stream) != 0:
                    fail(f"rayflex_norm variant {variant} failed at ({n}, {d})")
            torch.cuda.synchronize()
            if not torch.equal(bits(outs[0]), bits(outs[1])):
                fail(f"norm variants differ at ({n}, {d})")
            shown = ["not measured" if u is None else f"{u:.3f} us" for u in us]
            say(f"phase 7 norm sweep {n} x {d}: device time a launch, warp a row "
                f"{shown[0]}, short-wide {shown[1]}; norm_variant picks "
                f"{NORM_KERNELS[norm_variant(n, d)]}")
            del copies, outs


# ---------------------------------------------------------------------------
# phase 7: brute-force vector search at ann-benchmarks shapes
# ---------------------------------------------------------------------------


def clustered_vectors(seed: int, n: int, d: int, n_q: int):
    """Database and queries as clustered Gaussians: ``N_CLUSTERS_ANN``
    centres N(0, 1), members N(centre, 0.35^2) per feature; the queries
    are drawn from the same clusters with their own noise."""
    rng = np.random.default_rng(seed)
    centres = rng.standard_normal((N_CLUSTERS_ANN, d), dtype=np.float32)
    db = centres[rng.integers(0, N_CLUSTERS_ANN, n)]
    db += 0.35 * rng.standard_normal((n, d), dtype=np.float32)
    q = centres[rng.integers(0, N_CLUSTERS_ANN, n_q)]
    q += 0.35 * rng.standard_normal((n_q, d), dtype=np.float32)
    return db, q


def score_error(got, want, scale) -> float:
    """Fail unless ``|got - want| <= SCORE_RTOL * scale`` everywhere (equal
    infinities included); return the largest |got - want|."""
    import torch
    diff = (got - want).abs()
    bad = ~(diff <= SCORE_RTOL * scale) & ~(got == want)
    if bool(bad.any()):
        fail(f"{int(bad.sum())} scores outside the tolerance, max |diff| "
             f"{float(diff[torch.isfinite(diff)].max())}")
    return float(diff[torch.isfinite(diff)].max()) if diff.numel() else 0.0


def scaled_error(got, want, scale) -> float:
    """The largest |got - want| / scale over finite scores: how much of
    the tolerance's scale an error uses (printed beside the gate)."""
    import torch
    ratio = (got - want).abs().div_(scale)
    ratio = ratio[torch.isfinite(ratio)]
    return float(ratio.max()) if ratio.numel() else 0.0


def check_nearest_vs_mxu(torch, label, engine, q, got, metric, tol_scale):
    """``got`` (the path's ``nearest``) against the mxu backend: indices
    equal on every query whose top-11 mxu scores are further apart than
    the score tolerance, and every picked index rank-equivalent."""
    want = engine.nearest(q, K_ANN + 1, metric, backend="mxu")
    gaps = (want.scores[:, 1:] - want.scores[:, :-1]).abs()
    clean = (gaps > SCORE_RTOL * tol_scale[:, None]).all(1)
    if not torch.equal(got.indices[clean], want.indices[clean, :K_ANN]):
        fail(f"{label}: nearest indices differ from mxu on well-separated queries")
    oracle = engine.scores(q[:CHUNK], metric, backend="mxu")
    picked = torch.gather(oracle, 1, got.indices[:CHUNK].long())
    if bool(((picked - want.scores[:CHUNK, :K_ANN]).abs()
             > SCORE_RTOL * tol_scale[:CHUNK, None]).any()):
        fail(f"{label}: nearest not rank-equivalent to mxu")
    return int(clean.sum())


def qps(fn, n: int) -> tuple[float, float]:
    ms = wall_ms(fn)
    return ms, n / ms * 1e3


def phase_brute(torch):
    from repro_torch.api import VectorIndex
    from repro_torch.kernels import nvcc
    from repro_torch.kernels.distance import (distance_cuda, distance_plain,
                                              norm_variant, norms_cuda, norms_plain)

    # ---- data, and the sift radius fixed from a sample ---------------------
    sift_db, sift_q = clustered_vectors(SEED + 1, SIFT_N, SIFT_D, N_QUERIES)
    glove_db, glove_q = clustered_vectors(SEED + 2, GLOVE_N, GLOVE_D, N_QUERIES)
    q_s = torch.as_tensor(sift_q, device="cuda")
    q_g = torch.as_tensor(glove_q, device="cuda")
    torch.cuda.synchronize()

    # ---- one counted drive of the path -------------------------------------
    nvcc.reset_launches()
    sift = VectorIndex.from_database(sift_db, device="cuda")
    s_eng = sift.engine(chunk_size=CHUNK)
    sample = s_eng.nearest(q_s[:256], TARGET_IN_RADIUS).scores[:, -1]
    radius = float(sample.median().sqrt())
    near = s_eng.nearest(q_s, K_ANN)
    ball = s_eng.within(q_s, radius, K_ANN)
    counts = s_eng.count_within(q_s, radius)
    torch.cuda.synchronize()
    sift_launches = nvcc.launch_counts().get("distance", 0)  # euclidean mode
    glove = VectorIndex.from_database(glove_db, device="cuda")
    g_eng = glove.engine(chunk_size=CHUNK)
    g_near = g_eng.nearest(q_g, K_ANN, "cosine")
    torch.cuda.synchronize()
    launches = nvcc.launch_counts()
    for name in ("distance", "norm"):
        if launches.get(name, 0) < 1:
            fail(f"the brute-force path launched no {name} kernel ({launches})")
    launches["distance (euclidean)"] = sift_launches
    launches["distance (angular)"] = launches["distance"] - sift_launches
    if min(sift_launches, launches["distance (angular)"]) < 1:
        fail(f"the brute-force path missed a distance mode ({launches})")

    # ---- results: shapes, finiteness, agreement with mxu -------------------
    for label, res in (("sift nearest", near), ("sift within", ball),
                       ("glove nearest", g_near)):
        if res.scores.shape != (N_QUERIES, K_ANN) or bool(torch.isnan(res.scores).any()):
            fail(f"{label}: malformed scores {tuple(res.scores.shape)}")
    if not bool(near.valid.all()) or not bool(g_near.valid.all()):
        fail("nearest left a slot empty")
    mean_in = float(counts.double().mean())
    if not 10 <= mean_in <= 100:
        fail(f"sift radius {radius}: mean in-radius count {mean_in} not in 10..100")
    if not torch.equal(ball.within.sum(1), counts.clamp(max=K_ANN)):
        fail("within's in-radius slots disagree with count_within")
    # the witnesses: mxu engines over the same databases whose ||c||^2 come
    # from the norm kernel's plain version, not from the kernel under test
    s_wit = VectorIndex(sift.database, sq_norms=norms_plain(sift.database)[0],
                        device="cuda")
    g_wit = VectorIndex(glove.database, sq_norms=norms_plain(glove.database)[0],
                        device="cuda")
    q2 = (q_s * q_s).sum(1)
    clean_s = check_nearest_vs_mxu(torch, "sift", s_wit.engine(chunk_size=CHUNK),
                                   q_s, near, "euclidean", q2 + s_wit.sq_norms.max())
    clean_g = check_nearest_vs_mxu(torch, "glove", g_wit.engine(chunk_size=CHUNK),
                                   q_g, g_near, "cosine", torch.ones_like(q_g[:, 0]))
    del s_wit, g_wit
    say(f"phase 7 sift-128-euclidean shape: {SIFT_N} x {SIFT_D} database "
        f"({SIFT_N * SIFT_D * 4 / 1e6:.0f} MB), {N_QUERIES} queries, chunks of "
        f"{CHUNK}; radius {radius:.6g} (mean in-radius count {mean_in:.2f}); "
        f"nearest equals mxu on all {clean_s} queries with separated top-11 "
        f"scores, rank-equivalent on the rest")
    say(f"phase 7 glove-100-angular shape: {GLOVE_N} x {GLOVE_D} database, "
        f"{N_QUERIES} queries; cosine nearest equals mxu on all {clean_g} queries "
        f"with separated top-11 scores (the mxu witnesses take ||c||^2 from "
        f"norms_plain)")

    # ---- each kernel against its plain version on the path's inputs --------
    # the kernels' inputs on the path: one query chunk against the whole
    # database, unpadded (the kernels mask ragged M, N and D)
    qp, cp = q_s[:CHUNK], sift.database
    scale = (qp * qp).sum(1)[:, None] + (cp * cp).sum(1)[None, :]
    dist_ms, d_k = event_ms(lambda: distance_cuda(qp, cp))
    dist_plain_ms, d_p = event_ms(lambda: distance_plain(qp, cp))
    dist_err = score_error(d_k, d_p, scale)
    dist_rel = scaled_error(d_k, d_p, scale)
    del d_k, d_p, scale
    dist_lib_ms, _ = event_ms(lambda: torch.cdist(
        qp, cp, compute_mode="use_mm_for_euclid_dist"))
    gp, gcp = q_g[:CHUNK], glove.database
    dot_ms, a_k = event_ms(lambda: distance_cuda(gp, gcp, mode="angular"))
    dot_plain_ms, a_p = event_ms(lambda: distance_plain(gp, gcp, "angular"))
    dot_scale = (gp * gp).sum(1).sqrt()[:, None] * (gcp * gcp).sum(1).sqrt()[None, :]
    dot_err = score_error(a_k, a_p, dot_scale)
    dot_rel = scaled_error(a_k, a_p, dot_scale)
    del a_k, a_p, dot_scale
    dot_lib_ms, _ = event_ms(lambda: torch.matmul(gp, gcp.T))  # TF32 is off
    n_k = norms_cuda(glove.database)
    norm_plain_ms, n_p = event_ms(lambda: norms_plain(glove.database))
    norm_err = score_error(n_k, n_p, n_p)
    n_d = torch.empty_like(n_k)
    if l2_copies(glove.database.numel() * 4 + n_d.numel() * 4) != 1:
        fail("glove's database no longer spans the L2 rotation on its own")
    norm_ms = device_ms("rayflex_norm", [norm_args(glove.database, n_d, norm_variant(
        *glove.database.shape))])
    if not torch.equal(bits(n_d), bits(n_k)):
        fail("norm kernel, timed alone, differs from its wrapper's output")
    # the wrapper's device time, window and host time at both brute-force
    # tables beside the library calls', both variants gated
    brute = {label: norm_checked(torch, f"phase 7 norm at {label}", table)
             for label, table in (("glove-shape", glove.database),
                                  ("sift-shape", sift.database))}
    norm_wrap_ms = brute["glove-shape"]["norms_cuda"]["window_ms"]
    norm_lib_ms = brute["glove-shape"]["vector_norm"]["window_ms"]
    norm_sweep(torch)
    m, n, d = qp.shape[0], cp.shape[0], qp.shape[1]
    dist_bound, dist_f32 = distance_bounds(m, n, d, euclidean=True)
    gm, gn, gd = gp.shape[0], gcp.shape[0], gp.shape[1]
    dot_bound, dot_f32 = distance_bounds(gm, gn, gd, euclidean=False)
    gn_raw = glove.database.shape[0]
    norm_bound = bound_ms(4.0 * (gn_raw * GLOVE_D + gn_raw), 2.0 * gn_raw * GLOVE_D)
    say(f"phase 7 distance kernel, euclidean {m} x {n} x {d}: {dist_ms:.3f} ms, "
        f"{2.0 * m * n * d / dist_ms / 1e9:.1f} TFLOP/s (2 M N D / time; plain "
        f"{dist_plain_ms:.3f}, torch.cdist {dist_lib_ms:.3f} [returns the root], "
        f"bound {dist_bound[0]:.3f} {dist_bound[1]} [3xTF32], old f32 bound "
        f"{dist_f32[0]:.3f} {dist_f32[1]}), max |err| {dist_err:.3g} "
        f"({dist_rel:.3g} of |q|^2 + |c|^2; gate {SCORE_RTOL:g})")
    say(f"phase 7 distance kernel, angular {gm} x {gn} x {gd}: {dot_ms:.3f} ms, "
        f"{2.0 * gm * gn * gd / dot_ms / 1e9:.1f} TFLOP/s (plain {dot_plain_ms:.3f}, "
        f"torch.matmul {dot_lib_ms:.3f}, bound {dot_bound[0]:.3f} {dot_bound[1]} "
        f"[3xTF32], old f32 bound {dot_f32[0]:.3f} {dot_f32[1]}), max |err| "
        f"{dot_err:.3g} ({dot_rel:.3g} of |q||c|; gate {SCORE_RTOL:g})")
    say(f"phase 7 norm kernel {gn_raw} x {GLOVE_D}: {norm_ms:.4f} ms alone "
        f"({DEVICE_REPS} back-to-back launches of the C entry point on one set, "
        f"itself over {L2_SPAN}x L2; the wrapper's "
        f"event window {norm_wrap_ms:.4f}; plain "
        f"{norm_plain_ms:.4f}, torch.linalg.vector_norm {norm_lib_ms:.4f} [returns "
        f"the root], bound {norm_bound[0]:.4f} {norm_bound[1]}), max |err| "
        f"{norm_err:.3g}")

    # ---- queries per second per call ---------------------------------------
    for label, fn in (
            ("sift nearest k=10", lambda: s_eng.nearest(q_s, K_ANN)),
            ("sift within k=10", lambda: s_eng.within(q_s, radius, K_ANN)),
            ("sift count_within", lambda: s_eng.count_within(q_s, radius)),
            ("glove cosine nearest k=10",
             lambda: g_eng.nearest(q_g, K_ANN, "cosine"))):
        ms, rate = qps(fn, N_QUERIES)
        say(f"phase 7 {label}: {ms:.3f} ms per call of {N_QUERIES} queries "
            f"(median of {TIMED_REPS}), {rate:.6g} queries/s")
    build_ms = wall_ms(lambda: VectorIndex.from_database(sift_db, device="cuda"))
    say(f"phase 7 VectorIndex.from_database (sift, copy in + norms): "
        f"{build_ms:.3f} ms")
    vectors = (sift_db, sift_q, glove_db, glove_q)  # on the host: phase 8 runs first
    rows = [
        kernel_row("distance (euclidean)", "distance.cu",
                   "src/repro/kernels/distance.py:33", launches, dist_ms,
                   dist_plain_ms, dist_err, dist_bound, dist_lib_ms),
        kernel_row("distance (angular)", "distance.cu",
                   "src/repro/kernels/distance.py:33", launches, dot_ms,
                   dot_plain_ms, dot_err, dot_bound, dot_lib_ms),
    ]
    rows[0]["f32_bound_ms"], rows[1]["f32_bound_ms"] = dist_f32[0], dot_f32[0]
    # the kernel's time: its device time from the profiler, else alone
    norm_dev = brute["glove-shape"]["norms_cuda"]["device_us"]
    rows.append(kernel_row("norm", "distance.cu", "src/repro/kernels/distance.py:65",
                           launches, norm_ms if norm_dev is None else norm_dev / 1e3,
                           norm_plain_ms, norm_err, norm_bound, norm_lib_ms,
                           wrapper_ms=norm_wrap_ms))
    rows[-1]["alone_ms"] = norm_ms
    rows[-1]["host_us"] = brute["glove-shape"]["norms_cuda"]["host_us"]
    return rows, vectors


# ---------------------------------------------------------------------------
# phase 8: tree neighbour search over a point cloud
# ---------------------------------------------------------------------------


def phase_tree(torch):
    from repro_torch.api import PointCloudScene
    from repro_torch.core.build.quality import clustered_soup
    from repro_torch.core.bvh import num_nodes
    from repro_torch.core.neighbor import (neighbor_wavefront, point_queries,
                                           point_sq_norms)
    from repro_torch.kernels import nvcc
    from repro_torch.kernels.common import LANES, ceil_to
    from repro_torch.kernels.traverse import (neighbor_launch, neighbor_packed,
                                              neighbor_variant, pack_point_bvh,
                                              pack_rays, query_order)

    rng = np.random.default_rng(SEED + 3)
    points = clustered_soup(rng, TREE_CLUSTERS, TREE_PER_CLUSTER, device="cuda").a
    n = points.shape[0]
    torch.cuda.synchronize()

    # ---- one counted drive of the path -------------------------------------
    nvcc.reset_launches()
    cloud = PointCloudScene.from_points(points, device="cuda")
    eng = cloud.engine()
    for kind, kw in (("nearest", dict(k=K_TREE)), ("within", dict(radius=TREE_RADIUS)),
                     ("count_within", dict(radius=TREE_RADIUS))):
        chosen = eng.resolve_neighbor_backend(kind, "euclidean", **kw)
        if chosen != "tree_cuda":
            fail(f"auto resolved {kind} to {chosen!r}, not 'tree_cuda'")
    near = eng.nearest(points, K_TREE)
    ball = eng.within(points, TREE_RADIUS, K_TREE)
    counts = eng.count_within(points, TREE_RADIUS)
    torch.cuda.synchronize()
    launches = nvcc.launch_counts()
    if launches.get("neighbor", 0) < 1:
        fail(f"the tree path launched no neighbor kernel ({launches})")
    if cloud.depth != 10 or cloud.bvh.node_lo.shape[0] != num_nodes(10):
        fail(f"unexpected tree: depth {cloud.depth}, {cloud.bvh.node_lo.shape[0]} nodes")
    if not bool(near.valid.all()) or not bool((near.scores[:, 0] == 0).all()):
        fail("nearest: a query did not find itself first")
    if not torch.equal(ball.within.sum(1), counts.clamp(max=K_TREE)):
        fail("within's in-radius slots disagree with count_within")

    # ---- the kernel bit-equal to neighbor_wavefront on every query ---------
    packed = pack_point_bvh(cloud.bvh)
    sq = point_sq_norms(cloud.points)
    records = {}
    for mode, radius in (("nearest", None), ("within", TREE_RADIUS)):
        rays = point_queries(points, radius, device="cuda")
        got = neighbor_packed(packed, rays, cloud.depth, K_TREE, mode=mode)
        plain_ms, want = event_ms(lambda: neighbor_wavefront(
            cloud.bvh, sq, rays, cloud.depth, K_TREE, mode), reps=1)
        err = same_bits(f"neighbor kernel vs neighbor_wavefront ({mode}) on all "
                        f"{n} queries", got, want)
        records[mode] = (rays, plain_ms, err, got)
    if not torch.equal(records["nearest"][3].index, near.indices) or \
            not torch.equal(records["within"][3].count, counts):
        fail("the engine's tree results differ from the kernel's on the same queries")
    # the same queries in a seeded random order: each query's loop is its
    # own in neighbor_wavefront, so its record on the permuted batch is the
    # record above with its rows permuted (rounds, the max, unchanged)
    perm = torch.as_tensor(np.random.default_rng(TREE_PERM_SEED).permutation(n),
                           device="cuda")
    want = records["nearest"][3]
    shuffled = point_queries(points[perm], None, device="cuda")
    got = neighbor_packed(packed, shuffled, cloud.depth, K_TREE, mode="nearest")
    gate_err = same_bits("neighbor kernel on the queries in a random order vs "
                         "neighbor_wavefront", got,
                         type(want)(*(f[perm] if f.ndim else f for f in want)))
    # k beyond the register lists: the general variant
    sub = point_queries(points[:K_WIDE_QUERIES], None, device="cuda")
    got = neighbor_packed(packed, sub, cloud.depth, K_WIDE, mode="nearest")
    want = neighbor_wavefront(cloud.bvh, sq, sub, cloud.depth, K_WIDE, "nearest")
    gate_err = max(gate_err, same_bits(
        f"neighbor kernel vs neighbor_wavefront (nearest k={K_WIDE}, variant "
        f"{neighbor_variant(K_WIDE)!r})", got, want))
    say(f"phase 8 cloud: {n} points (clustered_soup centres), LBVH depth "
        f"{cloud.depth}, {cloud.bvh.node_lo.shape[0]} nodes; every point is a "
        f"query; neighbor kernel bit-equal to neighbor_wavefront, every field, on "
        f"all {n} queries for nearest k={K_TREE} and within r={TREE_RADIUS}, on "
        f"the {n} queries in a random order (seed {TREE_PERM_SEED}) for nearest "
        f"k={K_TREE}, and on the first {K_WIDE_QUERIES} for nearest k={K_WIDE} "
        f"(variant {neighbor_variant(K_WIDE)!r}; {int(want.rounds)} rounds)")
    del got, want, sub, shuffled

    # ---- tree against brute force on the first queries ---------------------
    # The witness is exact: squared distances in float64 in the direct form
    # sum (q - c)^2, which does not cancel (f32 inputs, so each is exact to
    # ~1e-16 relative).  The band is the tree's own f32 rounding: it
    # evaluates (|q|^2 - 2 q.c) + |c|^2 with every op rounded, within
    # 8 u (|q|^2 + |c|^2) of the exact value to first order (u = 2^-24);
    # comparing two such values doubles it.  A candidate that matters lies
    # within rho = 2 max(r, d_k) of the query, so |c| <= |q| + rho.
    r_sq = TREE_RADIUS * TREE_RADIUS
    pts64 = points.double()
    sq64 = (pts64 * pts64).sum(1)
    bands = torch.empty(BRUTE_CHECK_QUERIES, dtype=torch.float64, device="cuda")
    tree_err = 0.0
    for lo in range(0, BRUTE_CHECK_QUERIES, BRUTE_CHUNK):
        hi = lo + BRUTE_CHUNK
        qc = pts64[lo:hi]
        s = (qc[:, 0:1] - pts64[None, :, 0]).square_()
        for ax in (1, 2):
            s.add_((qc[:, ax:ax + 1] - pts64[None, :, ax]).square_())
        kth = torch.topk(s, K_TREE, dim=1, largest=False).values
        rho = 2.0 * kth[:, -1:].clamp_min(r_sq).sqrt()
        q_norm = sq64[lo:hi, None].sqrt()
        band = 16.0 * U_F32 * (q_norm * q_norm + (q_norm + rho) ** 2)
        bands[lo:hi] = band[:, 0]
        must = (s <= r_sq - band).sum(1)
        may = (s <= r_sq + band).sum(1)
        c = counts[lo:hi]
        if not bool(((must <= c) & (c <= may)).all()):
            fail(f"count_within outside the brute band on queries {lo}..")
        w = ball.within[lo:hi]
        picked = torch.gather(s, 1, ball.indices[lo:hi].long().clamp(min=0))
        if bool((picked > r_sq + band)[w].any()):
            fail(f"within returned a point outside the band on queries {lo}..")
        picked = torch.gather(s, 1, near.indices[lo:hi].long())
        if bool(((picked - kth).abs() > band).any()):
            fail(f"nearest not rank-equivalent to brute force on queries {lo}..")
        tree_err = max(tree_err, float((near.scores[lo:hi].double() - picked).abs().max()))
        del s
    wide = int((bands >= r_sq).sum())
    if wide:
        fail(f"{wide} checked queries have a band >= r^2: the check cannot see "
             "in-radius points there")
    say(f"phase 8 check: tree against exact brute force (float64, direct form) "
        f"on the first {BRUTE_CHECK_QUERIES} queries: counts and within sets as "
        f"brute force has them outside the band 16 u (|q|^2 + (|q| + rho)^2) "
        f"(largest {float(bands.max()):.6g}, r^2 = {r_sq:.6g}, 0 queries with "
        f"band >= r^2), nearest rank-equivalent within that band; largest "
        f"|tree d^2 - exact d^2| on the nearest picks {tree_err:.6g}")

    # ---- timings -----------------------------------------------------------
    build_ms = wall_ms(lambda: PointCloudScene.from_points(points, device="cuda"))
    say(f"phase 8 build: {build_ms:.3f} ms for {n} points (LBVH + the index's "
        f"norms on the card, median of {TIMED_REPS})")
    for label, fn, rec in (
            (f"nearest k={K_TREE}", lambda: eng.nearest(points, K_TREE),
             records["nearest"][3]),
            (f"nearest k={K_TREE}, queries in a random order",
             lambda: eng.nearest(points[perm], K_TREE), records["nearest"][3]),
            (f"within r={TREE_RADIUS} k={K_TREE}",
             lambda: eng.within(points, TREE_RADIUS, K_TREE), records["within"][3]),
            (f"count_within r={TREE_RADIUS}",
             lambda: eng.count_within(points, TREE_RADIUS), records["within"][3])):
        ms, rate = qps(fn, n)
        say(f"phase 8 {label}: {ms:.3f} ms per call of {n} queries (median of "
            f"{TIMED_REPS}), {rate:.6g} queries/s; box_jobs/query "
            f"{rec.box_jobs.double().mean().item():.3f}, point_jobs/query "
            f"{rec.point_jobs.double().mean().item():.3f}, rounds {int(rec.rounds)}")
    say(f"phase 8 mean in-radius count {counts.double().mean().item():.3f}")

    # the kernel alone, on operands packed and ordered beforehand; the
    # schedule's prologue (the Z-order sort) alone; and neighbor_packed,
    # which packs, orders and launches (the span of the earlier kernel's ms)
    rays, plain_ms, err, rec = records["nearest"]
    prologue, order = event_times(lambda: query_order(rays.origin, packed.root[0],
                                                      packed.root[1]))
    kernel, caller = {}, {}
    for mode, (rays_m, *_rest) in records.items():
        op_m = pack_rays(rays_m, ceil_to(n, LANES))
        kernel[mode], _ = event_times(lambda: neighbor_launch(
            packed, op_m, order, n, cloud.depth, K_TREE, mode=mode))
        caller[mode], _ = event_times(lambda: neighbor_launch(
            packed, op_m, None, n, cloud.depth, K_TREE, mode=mode))
    spans, _ = event_times(lambda: neighbor_packed(packed, rays, cloud.depth, K_TREE,
                                                   mode="nearest"))
    times = sorted(kernel["nearest"])
    ms = statistics.median(times)
    say(f"phase 8 neighbor kernel (nearest k={K_TREE}, {n} queries, variant "
        f"{neighbor_variant(K_TREE)!r}): min {times[0]:.3f} / median {ms:.3f} / max "
        f"{times[-1]:.3f} ms over {TIMED_REPS} runs (caller order: median "
        f"{statistics.median(caller['nearest']):.3f}); within r={TREE_RADIUS}: median "
        f"{statistics.median(kernel['within']):.3f} ms (caller order: "
        f"{statistics.median(caller['within']):.3f}); order prologue "
        f"(query_order, Z-order sort): median {statistics.median(prologue):.3f} ms; "
        f"neighbor_packed (pack + order + launch, nearest): median "
        f"{statistics.median(spans):.3f} ms (min {min(spans):.3f}, max {max(spans):.3f})")
    # SIMT-efficiency proxy: lane-rounds a warp of 32 spends (32 x its
    # slowest query's pops) per pop done, in the caller's order and in the
    # kernel's launch order
    box = rec.box_jobs.double()
    for label, b in (("caller order", box), ("launch order", box[order.long()])):
        w = b.view(-1, 32)
        say(f"phase 8 SIMT proxy ({label}): sum over warps of 32 max(box_jobs) / "
            f"sum box_jobs = {float(32 * w.amax(1).sum() / w.sum()):.4f}")
    # bound: the distinct bytes (each query's operands and outputs, the
    # packed tree, leaf table and cloud, each once) against the f32
    # operations this run's job counters count
    pops = float(rec.box_jobs.double().sum())
    pt_jobs = float(rec.point_jobs.double().sum())
    inner = pops - pt_jobs / 4
    tree_bytes = sum(t.numel() * t.element_size() for t in packed)
    bound = bound_ms(n * (NEIGH_QUERY_BYTES + 8 * K_TREE) + tree_bytes,
                     inner * NEIGH_BOX_OPS + pt_jobs * NEIGH_POINT_OPS)
    job_bytes = (n * (NEIGH_QUERY_BYTES + 8 * K_TREE) + inner * NEIGH_BOX_BYTES
                 + pt_jobs * NEIGH_POINT_BYTES)
    say(f"phase 8 neighbor kernel (nearest k={K_TREE}, {n} queries): {ms:.3f} ms, "
        f"plain {plain_ms:.1f} ms, bound {bound[0]:.4f} ms ({bound[1]}; "
        f"{tree_bytes / 1e6:.1f} MB of packed tree and cloud, "
        f"{(inner * NEIGH_BOX_OPS + pt_jobs * NEIGH_POINT_OPS) / n:.1f} f32 ops "
        f"per query); estimate, not a bound: every job's bytes from HBM "
        f"{job_bytes / 1e9:.3f} GB = {job_bytes / HBM_BYTES_PER_S * 1e3:.4f} ms")
    return [kernel_row("neighbor", "neighbor.cu", "src/repro/kernels/traverse.py:369",
                       launches, ms, plain_ms, max(err, records["within"][2], gate_err),
                       bound)]


# ---------------------------------------------------------------------------
# phase 9: the unified mixed-opcode stream
# ---------------------------------------------------------------------------


def stream_jobs(torch, stage_jobs, vectors):
    """The merged stream as a (T, 128) ``DatapathJob``, and where each
    source's beats landed.  Source beats keep their order; the merge order
    is a seeded random permutation of the sources' beat labels."""
    from repro_torch.core.stream import make_jobs
    from repro_torch.core.types import OP_ANGULAR, OP_EUCLIDEAN, OP_QUADBOX, OP_TRIANGLE
    from repro_torch.kernels.common import LANES

    rng = np.random.default_rng(STREAM_SEED)
    sift_db, sift_q, glove_db, glove_q = vectors

    def pairs(q, db, n):
        """n (query, database row) pairs drawn from the seed, on the card."""
        qi, ci = rng.integers(0, q.shape[0], n), rng.integers(0, db.shape[0], n)
        return torch.as_tensor(q[qi], device="cuda"), torch.as_tensor(db[ci], device="cuda")

    ea, eb = pairs(sift_q, sift_db, E_PAIRS)
    aa, ab = pairs(glove_q, glove_db, A_PAIRS)
    e_beats, a_beats = -(-ea.shape[1] // 16), -(-aa.shape[1] // 8)  # per pair
    primary, emitters = stage_jobs["primary"], stage_jobs["emitters"]
    to_tri, corners = stage_jobs["to_tri"], stage_jobs["corners"]
    n_box, n_tri = primary.origin.shape[0], to_tri.origin.shape[0]
    beats = {OP_EUCLIDEAN: E_PAIRS // LANES * e_beats, OP_ANGULAR: A_PAIRS // LANES * a_beats,
             OP_QUADBOX: -(-n_box // LANES), OP_TRIANGLE: -(-n_tri // LANES)}
    labels = rng.permutation(np.repeat(list(beats), list(beats.values())))
    t = labels.shape[0]
    jobs = make_jobs((t, LANES), device="cuda")
    jobs.opcode.copy_(torch.as_tensor(labels, device="cuda")[:, None].expand(t, LANES))
    pos = {op: torch.as_tensor(np.flatnonzero(labels == op), device="cuda") for op in beats}
    lanes = torch.arange(LANES, device="cuda")

    def place(leaf, op, values):
        """Write ``values`` (jobs in source order, beat-major) into the
        columns of the beats of source ``op``."""
        flat = (pos[op][:, None] * LANES + lanes).reshape(-1)[:values.shape[0]]
        leaf.view((-1,) + tuple(leaf.shape[2:]))[flat] = values

    def vector_beats(x, width, n_beats):
        """(pairs, D) -> one job per (pair beat, lane), in source order:
        pair = slot * 128 + lane, beats of a pair consecutive."""
        x = torch.nn.functional.pad(x, (0, n_beats * width - x.shape[1]))
        x = x.view(-1, LANES, n_beats, width).permute(0, 2, 1, 3)
        return x.reshape(-1, width)

    beat_in_pair = lambda op, n_beats: (
        torch.arange(beats[op], device="cuda") % n_beats)[:, None].expand(-1, LANES).reshape(-1)
    place(jobs.vec_a, OP_EUCLIDEAN, vector_beats(ea, 16, e_beats))
    place(jobs.vec_b, OP_EUCLIDEAN, vector_beats(eb, 16, e_beats))
    place(jobs.reset_accum, OP_EUCLIDEAN, beat_in_pair(OP_EUCLIDEAN, e_beats) == 0)
    k = beat_in_pair(OP_ANGULAR, a_beats)
    live = aa.shape[1] - 8 * (a_beats - 1)  # live lanes of a pair's last beat
    count = torch.where(k == a_beats - 1, live, 8)
    pad8 = lambda x: torch.nn.functional.pad(x, (0, 8))
    place(jobs.vec_a, OP_ANGULAR, pad8(vector_beats(aa, 8, a_beats)))
    place(jobs.vec_b, OP_ANGULAR, pad8(vector_beats(ab, 8, a_beats)))
    place(jobs.mask, OP_ANGULAR, torch.arange(16, device="cuda") < count[:, None])
    place(jobs.reset_accum, OP_ANGULAR, k == 0)
    for op, ray in ((OP_QUADBOX, primary), (OP_TRIANGLE, to_tri)):
        for leaf, values in zip(jobs.ray, ray):
            place(leaf, op, values)
    place(jobs.boxes.lo, OP_QUADBOX, emitters.lo)
    place(jobs.boxes.hi, OP_QUADBOX, emitters.hi)
    for leaf, values in zip(jobs.triangle, corners):
        place(leaf, OP_TRIANGLE, values)
    return jobs, pos, beats, {OP_EUCLIDEAN: e_beats, OP_ANGULAR: a_beats}, (ea, eb, aa, ab)


def phase_stream(torch, stage_jobs, vectors):
    from repro_torch.core.datapath import angular_distance_parts, euclidean_distance_sq
    from repro_torch.core.types import OP_ANGULAR, OP_EUCLIDEAN, OP_QUADBOX, OP_TRIANGLE
    from repro_torch.kernels import nvcc
    from repro_torch.kernels.common import LANES, N_OPERAND_ROWS
    from repro_torch.kernels.ops import (pack_unified, ray_box_kernel,
                                         ray_triangle_kernel, unified_datapath)
    from repro_torch.kernels.unified import unified, unified_plain

    jobs, pos, beats, per_pair, (ea, eb, aa, ab) = stream_jobs(torch, stage_jobs, vectors)
    t = jobs.opcode.shape[0]
    n_jobs = t * LANES
    torch.cuda.synchronize()

    # ---- one counted drive of the path -------------------------------------
    nvcc.reset_launches()
    out = unified_datapath(jobs)
    torch.cuda.synchronize()
    launches = nvcc.launch_counts()
    if launches.get("unified", 0) < 1:
        fail(f"the unified path launched no unified kernel ({launches})")
    for f in out._fields:
        if getattr(out, f).shape[:2] != (t, LANES):
            fail(f"unified_datapath: malformed {f} {tuple(getattr(out, f).shape)}")
    for f in ("tmin", "t_num", "t_denom", "euclidean_accumulator",
              "angular_dot_product", "angular_norm"):
        if bool(torch.isnan(getattr(out, f)).any()):
            fail(f"unified_datapath: NaN in {f}")

    # ---- gate 1: the kernel bit-equal to unified_plain, every row ----------
    opcodes, operands = pack_unified(jobs)
    ms, k_out = event_ms(lambda: unified(opcodes, operands))
    plain_ms, p_out = event_ms(lambda: unified_plain(opcodes, operands), reps=1)
    err = same_bits(f"unified kernel vs unified_plain on all {t} beats, 16 rows",
                    (k_out,), (p_out,))
    del p_out
    if not torch.equal(bits(out.euclidean_accumulator.reshape(-1)), bits(k_out[0])) or \
            not torch.equal(out.box_index.reshape(-1, 4).T.float(), k_out[4:8]):
        fail("unified_datapath's records differ from the kernel's output rows")

    # ---- gates 2 and 3: each pair's final accumulators ---------------------
    def final(field, op):
        """Each pair's last beat's ``field``, in pair order."""
        last = pos[op].view(-1, per_pair[op])[:, -1]
        return getattr(out, field)[last].reshape(-1)

    e_got = final("euclidean_accumulator", OP_EUCLIDEAN)
    same_bits(f"final euclidean accumulator vs euclidean_distance_sq on {E_PAIRS} pairs",
              (e_got,), (euclidean_distance_sq(ea, eb),))
    # float64 witness in the direct form; the port's f32 sum carries at most
    # 3 roundings per term (subtract, square) and 12 adds (4 tree levels, 8
    # beats), so it lies within 16 u of the exact sum of its terms
    e_wit = ((ea.double() - eb.double()) ** 2).sum(1)
    e_bound = 16 * U_F32 * e_wit
    e_err = (e_got.double() - e_wit).abs()
    if bool((e_err > e_bound).any()):
        fail(f"euclidean accumulators outside 16 u of the float64 witness "
             f"({int((e_err > e_bound).sum())} pairs)")
    d_got = final("angular_dot_product", OP_ANGULAR)
    n_got = final("angular_norm", OP_ANGULAR)
    d_ref, n_ref = angular_distance_parts(aa, ab)
    same_bits(f"final angular dot / norm vs angular_distance_parts on {A_PAIRS} pairs",
              (d_got, n_got), (d_ref, n_ref))
    qn, cn = aa.double().norm(dim=1), ab.double().norm(dim=1)
    d_err = (d_got.double() - (aa.double() * ab.double()).sum(1)).abs()
    n_err = (n_got.double() - cn * cn).abs()
    if bool((d_err > 1e-5 * qn * cn).any()) or bool((n_err > 1e-5 * cn * cn).any()):
        fail("angular accumulators outside 1e-5 |q||c| / 1e-5 |c|^2 of the float64 witness")
    say(f"phase 9 check: {t} beats x {LANES} lane-streams ({n_jobs} jobs; "
        f"{beats[OP_EUCLIDEAN]} euclidean, {beats[OP_ANGULAR]} angular, "
        f"{beats[OP_QUADBOX]} quadbox, {beats[OP_TRIANGLE]} triangle beats): kernel "
        f"bit-equal to unified_plain on all 16 rows; the final accumulators of all "
        f"{E_PAIRS} euclidean and {A_PAIRS} angular pairs bit-equal to "
        f"euclidean_distance_sq / angular_distance_parts; largest |err| against the "
        f"float64 witness: euclidean {float(e_err.max()):.6g} (bound 16 u d^2, "
        f"largest {float((e_err / e_wit.clamp_min(1e-30)).max()):.4g} d^2), dot "
        f"{float((d_err / (qn * cn)).max()):.4g} |q||c|, norm "
        f"{float((n_err / (cn * cn)).max()):.4g} |c|^2")
    del e_wit, e_err, d_err, n_err

    # ---- gate 4: box and triangle beats against the stage kernels ----------
    primary, emitters = stage_jobs["primary"], stage_jobs["emitters"]
    to_tri, corners = stage_jobs["to_tri"], stage_jobs["corners"]
    qb = ray_box_kernel(primary, emitters)
    take = lambda x, op, n: x[pos[op]].reshape((-1,) + tuple(x.shape[2:]))[:n]
    n_box, n_tri = primary.origin.shape[0], to_tri.origin.shape[0]
    same_bits("the stream's quadbox beats vs the raybox kernel",
              (take(out.tmin, OP_QUADBOX, n_box), take(out.box_index, OP_QUADBOX, n_box),
               take(out.is_intersect, OP_QUADBOX, n_box)), qb)
    tr = ray_triangle_kernel(to_tri, corners)
    same_bits("the stream's triangle beats vs the raytri kernel",
              (take(out.t_num, OP_TRIANGLE, n_tri), take(out.t_denom, OP_TRIANGLE, n_tri),
               take(out.triangle_hit, OP_TRIANGLE, n_tri)), tr)
    say(f"phase 9 check: the {n_box} quadbox and {n_tri} triangle jobs bit-equal to "
        f"the standalone raybox / raytri kernels on the same jobs")

    # ---- timings -----------------------------------------------------------
    e2e_ms = wall_ms(lambda: unified_datapath(jobs))
    op_beats = torch.bincount(opcodes.long(), minlength=4).cpu().tolist()
    n_bytes = 4.0 * t + 4.0 * LANES * sum(
        b * (STREAM_ROWS_IN[op] + STREAM_ROWS_OUT) for op, b in enumerate(op_beats))
    bound = bound_ms(n_bytes, LANES * sum(b * STREAM_OPS[op] for op, b in enumerate(op_beats)))
    say(f"phase 9 unified_datapath (pack, kernel, unpack): {e2e_ms:.3f} ms per call of "
        f"{n_jobs} jobs (median of {TIMED_REPS}), {n_jobs / e2e_ms * 1e3:.6g} jobs/s; "
        f"operands {N_OPERAND_ROWS * n_jobs * 4 / 1e9:.3f} GB, output "
        f"{16 * n_jobs * 4 / 1e9:.3f} GB")
    say(f"phase 9 unified kernel: {ms:.4f} ms, bound {bound[0]:.4f} ms ({bound[1]}; "
        f"{n_bytes / 1e9:.4f} GB of live operand rows and outputs), plain "
        f"{plain_ms:.1f} ms (one run after a warm-up)")
    del jobs, out, opcodes, operands, k_out

    # ---- the worst case: a stream of the same length with no reset ---------
    gen = torch.Generator(device="cuda").manual_seed(STREAM_SEED)
    ops_nr = torch.full((t,), OP_EUCLIDEAN, dtype=torch.int32, device="cuda")
    opnd_nr = torch.zeros((N_OPERAND_ROWS, n_jobs), device="cuda")
    opnd_nr[9:41] = torch.randn((32, n_jobs), generator=gen, device="cuda")
    opnd_nr[41] = 16.0
    nr_ms, nr_k = event_ms(lambda: unified(ops_nr, opnd_nr), reps=3)
    nr_p = unified_plain(ops_nr, opnd_nr)
    same_bits("no-reset stream: unified kernel vs unified_plain", (nr_k,), (nr_p,))
    say(f"phase 9 no-reset stream: {t} OpEuclidean beats, no reset (128 chains of "
        f"{t} beats, the kernel's worst case): kernel {nr_ms:.3f} ms (median of 3), "
        f"bit-equal to unified_plain")
    del opnd_nr, nr_k, nr_p
    return [kernel_row("unified", "unified.cu", "src/repro/kernels/unified.py:206",
                       launches, ms, plain_ms, err, bound)]


# ---------------------------------------------------------------------------
# phase 10: dynamic scenes (refit of triangles and of a point cloud)
# ---------------------------------------------------------------------------


def phase_dynamic(torch):
    from repro_torch.api import PointCloudScene, Ray, Scene, make_ray
    from repro_torch.core.build.quality import clustered_soup
    from repro_torch.core.datapath import ray_triangle_test
    from repro_torch.core.neighbor import (leaf_dist_sq, neighbor_wavefront,
                                           point_queries, point_sq_norms)
    from repro_torch.core.types import Triangle
    from repro_torch.core.wavefront import trace_wavefront
    from repro_torch.kernels import nvcc
    from repro_torch.kernels.distance import norms_plain
    from repro_torch.kernels.traverse import pack_bvh

    tri = clustered_soup(np.random.default_rng(SEED), N_CLUSTERS, PER_CLUSTER, device="cuda")
    vel = torch.as_tensor(np.random.default_rng(ANIM_SEED).normal(
        0.0, ANIM_SIGMA, (N_CLUSTERS, 3)).astype(np.float32), device="cuda")
    vel = vel.repeat_interleave(PER_CLUSTER, dim=0)  # clustered_soup's order
    frames = [Triangle(*(v + f * vel for v in tri)) for f in range(1, FRAMES + 1)]
    points = clustered_soup(np.random.default_rng(SEED + 3), TREE_CLUSTERS,
                            TREE_PER_CLUSTER, device="cuda").a
    jitter = np.random.default_rng(CLOUD_JITTER_SEED).normal(
        0.0, CLOUD_JITTER, tuple(points.shape)).astype(np.float32)
    moved_pts = points + torch.as_tensor(jitter, device="cuda")
    light = torch.tensor([9.0, 11.0, -13.0], device="cuda")

    def shadow_rays(primary, hits):
        idx = torch.nonzero(hits.hit).squeeze(1)
        p = primary.origin[idx] + hits.t[idx, None] * primary.direction[idx]
        to_light = light - p
        dist = torch.linalg.vector_norm(to_light, dim=1)
        return make_ray(p, to_light / dist[:, None], dist, device="cuda")

    # ---- one counted drive of the path -------------------------------------
    torch.cuda.synchronize()
    nvcc.reset_launches()
    scene = Scene.from_triangles(tri, device="cuda")
    built = scene.bvh
    engine = scene.engine()
    scene.refit(tri)  # the build's own triangles
    refit_same = scene.bvh
    org, dirs = camera_rays(scene)
    primary = make_ray(org, dirs, device="cuda")
    if engine.resolve_trace_backend() != "cuda":
        fail(f"auto resolved the trace to {engine.resolve_trace_backend()!r}")
    series = [engine.trace(primary)]
    shadow_blocks = set()
    for moved in frames:
        scene.refit(moved)
        hits = engine.trace(primary)
        shadow = shadow_rays(primary, hits)
        occluded = engine.occluded(shadow)
        series.append(hits)
        shadow_blocks.add(engine.plan_for("trace", shadow.origin.shape[0],
                                          ray_type="shadow").key)
    cloud = PointCloudScene.from_points(points, device="cuda")
    c_eng = cloud.engine()
    cloud.refit(moved_pts)
    refit_sq = cloud.index.sq_norms
    if c_eng.resolve_neighbor_backend("nearest", "euclidean", k=K_TREE) != "tree_cuda":
        fail("auto did not resolve the refit cloud's nearest to tree_cuda")
    near = c_eng.nearest(moved_pts, K_TREE)
    torch.cuda.synchronize()
    launches = nvcc.launch_counts()
    for name in ("traverse", "norm", "neighbor"):
        if launches.get(name, 0) < 1:
            fail(f"the dynamic-scene path launched no {name} kernel ({launches})")
    say(f"phase 10 drive: build, refit with the build's triangles, {FRAMES} frames of "
        f"refit + closest trace + occluded, cloud refit + nearest; launches "
        + ", ".join(f"{k} {launches[k]}" for k in ("traverse", "norm", "neighbor")))

    # ---- refit of unchanged geometry: the build, bit for bit ---------------
    same_bits("refit of the build's own triangles vs the build",
              (refit_same.node_lo, refit_same.node_hi, refit_same.leaf_tri,
               refit_same.leaf_perm, *refit_same.triangles),
              (built.node_lo, built.node_hi, built.leaf_tri, built.leaf_perm,
               *built.triangles))
    del built, refit_same

    # ---- the last frame ------------------------------------------------------
    moved = frames[-1]
    n_rays = primary.origin.shape[0]
    want = trace_wavefront(scene.bvh, primary, scene.depth)
    same_bits(f"cuda trace on the refit scene vs trace_wavefront, all {n_rays} rays",
              hits, want)
    if bool(hits.stack_overflow.any()) or bool(torch.isnan(hits.t).any()):
        fail("last frame: stack overflow or NaN t")
    n_shadow = shadow.origin.shape[0]
    same_bits(f"occluded on the refit scene vs trace_wavefront's shadow hit, all "
              f"{n_shadow} shadow rays", (occluded,),
              (trace_wavefront(scene.bvh, shadow, scene.depth, ray_type="shadow").hit,))
    rebuild = Scene.from_triangles(moved, device="cuda")
    rb_engine = rebuild.engine()
    rb_hits = rb_engine.trace(primary)
    same_bits("refit vs rebuild: hit and t", (hits.hit, hits.t), (rb_hits.hit, rb_hits.t))
    d = torch.nonzero(hits.tri_index != rb_hits.tri_index).squeeze(1)

    def t_of(idx):
        r = Ray(*(f[d] for f in primary))
        res = ray_triangle_test(r, Triangle(*(v[idx[d].long()] for v in moved)))
        return res.t_num / res.t_denom

    same_bits(f"the {d.numel()} rays whose triangles differ: both triangles' t",
              (t_of(hits.tri_index),), (t_of(rb_hits.tri_index),))
    n_hit = int(hits.hit.sum())
    say(f"phase 10 last frame (frame {FRAMES}): {n_rays} camera rays, {n_hit} hits; the "
        f"cuda trace on the refit scene bit-equal to trace_wavefront on every field; "
        f"hit and t bit-equal to a rebuild's on every ray; tri_index differs on {d.numel()} "
        f"rays, each a tie (both triangles give the ray the same t); occluded equal to "
        f"trace_wavefront's shadow hit on all {n_shadow} shadow rays "
        f"({int(occluded.sum())} occluded)")
    decay = ", ".join(f"{f}: {r.quadbox_jobs.double().mean().item():.3f} / "
                      f"{r.triangle_jobs.double().mean().item():.3f}"
                      for f, r in enumerate(series))
    say(f"phase 10 jobs per camera ray on the refit tree, box / triangle, by frame "
        f"(0: refit of the build) {decay}; rebuild of frame {FRAMES}: "
        f"{rb_hits.quadbox_jobs.double().mean().item():.3f} / "
        f"{rb_hits.triangle_jobs.double().mean().item():.3f}")
    # ---- the engine's cache over the frames ---------------------------------
    info = engine.cache_info()
    want_entries = 2 + len(shadow_blocks)  # closest, prepare, a shadow plan each
    if engine.prepares != FRAMES + 1 or info.misses != info.entries or \
            info.entries != want_entries:
        fail(f"cache over the frames: {info}, {engine.prepares} prepares; want one "
             f"miss per key ({want_entries} keys) and {FRAMES + 1} prepares")
    say(f"phase 10 cache: {info} over {FRAMES + 1} closest traces and {FRAMES} "
        f"occluded calls: one miss per key (the closest trace, the prepare hook, "
        f"{len(shadow_blocks)} shadow plans), {engine.prepares} re-packs for "
        f"{FRAMES + 1} versions")
    say(f"phase 10 plan_for('trace', 2**20): {engine.plan_for('trace', 2**20)}; "
        f"batch_multiple: trace {engine.batch_multiple('trace')}, nearest "
        f"{c_eng.batch_multiple('nearest', k=K_TREE)}")

    for label, sc in (("refit", scene), ("rebuild", rebuild)):
        st = sc.stats()
        say(f"phase 10 stats ({label}, frame {FRAMES}): sah_cost {st.sah_cost:.6g}, "
            f"mean jobs {st.mean_jobs:.3f} (box {st.mean_quadbox_jobs:.3f}, triangle "
            f"{st.mean_triangle_jobs:.3f}) on 256 probe rays, branching "
            f"{st.mean_branching_factor:.4f}, occupancy {st.occupancy:.4f}, "
            f"{st.bytes_per_node} B a node")

    # ---- the oracle on the frame's first hit rays ---------------------------
    first = torch.nonzero(hits.hit).squeeze(1)[:ORACLE_RAYS]
    sub = Ray(*(f[first] for f in primary))
    t0 = time.perf_counter()
    oracle = engine.trace(sub, backend="per_ray")
    torch.cuda.synchronize()
    oracle_s = time.perf_counter() - t0
    same_bits(f"per_ray oracle vs the cuda backend on the frame's first {ORACLE_RAYS} "
              f"hit rays", oracle, engine.trace(sub))
    say(f"phase 10 oracle: per_ray on the last frame's first {ORACLE_RAYS} hit rays "
        f"equals the cuda backend on every field ({oracle_s:.2f} s on the host loop, "
        f"{int(oracle.quadbox_jobs.sum())} pops)")

    # ---- the refit cloud ----------------------------------------------------
    n_pts = moved_pts.shape[0]
    want_sq = norms_plain(cloud.index.database)[0]
    norm_err = score_error(refit_sq, want_sq, want_sq)
    say(f"phase 10 cloud index norms after the refit: norm kernel vs norms_plain on "
        f"all {n_pts} x 3 rows, max |err| {norm_err:.3g} (gate {SCORE_RTOL:g} of the "
        f"norm)")
    rays = point_queries(moved_pts, None, device="cuda")
    got = c_eng.neighbor_search(moved_pts, K_TREE, mode="nearest")
    want = neighbor_wavefront(cloud.bvh, point_sq_norms(cloud.points), rays,
                              cloud.depth, K_TREE, "nearest")
    same_bits(f"tree_cuda vs tree_wavefront on the refit cloud, all {n_pts} queries",
              got, want)
    if not torch.equal(near.indices, got.index):
        fail("the engine's nearest on the refit cloud differs from its tree_cuda record")
    rb_cloud = PointCloudScene.from_points(moved_pts, device="cuda")
    rb_near = rb_cloud.engine().nearest(moved_pts, K_TREE)
    same_bits("refit cloud vs rebuild: dist_sq and valid", (near.scores, near.valid),
              (rb_near.scores, rb_near.valid))
    q, slot = torch.nonzero(near.indices != rb_near.indices, as_tuple=True)
    pair = torch.stack([near.indices[q, slot], rb_near.indices[q, slot]], 1).long()
    d2 = leaf_dist_sq(moved_pts[q], moved_pts[pair], point_sq_norms(moved_pts)[pair])
    same_bits("the slots whose indices differ: both points' distance",
              (d2[:, 0],), (d2[:, 1],))
    rb_rec = rb_cloud.engine().neighbor_search(moved_pts, K_TREE, mode="nearest")
    say(f"phase 10 cloud: {n_pts} points jittered by N(0, {CLOUD_JITTER}^2) (seed "
        f"{CLOUD_JITTER_SEED}), PointCloudScene.refit; nearest k={K_TREE} on tree_cuda "
        f"bit-equal to tree_wavefront on every field; dist_sq bit-equal to a rebuild's, "
        f"indices differ in {q.numel()} slots, each a tie; box / point jobs a query "
        f"{want.box_jobs.double().mean().item():.3f} / "
        f"{want.point_jobs.double().mean().item():.3f} (rebuild "
        f"{rb_rec.box_jobs.double().mean().item():.3f} / "
        f"{rb_rec.point_jobs.double().mean().item():.3f})")

    # ---- timings ------------------------------------------------------------
    refit_ms = wall_ms(lambda: scene.refit(moved))
    build_ms = wall_ms(lambda: Scene.from_triangles(moved, device="cuda"))
    first_trace = []
    for _ in range(TIMED_REPS):
        scene.refit(moved)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.trace(primary)
        torch.cuda.synchronize()
        first_trace.append((time.perf_counter() - t0) * 1e3)
    steady_ms = wall_ms(lambda: engine.trace(primary))
    repack_ms, _ = event_ms(lambda: pack_bvh(scene.bvh))
    c_refit_ms = wall_ms(lambda: cloud.refit(moved_pts))
    c_build_ms = wall_ms(lambda: PointCloudScene.from_points(moved_pts, device="cuda"))
    say(f"phase 10 times (median of {TIMED_REPS}): Scene.refit {refit_ms:.3f} ms vs "
        f"Scene.from_triangles {build_ms:.3f} ms ({N_CLUSTERS * PER_CLUSTER} triangles); "
        f"first trace after a refit (re-pack included) "
        f"{statistics.median(first_trace):.3f} ms vs steady {steady_ms:.3f} ms "
        f"({n_rays} rays; the re-pack alone, pack_bvh: {repack_ms:.3f} ms, device "
        f"time); PointCloudScene.refit "
        f"{c_refit_ms:.3f} ms vs from_points {c_build_ms:.3f} ms ({n_pts} points)")


# ---------------------------------------------------------------------------
# phase 11: the datapath twins (arity, stack size, node-box codecs, builders)
# ---------------------------------------------------------------------------


def phase_twins(torch):
    from repro_torch.api import Ray, Scene, make_ray
    from repro_torch.convert import config_from_tag
    from repro_torch.core.build.quality import clustered_soup
    from repro_torch.core.bvh import DatapathConfig
    from repro_torch.core.datapath import ray_triangle_test
    from repro_torch.core.types import Triangle
    from repro_torch.core.wavefront import trace_wavefront
    from repro_torch.kernels import nvcc
    from repro_torch.kernels.traverse import pack_bvh, traverse_packed

    tri = clustered_soup(np.random.default_rng(SEED), N_CLUSTERS, PER_CLUSTER, device="cuda")
    light = torch.tensor([9.0, 11.0, -13.0], device="cuda")
    primary = None
    n_rays = RES * RES
    out, rows = {}, []
    for builder, tag in TWIN_CONFIGS:
        config = config_from_tag(tag)
        label = f"{builder}/{tag}"
        # ---- one counted drive: build, closest, any, shadow ------------------
        torch.cuda.synchronize()
        nvcc.reset_launches()
        scene = Scene.from_triangles(tri, builder=builder, config=config, device="cuda")
        engine = scene.engine()
        if primary is None:  # the first tree's root box frames every config's camera
            primary = make_ray(*camera_rays(scene), device="cuda")
        closest = engine.trace(primary)
        anyhit = engine.trace(primary, "any")
        idx = torch.nonzero(closest.hit).squeeze(1)
        p = primary.origin[idx] + closest.t[idx, None] * primary.direction[idx]
        to_light = light - p
        dist = torch.linalg.vector_norm(to_light, dim=1)
        shadow_rays = make_ray(p, to_light / dist[:, None], dist, device="cuda")
        shadow = engine.trace(shadow_rays, "shadow")
        torch.cuda.synchronize()
        launches = nvcc.launch_counts().get("traverse", 0)
        if engine.resolve_trace_backend() != "cuda" or launches < 3:
            fail(f"phase 11 {label}: the drive launched the traversal kernel "
                 f"{launches} times on backend {engine.resolve_trace_backend()!r}")
        if scene.config != config or scene.builder != builder:
            fail(f"phase 11 {label}: the scene holds {scene.builder}/{scene.config.tag}")
        if bool(torch.isnan(closest.t).any()) or not bool(((closest.t > 0) | ~closest.hit).all()):
            fail(f"phase 11 {label}: malformed closest t")

        # ---- the kernel against its plain version, every field --------------
        packed = pack_bvh(scene.bvh, config)
        if packed.kids.dtype != config.packed_box_dtype:
            fail(f"phase 11 {label}: child records packed as {packed.kids.dtype}")
        kern_ms, rec_k = event_ms(lambda: traverse_packed(packed, primary, scene.depth,
                                                          config=config))
        plain_ms, rec_p = event_ms(lambda: trace_wavefront(scene.bvh, primary, scene.depth,
                                                           config=config), reps=1)
        err = same_bits(f"phase 11 {label}: kernel vs trace_wavefront, {n_rays} closest "
                        f"rays", rec_k, rec_p)
        same_bits(f"phase 11 {label}: engine closest trace vs trace_wavefront",
                  closest, rec_p)
        for rtype, rays, rec in (("any", primary, anyhit), ("shadow", shadow_rays, shadow)):
            same_bits(f"phase 11 {label}: engine {rtype} trace vs trace_wavefront, all "
                      f"{rays.origin.shape[0]} rays", rec,
                      trace_wavefront(scene.bvh, rays, scene.depth, ray_type=rtype,
                                      config=config))

        # ---- times and sizes -------------------------------------------------
        build_ms = wall_ms(lambda: Scene.from_triangles(tri, builder=builder, config=config,
                                                        device="cuda"))
        trace_ms = wall_ms(lambda: engine.trace(primary))
        sum_qb = float(rec_k.quadbox_jobs.double().sum())
        sum_tri = float(rec_k.triangle_jobs.double().sum())
        arity = config.arity
        n_nodes = scene.bvh.node_lo.shape[0]
        n_kids = packed.kids.shape[0] * arity  # the nodes whose boxes a record holds
        bound = traverse_bound(packed, n_rays, sum_qb, sum_tri, arity)
        bound_analytic = traverse_bound(packed, n_rays, sum_qb, sum_tri, arity,
                                        node_bytes=n_kids * config.box_bytes_per_node)
        gathered = traverse_gathered(packed, n_rays, sum_qb, sum_tri, arity)[2]
        kids_bytes = packed.kids.numel() * packed.kids.element_size()
        slots_bytes = packed.slots.numel() * packed.slots.element_size()
        n_ovf = int(closest.stack_overflow.sum())
        say(f"phase 11 {label}: depth {scene.depth}, {n_nodes} nodes; child records "
            f"{kids_bytes / 1e6:.3f} MB ({packed.kids.dtype}, {n_kids} boxes; analytic "
            f"{n_kids * config.box_bytes_per_node / 1e6:.3f} MB at "
            f"{config.box_bytes_per_node} B a box), leaf slots {slots_bytes / 1e6:.3f} MB; "
            f"build {build_ms:.3f} ms, closest trace {trace_ms:.3f} ms (median of "
            f"{TIMED_REPS}), kernel {kern_ms:.3f} ms, plain {plain_ms:.3f} ms; box / "
            f"triangle jobs per ray {sum_qb / n_rays:.3f} / {sum_tri / n_rays:.3f}; rounds "
            f"{int(rec_k.rounds)}; overflowed rays {n_ovf} closest, "
            f"{int(anyhit.stack_overflow.sum())} any, {int(shadow.stack_overflow.sum())} "
            f"shadow; with the analytic box bytes the bound is {bound_analytic[0]:.4f} ms "
            f"({bound_analytic[1]}); launches {launches}; "
            + traverse_metrics(packed, n_rays, sum_qb, sum_tri, arity, kern_ms))
        row = kernel_row(f"traverse {label}", "traverse.cu",
                         "src/repro/kernels/traverse.py:95", {f"traverse {label}": launches},
                         kern_ms, plain_ms, err, bound)
        row["bound_analytic_ms"] = bound_analytic[0]
        row["gathered_ms"] = gathered / HBM_BYTES_PER_S * 1e3
        rows.append(row)
        out[(builder, tag)] = dict(scene=scene, closest=closest)

    # ---- closest hits equal the same builder's exact BVH4 twin -----------------
    base_tag = GOLDEN_CONFIGS[0]
    ties = {}
    for (builder, tag), o in out.items():
        base = out[(builder, base_tag)]["closest"]
        got = o["closest"]
        ok = ~got.stack_overflow & ~base.stack_overflow
        same_bits(f"phase 11 {builder}/{tag}: closest hit and t vs {builder}/{base_tag} "
                  f"where neither overflowed", (got.hit[ok], got.t[ok]),
                  (base.hit[ok], base.t[ok]))
        d = torch.nonzero(ok & (got.tri_index != base.tri_index)).squeeze(1)

        def t_of(tri_index):
            r = Ray(*(f[d] for f in primary))
            res = ray_triangle_test(r, Triangle(*(v[tri_index[d].long()] for v in tri)))
            return res.t_num / res.t_denom

        same_bits(f"phase 11 {builder}/{tag}: the {d.numel()} rays whose closest "
                  f"triangle differs from {base_tag}'s: both triangles' t",
                  (t_of(got.tri_index),), (t_of(base.tri_index),))
        ties[(builder, tag)] = (int(d.numel()), int((~ok).sum()))
    say("phase 11 closest vs the same builder's bvh4_s64_fp32_fp32 twin (hit and t "
        "bit-equal where neither overflowed; rays whose triangle differs, each a tie; "
        "rays left out for an overflow): "
        + ", ".join(f"{b}/{t} {n} / {o}" for (b, t), (n, o) in ties.items()))

    # ---- the codec twins' boxes hold the exact twin's ----------------------------
    # A widened box is hit wherever the exact one is (the slab test is
    # monotone in the bounds), so a ray that commits no hit, whose walk is
    # never pruned, visits a superset of the exact twin's nodes.  A ray that
    # hits may visit fewer: the widened boxes reorder its children (sorted by
    # tmin), the walk finds its hit in another order and prunes differently.
    supersets = []
    for (builder, tag), o in out.items():
        config = o["scene"].config
        if config.exact_boxes:
            continue
        exact = DatapathConfig(config.arity, config.stack_size)
        twin = out.get((builder, exact.tag))
        if twin is None:  # the same tree as the fp32 build, traced under its config
            src = out[(builder, DatapathConfig(config.arity).tag)]["scene"]
            twin_scene = Scene(src.bvh, src.depth, builder=builder, config=exact)
            ex = twin_scene.engine().trace(primary)
        else:
            ex = twin["closest"]
        got = o["closest"]
        ok = ~got.stack_overflow & ~ex.stack_overflow
        miss = ok & ~got.hit & ~ex.hit
        for f in ("quadbox_jobs", "triangle_jobs"):
            below = miss & (getattr(got, f) < getattr(ex, f))
            if bool(below.any()):
                fail(f"phase 11 {builder}/{tag}: {f} below the exact twin {exact.tag}'s "
                     f"on {int(below.sum())} rays that hit nothing")
        fewer = ok & ((got.quadbox_jobs < ex.quadbox_jobs)
                      | (got.triangle_jobs < ex.triangle_jobs))
        supersets.append(
            f"{builder}/{tag} vs {exact.tag}: >= on all {int(miss.sum())} missing rays; "
            f"over the {int(ok.sum())} rays neither overflowed, box jobs "
            f"{(got.quadbox_jobs[ok] - ex.quadbox_jobs[ok]).double().mean().item():+.4f}, "
            f"triangle jobs "
            f"{(got.triangle_jobs[ok] - ex.triangle_jobs[ok]).double().mean().item():+.4f} "
            f"a ray, {int(fewer.sum())} hit rays with fewer jobs")
    say("phase 11 codec twins vs the exact twin of the same builder, arity and stack "
        "(traced under its own config; closest): " + "; ".join(supersets))

    # ---- refit under the config re-encodes as the build does -----------------
    for (builder, tag), o in out.items():
        if o["scene"].config.exact_boxes and o["scene"].config.arity == 4:
            continue
        scene = o["scene"]
        built = scene.bvh
        scene.refit(tri)
        same_bits(f"phase 11 {builder}/{tag}: Scene.refit with the build's own triangles "
                  f"vs the build",
                  (scene.bvh.node_lo, scene.bvh.node_hi, scene.bvh.leaf_tri,
                   scene.bvh.leaf_perm), (built.node_lo, built.node_hi, built.leaf_tri,
                                          built.leaf_perm))
    # ---- signed zeros: the key reductions of the builds and refits on the card
    rng = np.random.default_rng(SIGNED_ZERO_SEED)
    v = rng.normal(0.0, 1.0, (3, SIGNED_ZERO_TRIS, 3)).astype(np.float32)
    zero = rng.random(v.shape) < SIGNED_ZERO_SHARE
    v[zero] = np.where(rng.random(int(zero.sum())) < 0.5, -0.0, 0.0)
    soups = {dev: Triangle(*(torch.as_tensor(x, device=dev) for x in v))
             for dev in ("cuda", "cpu")}
    n_neg = 0

    def tree_fields(b):
        return (b.node_lo, b.node_hi, b.leaf_tri, b.leaf_perm)

    for builder in ("lbvh", "sah"):
        for tag in GOLDEN_CONFIGS:
            config = config_from_tag(tag)
            on_card, on_cpu = (Scene.from_triangles(soups[dev], builder=builder,
                                                    config=config, device=dev)
                               for dev in ("cuda", "cpu"))
            same_bits(f"phase 11 signed-zero soup {builder}/{tag}: the build on the "
                      f"card vs on the CPU", tree_fields(on_card.bvh),
                      tuple(f.cuda() for f in tree_fields(on_cpu.bvh)))
            built = on_card.bvh
            on_card.refit(soups["cuda"])
            same_bits(f"phase 11 signed-zero soup {builder}/{tag}: refit vs the build",
                      tree_fields(on_card.bvh), tree_fields(built))
            lo = built.node_lo
            n_neg += int(((lo == 0) & torch.signbit(lo)).sum())
    if n_neg == 0:
        fail("phase 11 signed-zero soup: no node bound is -0.0")
    say(f"phase 11 signed-zero soup ({SIGNED_ZERO_TRIS} triangles, "
        f"{SIGNED_ZERO_SHARE:.0%} of coordinates +-0.0): both builders under every "
        f"golden config bit-equal on the card and the CPU, refit bit-equal to the "
        f"build; {n_neg} node lo bounds are -0.0")

    jobs = {k: (o["closest"].quadbox_jobs.double().mean().item()
                + o["closest"].triangle_jobs.double().mean().item()) for k, o in out.items()}
    say(f"phase 11 refit under bvh8 and bf16-compressed (both builders) bit-equal to the "
        f"build; SAH / LBVH jobs per camera ray (box + triangle) at {base_tag}: "
        f"{jobs[('sah', base_tag)]:.3f} / {jobs[('lbvh', base_tag)]:.3f} = "
        f"{jobs[('sah', base_tag)] / jobs[('lbvh', base_tag)]:.4f}")
    return rows


def serve_requests(rng, pools: dict) -> list:
    """The phase-12 trace: ``SERVE_REQUESTS`` (kind, payload) pairs drawn
    with ``rng`` by :data:`SERVE_MIX`, each payload a run of rows at a
    random offset of its kind's pool (camera rays, their shadow rays,
    sift-shape queries, the cloud's points), on the card."""
    kinds = rng.choice(len(SERVE_MIX), SERVE_REQUESTS, p=[m[1] for m in SERVE_MIX])
    out = []
    for k in kinds:
        name, _, lo, hi = SERVE_MIX[k]
        pool = pools[name]
        total = (pool[0] if isinstance(pool, tuple) else pool).shape[0]
        n = int(rng.integers(lo, hi + 1))
        a = int(rng.integers(0, total - n + 1))
        rows = slice(a, a + n)
        out.append((name, type(pool)(*(x[rows] for x in pool)) if isinstance(pool, tuple)
                    else pool[rows]))
    return out


def phase_serving(torch, sift_db, sift_q):
    """Phase 12: the mixed request trace served by ``QueryServer`` over one
    engine on the card, closed loop, then open loop (Poisson arrivals) at
    :data:`SERVE_OPEN_SHARES` of the closed loop's rate, then closed loop
    again with telemetry on."""
    import asyncio

    from repro_torch import obs
    from repro_torch.api import PointCloudScene, QueryEngine, Scene, VectorIndex, make_ray
    from repro_torch.core.build.quality import clustered_soup
    from repro_torch.kernels import nvcc
    from repro_torch.serving import QueryServer

    t_phase = time.perf_counter()
    rng = np.random.default_rng(SEED)
    tri = clustered_soup(np.random.default_rng(SEED), N_CLUSTERS, PER_CLUSTER, device="cuda")
    points = clustered_soup(np.random.default_rng(SEED + 3), TREE_CLUSTERS,
                            TREE_PER_CLUSTER, device="cuda").a
    scene = Scene.from_triangles(tri, device="cuda")
    engine = QueryEngine(scene=scene, index=VectorIndex.from_database(sift_db, device="cuda"),
                         cloud=PointCloudScene.from_points(points, device="cuda"),
                         chunk_size=CHUNK)
    primary = make_ray(*camera_rays(scene), device="cuda")
    hits = engine.trace(primary)
    idx = torch.nonzero(hits.hit).squeeze(1)
    p = primary.origin[idx] + hits.t[idx, None] * primary.direction[idx]
    to_light = torch.tensor([9.0, 11.0, -13.0], device="cuda") - p
    dist = torch.linalg.vector_norm(to_light, dim=1)
    shadow = make_ray(p, to_light / dist[:, None], dist, device="cuda")
    pools = {"closest": primary, "shadow": shadow,
             "brute nearest": torch.as_tensor(sift_q, device="cuda"), "tree nearest": points}
    reqs = serve_requests(rng, pools)
    kinds = np.asarray([kind for kind, _ in reqs])
    counts = {m[0]: int((kinds == m[0]).sum()) for m in SERVE_MIX}
    say(f"phase 12 engine over clustered-1M ({tri.a.shape[0]} triangles), sift-shape "
        f"({SIFT_N} x {SIFT_D}) and cloud-1M ({points.shape[0]} points), chunk_size "
        f"{CHUNK}; {len(reqs)} requests drawn with seed {SEED}: "
        + ", ".join(f"{n} {k}" for k, n in counts.items()))

    def call(target, kind, payload):
        """``kind``'s query on ``target``: the server (a coroutine) or the
        engine (a direct call)."""
        method, args, kw = SERVE_CALLS[kind]
        return getattr(target, method)(payload, *args, **kw)

    # ---- every engine key the server's row ladder can ask for, seen once ----
    for kind, *_ in SERVE_MIX:
        pool = pools[kind]
        total = (pool[0] if isinstance(pool, tuple) else pool).shape[0]
        rows = 1
        while rows <= 2 * SERVE_MAX_BATCH_ROWS:
            take = torch.arange(rows, device="cuda") % total
            call(engine, kind, type(pool)(*(x[take] for x in pool))
                 if isinstance(pool, tuple) else pool[take])
            rows *= 2
    t0 = time.perf_counter()
    want = [call(engine, kind, payload) for kind, payload in reqs]
    torch.cuda.synchronize()
    say(f"phase 12 direct engine calls, one a request: {time.perf_counter() - t0:.3f} s")

    async def run(arrivals):
        """Serve every request, submitted at ``arrivals`` seconds after the
        start (None: all at once); each latency from its arrival to its
        response."""
        lat = np.zeros(len(reqs))
        async with QueryServer(engine, max_batch_rows=SERVE_MAX_BATCH_ROWS,
                               max_wait=SERVE_MAX_WAIT) as server:
            start = time.perf_counter()

            async def one(i, kind, payload, at):
                res = await call(server, kind, payload)
                lat[i] = time.perf_counter() - (start + at)
                return res

            tasks = []
            for i, (kind, payload) in enumerate(reqs):
                at = 0.0 if arrivals is None else float(arrivals[i])
                delay = start + at - time.perf_counter()
                if delay > 0:
                    await asyncio.sleep(delay)
                tasks.append(asyncio.ensure_future(one(i, kind, payload, at)))
            got = await asyncio.gather(*tasks)
            makespan = time.perf_counter() - start
            return got, lat, makespan, server.stats()

    def check(label, got):
        for i, ((kind, _), g, w) in enumerate(zip(reqs, got, want)):
            for a, b in zip(g, w):
                if a.dtype == torch.float32:
                    a, b = bits(a), bits(b)
                if a.shape != b.shape or not torch.equal(a, b):
                    fail(f"phase 12 {label}: request {i} ({kind}) differs from a "
                         "direct engine call on its rows")

    def report(label, lat, makespan, stats, offered=None):
        n_batches = sum(s.batches for s in stats.values())
        flushes = {r: sum(getattr(s, f"flush_{r}") for s in stats.values())
                   for r in ("full", "timer", "deadline", "drain")}
        rows = sum(s.mean_batch_rows * s.batches for s in stats.values())
        padded = sum(s.mean_batch_rows * s.batches / s.mean_fill
                     for s in stats.values() if s.mean_fill)
        say(f"phase 12 {label}: " + ("" if offered is None else
                                     f"offered {offered:.3f} requests/s, ")
            + f"{len(reqs) / makespan:.3f} requests/s over {makespan:.3f} s; latency "
            f"p50 {np.percentile(lat, 50) * 1e3:.3f} ms, p99 "
            f"{np.percentile(lat, 99) * 1e3:.3f} ms; {n_batches} batches, "
            f"{len(reqs) / n_batches:.3f} requests a batch, mean fill "
            f"{rows / padded:.4f}; flushes " + ", ".join(f"{r} {n}" for r, n in flushes.items()))
        for method, st in sorted(stats.items()):
            say(f"  {method}: {st.requests} requests in {st.batches} batches, "
                f"{st.requests_per_batch:.3f} requests and {st.mean_batch_rows:.1f} rows a "
                f"batch, mean fill {st.mean_fill:.4f}")
        for kind, *_ in SERVE_MIX:
            mine = lat[kinds == kind] * 1e3
            say(f"  {kind}: latency p50 {np.percentile(mine, 50):.3f} ms, p99 "
                f"{np.percentile(mine, 99):.3f} ms")

    # ---- closed loop: the counted drive of the path -------------------------
    torch.cuda.synchronize()
    nvcc.reset_launches()
    got, lat, makespan, stats = asyncio.run(run(None))
    launches = nvcc.launch_counts()
    for name in ("traverse", "distance", "neighbor"):
        if launches.get(name, 0) < 1:
            fail(f"phase 12: the served run launched no {name} kernel ({launches})")
    check("closed loop", got)
    del got
    rate = len(reqs) / makespan
    report("closed loop, every request submitted at once", lat, makespan, stats)
    say("phase 12 kernel launches in the closed-loop run: "
        + ", ".join(f"{k} {v}" for k, v in sorted(launches.items())))

    # ---- open loop: Poisson arrivals at shares of the closed loop's rate ----
    for share in SERVE_OPEN_SHARES:
        offered = share * rate
        arrivals = np.cumsum(rng.exponential(1.0 / offered, len(reqs)))
        with obs.CompileTracker() as tracker:
            got, lat, makespan, stats = asyncio.run(run(arrivals))
        if tracker.compiles != 0:
            fail(f"phase 12: the warm open-loop run at {share:.0%} compiled "
                 f"{tracker.compiles} times")
        check(f"open loop at {share:.0%}", got)
        del got
        report(f"open loop at {share:.0%} of it (Poisson), {tracker.compiles} compiles",
               lat, makespan, stats, offered)

    # ---- telemetry on: the same bits, span chains, a Chrome trace ------------
    obs.default_buffer().clear()
    obs.enable()
    try:
        got, lat, makespan, stats = asyncio.run(run(None))
        snap = obs.snapshot()
        trace_path = ROOT / "build" / "phase12_trace.json"
        trace_path.parent.mkdir(parents=True, exist_ok=True)
        n_events = obs.export_chrome_trace(str(trace_path))
    finally:
        obs.disable()
    check("closed loop, telemetry on", got)
    del got
    chains = {s.tid for s in obs.default_buffer().spans() if s.cat == "serving"}
    obs.default_buffer().clear()
    report("closed loop, telemetry on (every response bit-equal to telemetry off)",
           lat, makespan, stats)
    say(f"phase 12 Chrome trace: {n_events} events in {trace_path.relative_to(ROOT)}, "
        f"{len(chains)} request span chains; snapshot derived "
        f"{json.dumps(snap['derived'])}, jit compiles {snap['jit']['compiles']}")
    say(f"phase 12 seconds: {time.perf_counter() - t_phase:.1f}")


# ---------------------------------------------------------------------------
# phase 13: the LM serving path, Phi-3.5-MoE at full width
# ---------------------------------------------------------------------------


def lm_generate_timed(torch, cfg, params, prompts):
    """The engine's loop written out, each step timed on the host clock
    ending in a synchronize: prefill ms (median of ``TIMED_REPS``), decode
    ms a step (all ``LM_NEW`` steps) and the greedy tokens."""
    from repro_torch.models import decode_step, init_cache, prefill
    from repro_torch.parallel import NO_PARALLEL
    cache = init_cache(cfg, prompts.shape[0], LM_MAX_LEN, device="cuda")
    pre = []
    for _ in range(TIMED_REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, filled = prefill(cfg, NO_PARALLEL, params, {"tokens": prompts}, cache)
        torch.cuda.synchronize()
        pre.append((time.perf_counter() - t0) * 1e3)
    cache = filled
    steps, out = [], []
    tok = logits[:, -1].argmax(-1)[:, None].to(torch.int32)
    for _ in range(LM_NEW):
        out.append(tok)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = decode_step(cfg, NO_PARALLEL, params, cache, tok)
        tok = logits[:, -1].argmax(-1)[:, None].to(torch.int32)
        torch.cuda.synchronize()
        steps.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(pre), steps, torch.cat(out, -1)


def lm_profile(torch, cfg, params, prompts, steps: int = 3, phase: str = "phase 13") -> dict:
    """Where a prefill and a decode step spend the device's time: one
    prefill and ``steps`` decode steps under ``torch.profiler``, each window
    ending in a synchronize.  Prints the device-busy share of each window's
    host time (kernels of one stream do not overlap) and its largest
    kernels by device time.  Returns the device-busy ms of a prefill and of
    a decode step (None where the profiler saw no device time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import decode_step, init_cache, prefill
    from repro_torch.parallel import NO_PARALLEL
    cache = init_cache(cfg, prompts.shape[0], LM_MAX_LEN, device="cuda")
    logits, cache = prefill(cfg, NO_PARALLEL, params, {"tokens": prompts}, cache)
    tok = logits[:, -1].argmax(-1)[:, None].to(torch.int32)
    logits, warm = decode_step(cfg, NO_PARALLEL, params, cache, tok)
    torch.cuda.synchronize()

    def run_prefill():
        prefill(cfg, NO_PARALLEL, params, {"tokens": prompts}, cache)

    def run_decode():
        c = warm
        for _ in range(steps):
            _, c = decode_step(cfg, NO_PARALLEL, params, c, tok)

    busy_ms = {}
    for label, fn, calls in (("prefill", run_prefill, 1), ("decode step", run_decode, steps)):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            host_ms = (time.perf_counter() - t0) * 1e3
        # device-side events only: an operator's own entry carries its
        # kernels' time too
        rows = sorted(((e.self_device_time_total / 1e3, e.count, e.key)
                       for e in prof.key_averages()
                       if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0),
                      reverse=True)
        busy = sum(r[0] for r in rows)
        busy_ms[label] = busy / calls if busy else None
        if busy == 0:
            say(f"{phase} profile, {label}: the profiler saw no device time (not measured)")
            continue
        top = "; ".join(f"{ms / calls:.3f} ms x{n // calls} {name[:70]}"
                        for ms, n, name in rows[:6])
        say(f"{phase} profile, {label}: {host_ms / calls:.3f} ms on the host clock "
            f"(profiled), device busy {busy / calls:.3f} ms ({busy / host_ms:.1%}; "
            f"idle {1 - busy / host_ms:.1%}); per call: {top}")
    return busy_ms


def forced_weights(torch, m, scores, idx):
    """The gate weights of experts ``idx`` (N, k) from router ``scores``,
    as the config's gating weighs its own top-k: softmax probabilities, or
    (DeepSeek-V3) sigmoids normalised over the k and scaled."""
    if m.router == "sigmoid":
        w = torch.sigmoid(scores).gather(1, idx)
        return w / torch.clamp_min(w.sum(-1, keepdim=True), 1e-20) * m.route_scale
    return torch.softmax(scores, dim=-1).gather(1, idx)


@contextlib.contextmanager
def routed(torch, calls: list, forcing: list | None = None):
    """Every MoE layer's routing through ``router_topk`` while inside:
    each call's own top-k experts appended to ``calls``; while ``forcing``
    holds entries, a call takes the next one's experts instead, weighted
    by :func:`forced_weights`."""
    from repro_torch.models import moe as moe_mod
    router_topk = moe_mod.router_topk

    def spy(m, scores):
        w, idx, aux = router_topk(m, scores)
        calls.append(idx)
        if forcing:
            idx = forcing.pop(0)
            w = forced_weights(torch, m, scores, idx)
        return w, idx, aux

    moe_mod.router_topk = spy
    try:
        yield
    finally:
        moe_mod.router_topk = router_topk


def routed_apart(torch, a: list, b: list, rows: int):
    """Which of ``rows`` batch rows two runs' routings (lists of (N, k)
    expert tensors, token-major) put on another expert set somewhere."""
    out = torch.zeros(rows, dtype=torch.bool, device="cuda")
    for x, y in zip(a, b, strict=True):
        out |= (x.sort(-1).values != y.sort(-1).values).reshape(rows, -1).any(-1)
    return out


def lm_decode_vs_prefill(torch, cfg, params, prompts):
    """Greedy decode of ``LM_NEW`` tokens through the cache, then one
    prefill over prompt + fed tokens, twice: as it routes itself (the
    control), and with every MoE layer's top-k experts forced to those the
    decode path chose for each token (each choice weighted by the whole
    prefill's own scores, :func:`forced_weights`).  Returns each row's max
    |logit difference| at the last step for the free and the forced
    prefill, the largest |logit|, and which rows the free prefill routed
    differently anywhere (every layer's top-k expert set at every
    position)."""
    from repro_torch.models import decode_step, init_cache, prefill
    from repro_torch.parallel import NO_PARALLEL
    b, p = prompts.shape
    k = cfg.moe.top_k
    calls, forcing = [], []

    def whole_prefill():
        return prefill(cfg, NO_PARALLEL, params, {"tokens": seq},
                       init_cache(cfg, b, LM_MAX_LEN, device="cuda"))[0]

    with routed(torch, calls, forcing):
        logits, cache = prefill(cfg, NO_PARALLEL, params, {"tokens": prompts},
                                init_cache(cfg, b, LM_MAX_LEN, device="cuda"))
        fed = []
        for _ in range(LM_NEW):
            fed.append(logits[:, -1].argmax(-1)[:, None].to(torch.int32))
            logits, cache = decode_step(cfg, NO_PARALLEL, params, cache, fed[-1])
        del cache
        n_moe = len(calls) // (1 + LM_NEW)
        # each layer's experts of the decode path, token-major as the
        # whole prefill flattens its (batch, position) rows
        stepped = [torch.cat([calls[layer].reshape(b, p, k)]
                             + [calls[(1 + i) * n_moe + layer].reshape(b, 1, k)
                                for i in range(LM_NEW)], dim=1).reshape(-1, k)
                   for layer in range(n_moe)]
        seq = torch.cat([prompts] + fed, dim=1)
        free = whole_prefill()
        whole = calls[(1 + LM_NEW) * n_moe:]
        forcing.extend(stepped)
        forced = whole_prefill()
        if forcing:
            fail(f"{len(forcing)} forced routings left unread")
    flipped = routed_apart(torch, stepped, whole, b)

    def err(full):
        return (logits.float() - full.float()).abs().amax((1, 2))
    return err(free), err(forced), float(forced.float().abs().max()), flipped


def lm_teacher_forced(torch, cfg, params, prompts, tokens):
    """Logits of the prefill and of every decode step fed ``tokens``."""
    from repro_torch.models import decode_step, init_cache, prefill
    from repro_torch.parallel import NO_PARALLEL
    logits, cache = prefill(cfg, NO_PARALLEL, params, {"tokens": prompts},
                            init_cache(cfg, prompts.shape[0], LM_MAX_LEN,
                                       device=prompts.device))
    out = [logits.float().cpu()]
    for i in range(tokens.shape[1]):
        logits, cache = decode_step(cfg, NO_PARALLEL, params, cache, tokens[:, i:i + 1])
        out.append(logits.float().cpu())
    return torch.cat(out, dim=1)


def phase_lm(torch, card: str) -> list:
    """Phase 13: ``init_params`` -> ``Engine.generate`` for Phi-3.5-MoE at
    full width (8 of 32 layers) on the card, the norm kernel on every MoE
    layer's router table, and the smoke configs against the CPU path."""
    import gc
    from repro_torch.configs import get_config, get_smoke
    from repro_torch.kernels import nvcc
    from repro_torch.kernels.distance import norm_variant, norms_cuda, norms_plain
    from repro_torch.models import count_params, init_params
    from repro_torch.models.attention import gqa_apply
    from repro_torch.models.layers import exact_products, norm_apply
    from repro_torch.models.model import _embed_inputs
    from repro_torch.models.moe import _capacity, moe_dispatch, router_scores, router_topk
    from repro_torch.parallel import NO_PARALLEL
    from repro_torch.serving import Engine

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    cfg = dataclasses.replace(get_config(LM_ARCH), num_layers=LM_LAYERS)
    n_moe = sum(spec.moe for spec in cfg.layer_specs())
    t0 = time.perf_counter()
    params = init_params(torch.Generator(device="cuda").manual_seed(SEED), cfg,
                         device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in params.parameters())
    if n_params != count_params(cfg):
        fail(f"phase 13: {n_params} parameters, count_params says {count_params(cfg)}")
    prompts = torch.as_tensor(np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (LM_BATCH, LM_PROMPT)), dtype=torch.int32, device="cuda")
    eng = Engine(cfg, params, max_len=LM_MAX_LEN)
    eng.generate(prompts[:1, :8], 1)  # warm-up: cuBLAS handles, the allocator

    # ---- (a) the main path, its launches counted --------------------------
    nvcc.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    greedy = eng.generate(prompts, LM_NEW)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    launches = nvcc.launch_counts()
    want = n_moe * (1 + LM_NEW)
    if launches != {"norm": want}:
        fail(f"phase 13: Engine.generate launched {launches}; the norm kernel "
             f"should run {want} times ({n_moe} MoE layers x {1 + LM_NEW} forwards) "
             "and nothing else")
    if greedy.shape != (LM_BATCH, LM_NEW) or greedy.dtype != torch.int32 or not bool(
            ((greedy >= 0) & (greedy < cfg.vocab_size)).all()):
        fail(f"phase 13: greedy tokens {tuple(greedy.shape)} {greedy.dtype} out of range")
    prefill_ms, steps, timed = lm_generate_timed(torch, cfg, params, prompts)
    if not torch.equal(timed, greedy):
        fail("phase 13: the timed loop's greedy tokens differ from Engine.generate's")
    step_ms = statistics.median(steps)
    peak = torch.cuda.max_memory_allocated()
    lm_profile(torch, cfg, params, prompts)
    say(f"phase 13 {cfg.name} at full width, {LM_LAYERS} of 32 layers: "
        f"{n_params:,} parameters ({n_params * 4 / 1e9:.2f} GB f32), init "
        f"{init_s:.2f} s; {held / 1e9:.2f} GB held before the phase")
    say(f"phase 13 Engine.generate batch {LM_BATCH} x prompt {LM_PROMPT} + "
        f"{LM_NEW} new: {gen_s:.3f} s; prefill {prefill_ms:.3f} ms (median of "
        f"{TIMED_REPS}), decode {step_ms:.3f} ms a step (median of {LM_NEW}; min "
        f"{min(steps):.3f}, max {max(steps):.3f}), {LM_BATCH / step_ms * 1e3:.1f} "
        f"tokens/s; peak memory {peak / 1e9:.2f} GB; norm kernel launches "
        f"{launches['norm']} ({n_moe} MoE layers x {1 + LM_NEW} forwards); {card}")

    # ---- (b) gates --------------------------------------------------------
    norm_err = norm_rel = 0.0
    for layer in params["layers"]:
        w = layer["ffn"]["router"].detach()
        got, ref = norms_cuda(w), norms_plain(w)
        norm_err = max(norm_err, score_error(got, ref, ref))
        norm_rel = max(norm_rel, scaled_error(got, ref, ref))
    with torch.no_grad(), exact_products():
        h, _, pos = _embed_inputs(cfg, NO_PARALLEL, params, {"tokens": prompts})
        blk = params["layers"][0]
        y, _ = gqa_apply(cfg, NO_PARALLEL, blk["mixer"],
                         norm_apply(cfg, blk["norm1"], h), pos)
        x2 = norm_apply(cfg, blk["norm2"], h + y).reshape(-1, cfg.d_model)
        router_w = blk["ffn"]["router"].detach()
        cos_m = dataclasses.replace(cfg.moe, router_metric="cosine")
        cos = router_scores(cos_m, x2, router_w)
        cos_err = float((cos.cpu() - router_scores(cos_m, x2.cpu(), router_w.cpu())).abs().max())
        scores = router_scores(cfg.moe, x2, router_w)
        w_g, idx_g, _ = router_topk(cfg.moe, scores)
        s_c = router_scores(cfg.moe, x2.cpu(), router_w.cpu())
        w_c, idx_c, _ = router_topk(cfg.moe, s_c)
    if cos_err > SCORE_RTOL:
        fail(f"phase 13: cosine router scores differ from the CPU path by {cos_err:.3g}")
    # routing on the card against the CPU path: equal, but where the CPU's
    # k-th and (k+1)-th scores are within the scores' tolerance
    n_tok, k = x2.shape[0], cfg.moe.top_k
    top = s_c.topk(k + 1, dim=-1).values
    qc = x2.cpu().float().norm(dim=1) * router_w.cpu().norm(dim=1).max()
    close_rows = (top[:, k - 1] - top[:, k]) <= 2 * SCORE_RTOL * qc
    differ = (idx_g.cpu() != idx_c).any(1)
    if bool((differ & ~close_rows).any()):
        fail(f"phase 13: routing differs from the CPU path on "
             f"{int((differ & ~close_rows).sum())} tokens with clear margins")
    cap = _capacity(cfg.moe, n_tok)
    table, gather_w, src = moe_dispatch(n_tok, w_g, idx_g, cfg.moe.num_experts, 0, cap)
    c_table, c_gather_w, c_src = moe_dispatch(n_tok, w_g.cpu(), idx_g.cpu(),
                                              cfg.moe.num_experts, 0, cap)
    if not (torch.equal(table.cpu(), c_table) and torch.equal(src.cpu(), c_src)
            and torch.equal(gather_w.cpu(), c_gather_w)):
        fail("phase 13: moe_dispatch's table or drops differ on the card and the CPU")
    drops = int((c_src == cfg.moe.num_experts * cap).sum())
    say(f"phase 13 gates: router norms of all {n_moe} layers within "
        f"{norm_rel:.3g} |c|^2 of norms_plain (gate {SCORE_RTOL:g}); layer 0's "
        f"cosine router on {n_tok} real activations within {cos_err:.3g} of the CPU "
        f"path (gate {SCORE_RTOL:g}); top-{k} routing equal on "
        f"{n_tok - int(differ.sum())} of {n_tok} tokens ({int(close_rows.sum())} "
        f"within the scores' tolerance of a tie); dispatch (capacity {cap}) equal "
        f"on the card and the CPU, {drops} of {n_tok * k} choices dropped")
    del x2, h, y, scores, cos

    # decode through the cache against one prefill of the whole sequence,
    # every row compared with the prefill's routing forced to the decode
    # path's; float32 must also route every row alike by itself
    for dtype in ("float32", "bfloat16"):
        nodrop = dataclasses.replace(
            cfg, compute_dtype=dtype,
            moe=dataclasses.replace(cfg.moe, capacity_factor=LM_NODROP_CF))
        free, forced, scale, flipped = lm_decode_vs_prefill(torch, nodrop, params, prompts)
        tol = LM_DECODE_TOL[dtype]
        worst = float(forced.max())
        control = float(free[flipped].max()) if bool(flipped.any()) else float("nan")
        say(f"phase 13 decode vs one prefill of {LM_PROMPT + LM_NEW} tokens "
            f"({dtype}, capacity_factor {LM_NODROP_CF:g}: no drops), last-step "
            f"logits at |logits| up to {scale:.3f}: routing forced to the decode "
            f"path's, max |err| per row {[round(float(e), 6) for e in forced]}, "
            f"worst {worst:.6g} (gate {tol:g}, all {LM_BATCH} rows); the prefill "
            f"routing by itself, {int(flipped.sum())} of {LM_BATCH} rows routed "
            f"differently somewhere, max |err| per row "
            f"{[round(float(e), 6) for e in free]} (control: worst routed "
            f"differently {control:.6g})")
        if dtype == "float32" and bool(flipped.any()):
            fail(f"phase 13: float32 decode and prefill routed {int(flipped.sum())} "
                 f"of {LM_BATCH} rows differently")
        if not worst <= tol:
            fail(f"phase 13: {dtype} decode logits {worst:.6g} from the full "
                 f"prefill's with the same routing (gate {tol:g})")

    # batch_chunk: each chunk equals its rows generated alone
    chunked = Engine(cfg, params, max_len=LM_MAX_LEN, batch_chunk=LM_CHUNK).generate(
        prompts[:LM_CHUNK_ROWS], LM_NEW)
    tail = list(range(LM_CHUNK, LM_CHUNK_ROWS))
    for lo, rows in ((0, list(range(LM_CHUNK))),
                     (LM_CHUNK, tail + [tail[0]] * (LM_CHUNK - len(tail)))):
        n = min(LM_CHUNK, LM_CHUNK_ROWS - lo)
        if not torch.equal(chunked[lo:lo + n], eng.generate(prompts[rows], LM_NEW)[:n]):
            fail(f"phase 13: batch_chunk's chunk at row {lo} differs from its rows "
                 "generated alone")
    sampled = [eng.generate(prompts, LM_NEW, temperature=LM_TEMPERATURE, rng=SEED)
               for _ in range(2)]
    if not torch.equal(sampled[0], sampled[1]):
        fail("phase 13: two sampled runs from one seed differ")
    if not bool(((sampled[0] >= 0) & (sampled[0] < cfg.vocab_size)).all()):
        fail("phase 13: a sampled token outside the vocabulary")
    say(f"phase 13 batch_chunk {LM_CHUNK} over {LM_CHUNK_ROWS} prompts: each chunk "
        f"bit-equal to its rows alone; sampled (temperature {LM_TEMPERATURE:g}, "
        f"seed {SEED}) twice: bit-equal, {int((sampled[0] != greedy).sum())} of "
        f"{greedy.numel()} tokens unlike the greedy run's")

    # the norm kernel at the router's shape, for the kernels line
    w = params["layers"][0]["ffn"]["router"].detach()
    e, d = w.shape
    n_k = norms_cuda(w)
    plain_ms, _ = event_ms(lambda: norms_plain(w))
    sets = [(a, torch.empty((1, e), dtype=torch.float32, device="cuda"))
            for a in cold_copies(w)]
    alone_ms = device_ms("rayflex_norm", [norm_args(a, o, norm_variant(e, d)) for a, o in sets])
    if not torch.equal(bits(sets[0][1]), bits(n_k)):
        fail("phase 13: the norm kernel, timed alone, differs from its wrapper")
    # the wrapper's device time, window and host time at every MoE config's
    # router table beside the library calls': Phi-3.5-MoE's own, the others
    # seeded as init_params draws them (N(0, 1 / d))
    gen = torch.Generator(device="cuda").manual_seed(SEED + 13)
    router = {}
    for arch, rows, width in NORM_ROUTER_TABLES:
        table = w if (rows, width) == (e, d) else torch.randn(
            (rows, width), generator=gen, device="cuda") / width ** 0.5
        router[arch] = norm_checked(torch, f"phase 13 norm at the {arch} router table", table)
    r = router["phi3.5-moe"]
    wrap_ms, lib_ms = r["norms_cuda"]["window_ms"], r["vector_norm"]["window_ms"]
    bound = bound_ms(4.0 * (e * d + e), 2.0 * e * d)
    say(f"phase 13 norm kernel {e} x {d} (the router table): {alone_ms:.4f} ms alone "
        f"({DEVICE_REPS} launches over {len(sets)} copies), window {wrap_ms:.4f} "
        f"({'not ' if wrap_ms > lib_ms else ''}within torch.linalg.vector_norm's "
        f"{lib_ms:.4f}), plain {plain_ms:.4f}, bound {bound[0]:.6f} {bound[1]}; "
        f"max |err| {norm_err:.3g}")
    del sets, eng, params, w, table
    gc.collect()
    torch.cuda.empty_cache()

    # ---- (c) smoke configs in float32: the card against the CPU path -----
    for arch in LM_SMOKE_ARCHS:
        scfg = dataclasses.replace(get_smoke(arch), compute_dtype="float32")
        cpu_params = init_params(SEED, scfg, device="cpu")
        gpu_params = copy.deepcopy(cpu_params).to("cuda")
        toks = np.random.default_rng(SEED).integers(0, scfg.vocab_size, (4, 16))
        t_cpu = torch.as_tensor(toks, dtype=torch.int32)
        want = Engine(scfg, cpu_params, max_len=LM_MAX_LEN).generate(t_cpu, 16)
        got = Engine(scfg, gpu_params, max_len=LM_MAX_LEN).generate(t_cpu.cuda(), 16)
        if not torch.equal(got.cpu(), want):
            fail(f"phase 13 {arch} smoke: greedy tokens on the card differ from the CPU's")
        l_cpu = lm_teacher_forced(torch, scfg, cpu_params, t_cpu, want)
        l_gpu = lm_teacher_forced(torch, scfg, gpu_params, t_cpu.cuda(), want.cuda())
        s_err = float((l_gpu - l_cpu).abs().max())
        if s_err > LM_SMOKE_TOL:
            fail(f"phase 13 {arch} smoke: logits on the card {s_err:.3g} from the "
                 f"CPU's (gate {LM_SMOKE_TOL:g})")
        say(f"phase 13 {arch} smoke (float32): 4 x 16 + 16 greedy tokens equal on the "
            f"card and the CPU, logits of all 17 steps within {s_err:.3g} (gate "
            f"{LM_SMOKE_TOL:g})")
    say(f"phase 13 seconds: {time.perf_counter() - t_phase:.1f}")
    # the kernel's time: its device time from the profiler (alone, the
    # loop of ctypes calls outruns a 2 us kernel), else alone
    dev = r["norms_cuda"]["device_us"]
    row = kernel_row("norm (router)", "distance.cu", "src/repro/kernels/distance.py:65",
                     {"norm (router)": launches["norm"]},
                     alone_ms if dev is None else dev / 1e3, plain_ms, norm_err, bound,
                     lib_ms, wrapper_ms=wrap_ms)
    row["alone_ms"] = alone_ms
    row["host_us"] = r["norms_cuda"]["host_us"]
    return [row]


# ---------------------------------------------------------------------------
# phase 14: DeepSeek-V3 serving (MLA, sigmoid top-8 routing) at full width
# ---------------------------------------------------------------------------


def ds_combine_gate(torch, cfg, params, prompts) -> str:
    """The MoE layer's ``moe_local`` on the card at the inputs a prefill of
    ``prompts`` gives it (caught by a spy): two runs bit-equal, and its
    combine (``moe_combine``) bit-equal to a plain loop over each token's
    gated expert outputs in ascending (expert, slot) order, onto 0.
    Returns the printed summary."""
    from repro_torch.models import init_cache, prefill
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.layers import exact_products
    from repro_torch.parallel import NO_PARALLEL
    caught = []
    moe_local = moe_mod.moe_local

    def spy(*args):
        caught.append(args)
        return moe_local(*args)

    moe_mod.moe_local = spy
    try:
        prefill(cfg, NO_PARALLEL, params, {"tokens": prompts},
                init_cache(cfg, prompts.shape[0], LM_MAX_LEN, device="cuda"))
    finally:
        moe_mod.moe_local = moe_local
    if len(caught) != 1:
        fail(f"phase 14: the prefill called moe_local {len(caught)} times, not once")
    args = caught[0]
    _, x, weights, experts, wi, wg, wo, offset, cap = args
    n, d = x.shape
    k = experts.shape[1]
    with torch.no_grad(), exact_products():
        runs = [moe_local(*args) for _ in range(2)]
        table, gather_w, src = moe_mod.moe_dispatch(n, weights, experts, wi.shape[0],
                                                    offset, cap)
        ys = moe_mod._expert_ffn(cfg, wi, wg, wo, torch.cat([x, x.new_zeros((1, d))])[table])
        flat = torch.cat([ys.reshape(-1, d), ys.new_zeros((1, d))])
        del ys
        flat[:-1] *= gather_w.reshape(-1, 1).to(flat.dtype)
        got = moe_mod.moe_combine(flat, src, n, k)
        dropped = flat.shape[0] - 1
        plain = torch.empty_like(got)
        for t, slots in enumerate(src.view(n, k).tolist()):
            row = flat.new_zeros(d)
            for slot in sorted(slots):
                if slot < dropped:
                    row = row + flat[slot]
            plain[t] = row
    for label, a, b in (("two runs of moe_local", runs[0], runs[1]),
                        ("moe_combine against moe_local", got, runs[0]),
                        ("moe_combine against the plain loop", got, plain)):
        if not torch.equal(a.view(torch.int16), b.view(torch.int16)):
            fail(f"phase 14 combine: {label} differ in "
                 f"{int((a.view(torch.int16) != b.view(torch.int16)).any(1).sum())} of {n} rows")
    n_drop = int((src == dropped).sum())
    return (f"moe_local on {n} tokens x top-{k} ({x.dtype}, capacity {cap}, {n_drop} "
            f"choices dropped): two runs bit-equal; its combine bit-equal to a plain "
            f"per-token loop in (expert, slot) order over the same expert outputs")


def ds_absorbed_vs_naive(torch, cfg, params, prompts, tokens):
    """Teacher-forced logits of the prefill and every decode step fed
    ``tokens``, on the naive decode path and on the absorbed one twice:
    routing by itself (the control) and with its routing forced to the
    naive run's.  Returns the forced and the free run's max |logit
    difference| from the naive run, the largest |logit| and the rows the
    absorbed path routed differently by itself."""
    def run(absorb, calls, forcing=None):
        acfg = dataclasses.replace(cfg, mla=dataclasses.replace(cfg.mla, absorb=absorb))
        with routed(torch, calls, forcing):
            return lm_teacher_forced(torch, acfg, params, prompts, tokens)
    naive_calls, own = [], []
    naive = run(False, naive_calls)
    free = run(True, own)
    forced = run(True, [], list(naive_calls))
    flipped = routed_apart(torch, naive_calls, own, prompts.shape[0])
    return (float((forced - naive).abs().max()), float((free - naive).abs().max()),
            float(naive.abs().max()), flipped)


def phase_deepseek(torch, card: str) -> list:
    """Phase 14: ``init_params`` -> ``Engine.generate`` for DeepSeek-V3 at
    full width (4 of 61 layers, the MTP head's parameters) on the card
    under both MLA decode paths, the norm kernel on the MoE layer's
    256 x 7168 router table."""
    import gc
    from repro_torch.configs import get_config
    from repro_torch.kernels import nvcc
    from repro_torch.kernels.distance import (NORM_SHORT_WIDE, norm_variant, norms_cuda,
                                              norms_plain)
    from repro_torch.models import count_params, init_params
    from repro_torch.serving import Engine

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    say(f"phase 14: {torch.cuda.memory_allocated() / 1e9:.2f} GB allocated after phase "
        "13's weights were released")
    torch.cuda.reset_peak_memory_stats()
    cfg = dataclasses.replace(get_config(DS_ARCH), num_layers=DS_LAYERS)
    n_moe = sum(spec.moe for spec in cfg.layer_specs())
    t0 = time.perf_counter()
    params = init_params(torch.Generator(device="cuda").manual_seed(SEED), cfg,
                         device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in params.parameters())
    if not n_params == count_params(cfg) == DS_PARAMS:
        fail(f"phase 14: {n_params} parameters, count_params says {count_params(cfg)}, "
             f"the cut's count {DS_PARAMS}")
    say(f"phase 14 {cfg.name} at full width, {DS_LAYERS} of 61 layers ({n_moe} MoE) with "
        f"the MTP head: {n_params:,} parameters ({n_params * 4 / 1e9:.2f} GB f32), init "
        f"{init_s:.2f} s")
    prompts = torch.as_tensor(np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (LM_BATCH, LM_PROMPT)), dtype=torch.int32, device="cuda")

    # ---- (a) the main path under both decode paths, launches counted ------
    runs = {}
    for absorb in (False, True):
        acfg = dataclasses.replace(cfg, mla=dataclasses.replace(cfg.mla, absorb=absorb))
        eng = Engine(acfg, params, max_len=LM_MAX_LEN)
        eng.generate(prompts[:1, :8], 1)  # warm-up
        nvcc.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        greedy = eng.generate(prompts, LM_NEW)
        torch.cuda.synchronize()
        gen_s = time.perf_counter() - t0
        launches = nvcc.launch_counts()
        want = n_moe * (1 + LM_NEW)
        if launches != {"norm": want}:
            fail(f"phase 14 (absorb={absorb}): Engine.generate launched {launches}; the "
                 f"norm kernel should run {want} times ({n_moe} MoE layers x "
                 f"{1 + LM_NEW} forwards) and nothing else")
        if greedy.shape != (LM_BATCH, LM_NEW) or greedy.dtype != torch.int32 or not bool(
                ((greedy >= 0) & (greedy < cfg.vocab_size)).all()):
            fail(f"phase 14: greedy tokens {tuple(greedy.shape)} {greedy.dtype} out of range")
        prefill_ms, steps, timed = lm_generate_timed(torch, acfg, params, prompts)
        if not torch.equal(timed, greedy):
            fail("phase 14: the timed loop's greedy tokens differ from Engine.generate's")
        runs[absorb] = {"cfg": acfg, "greedy": greedy, "gen_s": gen_s,
                        "prefill_ms": prefill_ms, "steps": steps, "norm": launches["norm"]}
    peak = torch.cuda.max_memory_allocated()
    for absorb, r in runs.items():
        lm_profile(torch, r["cfg"], params, prompts, phase=f"phase 14 absorb={absorb}")
    for absorb, r in runs.items():
        step_ms = statistics.median(r["steps"])
        say(f"phase 14 Engine.generate absorb={absorb}, batch {LM_BATCH} x prompt "
            f"{LM_PROMPT} + {LM_NEW} new: {r['gen_s']:.3f} s; prefill "
            f"{r['prefill_ms']:.3f} ms (median of {TIMED_REPS}), decode {step_ms:.3f} ms "
            f"a step (median of {LM_NEW}; min {min(r['steps']):.3f}, max "
            f"{max(r['steps']):.3f}), {LM_BATCH / step_ms * 1e3:.1f} tokens/s; norm "
            f"kernel launches {r['norm']} ({n_moe} MoE layer x {1 + LM_NEW} forwards); "
            f"{card}")
    same = int((runs[False]["greedy"] == runs[True]["greedy"]).sum())
    say(f"phase 14 peak memory {peak / 1e9:.2f} GB (gate 80); greedy tokens of the "
        f"absorbed path equal to the naive path's on {same} of {LM_BATCH * LM_NEW}; {card}")
    if peak > 80e9:
        fail(f"phase 14: peak memory {peak / 1e9:.2f} GB")

    # ---- (b) gates ----------------------------------------------------------
    w = next(layer["ffn"]["router"] for layer, spec in zip(params["layers"],
             cfg.layer_specs()) if spec.moe).detach()
    e, d = w.shape
    if norm_variant(e, d) != NORM_SHORT_WIDE:
        fail(f"phase 14: norm_variant{(e, d)} is not the short-wide variant")
    got, ref = norms_cuda(w), norms_plain(w)
    norm_err = score_error(got, ref, ref)
    r = norm_checked(torch, "phase 14 norm at the DeepSeek-V3 router table (the model's)", w)
    plain_ms, _ = event_ms(lambda: norms_plain(w))
    sets = [(a, torch.empty((1, e), dtype=torch.float32, device="cuda"))
            for a in cold_copies(w)]
    alone_ms = device_ms("rayflex_norm", [norm_args(a, o, NORM_SHORT_WIDE) for a, o in sets])
    del sets
    say(f"phase 14 gates: the router's norms through norms_cuda (short-wide) within "
        f"{scaled_error(got, ref, ref):.3g} |c|^2 of norms_plain (gate "
        f"{SCORE_RTOL:g}); {ds_combine_gate(torch, runs[False]['cfg'], params, prompts)}")

    naive = runs[False]["greedy"]
    for dtype in ("float32", "bfloat16"):
        dcfg = dataclasses.replace(cfg, compute_dtype=dtype)
        err, free, scale, flipped = ds_absorbed_vs_naive(torch, dcfg, params, prompts, naive)
        tol = DS_ABSORB_TOL[dtype]
        say(f"phase 14 absorbed against naive decode ({dtype}), teacher-forced on the "
            f"naive path's {LM_NEW} greedy tokens at batch {LM_BATCH}: logits of the "
            f"prefill and all {LM_NEW} steps at |logits| up to {scale:.3f}, routing "
            f"forced to the naive path's, max |err| {err:.6g} (gate {tol:g}); routing "
            f"by itself, {int(flipped.sum())} of {LM_BATCH} rows routed differently "
            f"somewhere, max |err| {free:.6g} (control)")
        if dtype == "float32" and bool(flipped.any()):
            fail(f"phase 14: float32 absorbed and naive decode routed {int(flipped.sum())} "
                 f"of {LM_BATCH} rows differently")
        if not err <= tol:
            fail(f"phase 14: {dtype} absorbed decode logits {err:.6g} from the naive "
                 f"path's (gate {tol:g})")

    torch.cuda.reset_peak_memory_stats()
    gate_prompts = prompts[:DS_GATE_BATCH]
    for dtype in ("float32", "bfloat16"):
        for absorb in (False, True):
            nodrop = dataclasses.replace(
                cfg, compute_dtype=dtype,
                mla=dataclasses.replace(cfg.mla, absorb=absorb),
                moe=dataclasses.replace(cfg.moe, capacity_factor=DS_NODROP_CF))
            free, forced, scale, flipped = lm_decode_vs_prefill(torch, nodrop, params,
                                                                gate_prompts)
            tol = DS_DECODE_TOL[dtype]
            worst = float(forced.max())
            say(f"phase 14 decode (absorb={absorb}) vs one prefill of "
                f"{LM_PROMPT + LM_NEW} tokens ({dtype}, batch {DS_GATE_BATCH}, "
                f"capacity_factor {DS_NODROP_CF:g}: no drops), last-step logits at "
                f"|logits| up to {scale:.3f}: routing forced to the decode path's, max "
                f"|err| per row {[round(float(v), 6) for v in forced]}, worst {worst:.6g} "
                f"(gate {tol:g}); the prefill routing by itself, {int(flipped.sum())} of "
                f"{DS_GATE_BATCH} rows routed differently somewhere, max |err| per row "
                f"{[round(float(v), 6) for v in free]}")
            if dtype == "float32" and bool(flipped.any()):
                fail(f"phase 14: float32 decode (absorb={absorb}) and prefill routed "
                     f"{int(flipped.sum())} of {DS_GATE_BATCH} rows differently")
            if not worst <= tol:
                fail(f"phase 14: {dtype} decode (absorb={absorb}) logits {worst:.6g} from "
                     f"the full prefill's with the same routing (gate {tol:g})")
    gate_peak = torch.cuda.max_memory_allocated()
    say(f"phase 14 decode-vs-prefill gates at batch {DS_GATE_BATCH}: peak memory "
        f"{gate_peak / 1e9:.2f} GB (gate 75); {card}")
    if gate_peak > 75e9:
        fail(f"phase 14: the no-drop gates peaked at {gate_peak / 1e9:.2f} GB")
    n_launch = runs[False]["norm"]
    del params, w, got, ref, runs, prompts, gate_prompts
    gc.collect()
    torch.cuda.empty_cache()
    say(f"phase 14 seconds: {time.perf_counter() - t_phase:.1f}")

    # the norm kernel at the model's router, in the model (row 5c)
    dev = r["norms_cuda"]["device_us"]
    bound = bound_ms(4.0 * (e * d + e), 2.0 * e * d)
    name = "norm (DeepSeek-V3 router)"
    row = kernel_row(name, "distance.cu", "src/repro/kernels/distance.py:65",
                     {name: n_launch}, alone_ms if dev is None else dev / 1e3, plain_ms,
                     norm_err, bound, r["vector_norm"]["window_ms"],
                     wrapper_ms=r["norms_cuda"]["window_ms"])
    row["alone_ms"] = alone_ms
    row["host_us"] = r["norms_cuda"]["host_us"]
    return [row]


# ---------------------------------------------------------------------------
# phase 15: Jamba-1.5-Large serving (Mamba mixers, conv and SSM caches)
# ---------------------------------------------------------------------------


def scan_calls(torch, cfg, params, prompts) -> dict:
    """The selective scan's arguments in one prefill of ``prompts`` and in
    the decode step after it, caught by a spy: ``{"prefill": [...],
    "decode step": [...]}``, one argument tuple per Mamba layer."""
    from repro_torch.models import decode_step, init_cache, prefill
    from repro_torch.models import mamba as mam
    from repro_torch.parallel import NO_PARALLEL
    caught = {"prefill": [], "decode step": []}
    scan, into = mam.selective_scan, caught["prefill"]

    def spy(*args):
        into.append(args)
        return scan(*args)

    mam.selective_scan = spy
    try:
        logits, cache = prefill(cfg, NO_PARALLEL, params, {"tokens": prompts},
                                init_cache(cfg, prompts.shape[0], LM_MAX_LEN, device="cuda"))
        into = caught["decode step"]
        decode_step(cfg, NO_PARALLEL, params, cache,
                    logits[:, -1].argmax(-1)[:, None].to(torch.int32))
    finally:
        mam.selective_scan = scan
    return caught


def jamba_mixer_gate(torch, cfg, params, prompts) -> tuple[float, str]:
    """Layer 0's Mamba mixer, float32 with exact products, at the real
    activations of ``prompts`` (embedding, ``norm1``) on the card and on
    the CPU from the same weights: the worst |card - CPU| / (1 + |CPU|)
    over its output and both new states, and a summary."""
    from repro_torch.models import mamba as mam
    from repro_torch.models.layers import exact_products, norm_apply
    from repro_torch.models.model import _embed_inputs
    from repro_torch.parallel import NO_PARALLEL
    f32 = dataclasses.replace(cfg, compute_dtype="float32")
    blk = params["layers"][0]
    p_cpu = {k: (v.detach().cpu() if isinstance(v, torch.Tensor)
                 else {n: t.detach().cpu() for n, t in v.items()})
             for k, v in blk["mixer"].items()}
    with torch.no_grad(), exact_products():
        h, _, _ = _embed_inputs(f32, NO_PARALLEL, params, {"tokens": prompts})
        x = norm_apply(f32, blk["norm1"], h)
        y, states = mam.mamba_apply(f32, NO_PARALLEL, blk["mixer"], x)
        got = [t.cpu() for t in (y, *states)]
        y_c, states_c = mam.mamba_apply(f32, NO_PARALLEL, p_cpu, x.cpu())
    err = max(float(((g - w).abs() / (1 + w.abs())).max())
              for g, w in zip(got, (y_c, *states_c), strict=True))
    return err, (f"layer 0's Mamba mixer on {prompts.shape[0]} x {prompts.shape[1]} real "
                 f"activations (float32): output and conv / SSM states within {err:.3g} "
                 f"(1 + |CPU|) of the CPU path (gate {JB_MIXER_TOL:g}), |y| up to "
                 f"{float(y_c.abs().max()):.3f}")


def phase_jamba(torch, card: str) -> list:
    """Phase 15: ``init_params`` -> ``Engine.generate`` for Jamba-1.5-Large
    at full width (3 of 72 layers, all Mamba, the middle one MoE) on the
    card, the norm kernel on its 16 x 8192 router table, layer 0's mixer
    against the CPU path, decode against one prefill."""
    import gc
    from repro_torch.configs import get_config
    from repro_torch.kernels import nvcc
    from repro_torch.kernels.distance import (NORM_SHORT_WIDE, norm_variant, norms_cuda,
                                              norms_plain)
    from repro_torch.models import count_params, init_params
    from repro_torch.models import mamba as mam
    from repro_torch.serving import Engine

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    say(f"phase 15: {torch.cuda.memory_allocated() / 1e9:.2f} GB allocated after phase "
        "14's weights were released")
    torch.cuda.reset_peak_memory_stats()
    cfg = dataclasses.replace(get_config(JB_ARCH), num_layers=JB_LAYERS)
    n_moe = sum(spec.moe for spec in cfg.layer_specs())
    t0 = time.perf_counter()
    params = init_params(torch.Generator(device="cuda").manual_seed(SEED), cfg,
                         device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in params.parameters())
    if not n_params == count_params(cfg) == JB_PARAMS:
        fail(f"phase 15: {n_params} parameters, count_params says {count_params(cfg)}, "
             f"the cut's count {JB_PARAMS}")
    say(f"phase 15 {cfg.name} at full width, {JB_LAYERS} of 72 layers "
        f"({[spec.mixer + (' + MoE' if spec.moe else '') for spec in cfg.layer_specs()]}): "
        f"{n_params:,} parameters ({n_params * 4 / 1e9:.2f} GB f32), init {init_s:.2f} s")
    prompts = torch.as_tensor(np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (LM_BATCH, LM_PROMPT)), dtype=torch.int32, device="cuda")
    eng = Engine(cfg, params, max_len=LM_MAX_LEN)
    eng.generate(prompts[:1, :8], 1)  # warm-up

    # ---- (a) the main path, its launches counted ----------------------------
    nvcc.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    greedy = eng.generate(prompts, LM_NEW)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    launches = nvcc.launch_counts()
    want = n_moe * (1 + LM_NEW)
    if launches != {"norm": want}:
        fail(f"phase 15: Engine.generate launched {launches}; the norm kernel should run "
             f"{want} times ({n_moe} MoE layer x {1 + LM_NEW} forwards) and nothing else")
    if greedy.shape != (LM_BATCH, LM_NEW) or greedy.dtype != torch.int32 or not bool(
            ((greedy >= 0) & (greedy < cfg.vocab_size)).all()):
        fail(f"phase 15: greedy tokens {tuple(greedy.shape)} {greedy.dtype} out of range")
    prefill_ms, steps, timed = lm_generate_timed(torch, cfg, params, prompts)
    if not torch.equal(timed, greedy):
        fail("phase 15: the timed loop's greedy tokens differ from Engine.generate's")
    step_ms = statistics.median(steps)
    peak = torch.cuda.max_memory_allocated()
    say(f"phase 15 Engine.generate batch {LM_BATCH} x prompt {LM_PROMPT} + {LM_NEW} new: "
        f"{gen_s:.3f} s; prefill {prefill_ms:.3f} ms (median of {TIMED_REPS}), decode "
        f"{step_ms:.3f} ms a step (median of {LM_NEW}; min {min(steps):.3f}, max "
        f"{max(steps):.3f}), {LM_BATCH / step_ms * 1e3:.1f} tokens/s; peak memory "
        f"{peak / 1e9:.2f} GB; norm kernel launches {launches['norm']} ({n_moe} MoE layer "
        f"x {1 + LM_NEW} forwards); {card}")
    busy = lm_profile(torch, cfg, params, prompts, phase="phase 15")
    for label, calls in scan_calls(torch, cfg, params, prompts).items():
        def run(calls=calls):
            with torch.no_grad():
                for args in calls:
                    mam.selective_scan(*args)
        us, _ = profiled_us([run])
        share = ("not measured" if us is None or busy.get(label) is None
                 else f"{us / 1e3 / busy[label]:.1%} of its {busy[label]:.3f} ms busy")
        say(f"phase 15 profile, {label}: the selective scan of its {len(calls)} Mamba "
            f"layers {'not measured' if us is None else f'{us / 1e3:.3f} ms'} of device "
            f"time ({share}); {card}")

    # ---- (b) gates ----------------------------------------------------------
    w = params["layers"][1]["ffn"]["router"].detach()
    e, d = w.shape
    if norm_variant(e, d) != NORM_SHORT_WIDE:
        fail(f"phase 15: norm_variant{(e, d)} is not the short-wide variant")
    got, ref = norms_cuda(w), norms_plain(w)
    norm_err, norm_rel = score_error(got, ref, ref), scaled_error(got, ref, ref)
    if norm_rel > SCORE_RTOL:
        fail(f"phase 15: the router's norms {norm_rel:.3g} |c|^2 from norms_plain")
    r = norm_checked(torch, "phase 15 norm at the Jamba-1.5-Large router table (the model's)",
                     w)
    plain_ms, _ = event_ms(lambda: norms_plain(w))
    sets = [(a, torch.empty((1, e), dtype=torch.float32, device="cuda"))
            for a in cold_copies(w)]
    alone_ms = device_ms("rayflex_norm", [norm_args(a, o, NORM_SHORT_WIDE) for a, o in sets])
    del sets
    mixer_err, mixer_line = jamba_mixer_gate(torch, cfg, params, prompts[:JB_MIXER_ROWS])
    say(f"phase 15 gates: the router's norms through norms_cuda (short-wide) within "
        f"{norm_rel:.3g} |c|^2 of norms_plain (gate {SCORE_RTOL:g}); {mixer_line}")
    if not mixer_err <= JB_MIXER_TOL:
        fail(f"phase 15: layer 0's Mamba mixer {mixer_err:.3g} from the CPU path "
             f"(gate {JB_MIXER_TOL:g})")

    # decode through the conv / SSM caches against one prefill of the whole
    # sequence (160 positions: two scan chunks, the second padded), every row
    # compared with the prefill's routing forced to the decode path's
    for dtype in ("float32", "bfloat16"):
        nodrop = dataclasses.replace(
            cfg, compute_dtype=dtype,
            moe=dataclasses.replace(cfg.moe, capacity_factor=LM_NODROP_CF))
        free, forced, scale, flipped = lm_decode_vs_prefill(torch, nodrop, params, prompts)
        tol = LM_DECODE_TOL[dtype]
        worst = float(forced.max())
        say(f"phase 15 decode vs one prefill of {LM_PROMPT + LM_NEW} tokens ({dtype}, "
            f"capacity_factor {LM_NODROP_CF:g}: no drops), last-step logits at |logits| up "
            f"to {scale:.3f}: routing forced to the decode path's, max |err| per row "
            f"{[round(float(v), 6) for v in forced]}, worst {worst:.6g} (gate {tol:g}); "
            f"the prefill routing by itself, {int(flipped.sum())} of {LM_BATCH} rows "
            f"routed differently somewhere, max |err| per row "
            f"{[round(float(v), 6) for v in free]}")
        if dtype == "float32" and bool(flipped.any()):
            fail(f"phase 15: float32 decode and prefill routed {int(flipped.sum())} of "
                 f"{LM_BATCH} rows differently")
        if not worst <= tol:
            fail(f"phase 15: {dtype} decode logits {worst:.6g} from the full prefill's "
                 f"with the same routing (gate {tol:g})")
    peak = torch.cuda.max_memory_allocated()
    say(f"phase 15 peak memory over the phase {peak / 1e9:.2f} GB (gate {JB_PEAK_GB}); "
        f"{card}")
    if peak > JB_PEAK_GB * 1e9:
        fail(f"phase 15: peak memory {peak / 1e9:.2f} GB")
    del params, w, got, ref, eng, prompts
    gc.collect()
    torch.cuda.empty_cache()
    say(f"phase 15 seconds: {time.perf_counter() - t_phase:.1f}")

    # the norm kernel at the model's router, in the model (row 5d)
    dev = r["norms_cuda"]["device_us"]
    bound = bound_ms(4.0 * (e * d + e), 2.0 * e * d)
    name = "norm (Jamba-1.5-Large router)"
    row = kernel_row(name, "distance.cu", "src/repro/kernels/distance.py:65",
                     {name: launches["norm"]}, alone_ms if dev is None else dev / 1e3,
                     plain_ms, norm_err, bound, r["vector_norm"]["window_ms"],
                     wrapper_ms=r["norms_cuda"]["window_ms"])
    row["alone_ms"] = alone_ms
    row["host_us"] = r["norms_cuda"]["host_us"]
    return [row]


def main() -> None:
    if not (SRC / "repro_torch").is_dir() or not GOLDEN.is_dir():
        fail(f"{SRC / 'repro_torch'} or {GOLDEN} missing: run from a "
             "checkout of the repository")
    sys.path.insert(0, str(SRC))
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.kernels import nvcc

    # ---- phase 1: build -------------------------------------------------------
    t0 = time.perf_counter()
    lib_path = nvcc.build()
    nvcc.library()
    say(f"phase 1 build: {lib_path.name} in {time.perf_counter() - t0:.1f} s "
        f"(nvcc {' '.join(nvcc.ARCH_FLAGS + nvcc.NVCC_FLAGS)})")
    for src, log in sorted(nvcc.build_log.items()):
        if src == "neighbor.cu":
            for label, stack, regs in neighbor_ptxas(log):
                say(f"  ptxas neighbor.cu {label}: {regs}; {stack}")
            continue
        if src == "traverse.cu":
            for label, line in traverse_ptxas(log):
                say(f"  ptxas traverse.cu {label}: {line}")
            continue
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                say(f"  ptxas {src}: {line.strip()}")
    hgmma = hgmma_counts(lib_path)
    if hgmma is None:
        say("phase 1 SASS: the toolkit has no cuobjdump; ptxas's lines above "
            "stand for the distance kernel")
    elif sorted(hgmma) != ["angular", "euclidean"] or min(hgmma.values()) < 1:
        fail(f"the distance kernels hold no TF32 wgmma in their SASS ({hgmma})")
    else:
        say("phase 1 SASS: TF32 wgmma (HGMMA) instructions in the distance "
            f"kernel: {hgmma['euclidean']} euclidean, {hgmma['angular']} angular")
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
    kernels, stage_jobs = phase_main_path(torch)
    rows, vectors = phase_brute(torch)
    kernels += rows
    kernels += phase_tree(torch)
    kernels += phase_stream(torch, stage_jobs, vectors)
    phase_dynamic(torch)
    kernels += phase_twins(torch)
    phase_serving(torch, vectors[0], vectors[1])
    del stage_jobs, vectors
    kernels += phase_lm(torch, card)
    kernels += phase_deepseek(torch, card)
    kernels += phase_jamba(torch, card)

    say(card)
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
