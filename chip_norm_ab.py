#!/usr/bin/env python3
"""The norm kernel and the shared launch path of two checkouts of the port,
in turns, on one GPU.

    python3 chip_norm_ab.py PARENT_DIR [--turns parent,change,change,parent]

``PARENT_DIR`` is another checkout of the repository (say a parent commit
unpacked with ``git archive`` into ``build/``, which ``.gitignore``
lists); this checkout is the change.  Each turn is a process of its own,
which imports ``repro_torch`` from its checkout (building that checkout's
kernels into its own ``build/``) and the helpers of this checkout's
``chip_smoke.py``.  A turn measures, on seeded N(0, 1) tables:

- at each router table of ``chip_smoke.NORM_ROUTER_TABLES`` and at the
  brute-force tables (glove-shape 1,183,514 x 100, sift-shape 1,000,000 x
  128), ``chip_smoke.norm_numbers``: the device time a call of
  ``norms_cuda`` (``torch.profiler``'s kernel events), its event window
  and its host time a call, beside ``torch.linalg.vector_norm``'s and
  ``(c * c).sum(1)``'s;
- the host time a call of the raybox and raytri wrappers (65,536 jobs);
- the host time of the launch path's pieces (``chip_smoke.host_us``:
  loops of calls with no synchronize inside), the C entry points called
  through ``ctypes.CDLL`` and ``ctypes.PyDLL`` (which keeps the GIL).

It prints each turn's numbers as one JSON line, then, per checkout, the
median over its turns, with the card's name and power limit first.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 20240930
BRUTE_TABLES = (("glove-shape", 1_183_514, 100), ("sift-shape", 1_000_000, 128))
STAGE_JOBS = 65_536


def fail(msg: str) -> None:
    print(f"chip_norm_ab: FAIL: {msg}", flush=True)
    sys.exit(1)


def measure(tree: Path) -> dict:
    """One turn: every number of the module docstring, for ``tree``."""
    sys.path.insert(0, str(tree / "src"))
    sys.path.insert(1, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this run needs a GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    import chip_smoke as cs
    from repro_torch.kernels import distance, nvcc
    from repro_torch.kernels.raybox import raybox
    from repro_torch.kernels.raytri import raytri
    if Path(nvcc.__file__).resolve().parents[2] != tree / "src":
        fail(f"imported {nvcc.__file__}, not {tree}'s repro_torch")
    nvcc.library()
    f32, dev = torch.float32, "cuda"
    gen = torch.Generator(device=dev).manual_seed(SEED)
    out = {"tree": str(tree), "tables": {}}
    tables = [(a, n, d) for a, n, d in cs.NORM_ROUTER_TABLES] + list(BRUTE_TABLES)
    for label, n, d in tables:
        c = torch.randn((n, d), generator=gen, device=dev)
        out["tables"][label] = cs.norm_numbers(torch, c)
        del c
        torch.cuda.empty_cache()

    n = STAGE_JOBS
    org = torch.randn((3, n), generator=gen, device=dev)
    inv = torch.randn((3, n), generator=gen, device=dev)
    neg = (inv < 0).to(f32)
    lo = torch.randn((12, n), generator=gen, device=dev)
    hi = lo + torch.rand((12, n), generator=gen, device=dev)
    k = torch.randint(0, 3, (3, n), generator=gen, device=dev, dtype=torch.int32)
    verts = [torch.randn((3, n), generator=gen, device=dev) for _ in range(3)]
    out["wrappers_host_us"] = {
        "raybox": cs.host_us(lambda: raybox(org, inv, neg, lo, hi)),
        "raytri": cs.host_us(lambda: raytri(org, inv, k, *verts)),
    }

    # the launch path's pieces, at the Phi-3.5-MoE router table, through
    # both ctypes loaders of the checkout's library
    c = torch.randn((16, 4096), generator=gen, device=dev)
    dst = torch.empty((1, 16), dtype=f32, device=dev)
    args = cs.norm_args(c, dst, 1)
    stream = torch.cuda.current_stream().cuda_stream
    entry = {}
    for loader in (ctypes.CDLL, ctypes.PyDLL):
        lib = loader(str(nvcc.build()))
        lib.rayflex_norm.argtypes = nvcc.SIGNATURES["rayflex_norm"]
        lib.rayflex_error_string.argtypes = [ctypes.c_int]
        lib.rayflex_error_string.restype = ctypes.c_char_p
        entry[loader.__name__] = lib
    pieces = {
        "check_cuda": lambda: nvcc.check_cuda("c", c, f32, (16, 4096)),
        "torch.empty(device=c.device)": lambda: torch.empty((1, 16), dtype=f32,
                                                            device=c.device),
        "c.new_empty": lambda: c.new_empty((1, 16)),
        "torch.cuda.current_stream().cuda_stream":
            lambda: torch.cuda.current_stream().cuda_stream,
        "torch._C._cuda_getCurrentRawStream(device)":
            lambda: torch._C._cuda_getCurrentRawStream(torch._C._cuda_getDevice()),
        "getattr(nvcc.library(), name)": lambda: getattr(nvcc.library(), "rayflex_norm"),
        "count_launch": lambda: nvcc.count_launch("norm"),
    }
    for name, lib in entry.items():
        pieces[f"{name} call, no launch"] = lambda lib=lib: lib.rayflex_error_string(0)
        pieces[f"{name} call, the launch"] = lambda lib=lib: lib.rayflex_norm(*args, stream)
    if hasattr(distance, "norm_variant"):
        pieces["norm_variant"] = lambda: distance.norm_variant(16, 4096)
    out["pieces_host_us"] = {name: cs.host_us(p) for name, p in pieces.items()}
    return out


def summary(turns: list[dict]) -> None:
    """Per checkout, the median over its turns of every number."""
    def med(vals):
        vals = [v for v in vals if v is not None]
        return statistics.median(vals) if vals else None

    for who in ("parent", "change"):
        mine = [t for t in turns if t["who"] == who]
        print(f"== {who} ({len(mine)} turns, medians): {mine[0]['tree']}")
        for label in mine[0]["tables"]:
            r0 = mine[0]["tables"][label]
            parts = []
            for fn in ("norms_cuda", "vector_norm", "sumsq"):
                dev = med([t["tables"][label][fn]["device_us"] for t in mine])
                win = med([t["tables"][label][fn]["window_ms"] for t in mine])
                host = med([t["tables"][label][fn]["host_us"] for t in mine])
                dev_s = "not measured" if dev is None else f"{dev:.3f} us"
                parts.append(f"{fn}: device {dev_s}, window {win:.4f} ms, host {host:.2f} us")
            print(f"  {label} {r0['shape'][0]} x {r0['shape'][1]} "
                  f"{r0['norms_cuda']['kernels']}: " + "; ".join(parts))
        for key in ("wrappers_host_us", "pieces_host_us"):
            print(f"  {key}: " + ", ".join(
                f"{name} {med([t[key][name] for t in mine]):.3f}" for name in mine[0][key]))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("parent")
    ap.add_argument("--turns", default="parent,change,change,parent")
    ap.add_argument("--measure", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.measure:
        print(json.dumps(measure(Path(args.measure).resolve())), flush=True)
        return
    trees = {"parent": Path(args.parent).resolve(), "change": ROOT}
    for who, tree in trees.items():
        if not (tree / "src" / "repro_torch").is_dir():
            fail(f"{tree} holds no src/repro_torch ({who})")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    print(smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else "nvidia-smi: none",
          flush=True)
    turns = []
    for who in args.turns.split(","):
        proc = subprocess.run([sys.executable, __file__, args.parent, "--measure",
                               str(trees[who])], capture_output=True, text=True,
                              timeout=900)
        if proc.returncode != 0:
            fail(f"{who} turn exited {proc.returncode}:\n{proc.stdout[-4000:]}\n"
                 f"{proc.stderr[-4000:]}")
        turn = json.loads(proc.stdout.strip().splitlines()[-1])
        turn["who"] = who
        print(json.dumps(turn), flush=True)
        turns.append(turn)
    summary(turns)


if __name__ == "__main__":
    main()
