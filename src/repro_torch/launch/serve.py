"""Serving launcher: batched generation with the smoke (or full) config.

``python -m repro_torch.launch.serve --arch phi3.5-moe-42b-a6.6b --batch 4 --new 32``

Parameters are random, drawn from ``--seed`` on ``--device`` (default
``cuda``; ``--device cpu`` runs the plain PyTorch path).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs.registry import ARCH_IDS, get_config, get_smoke
from ..models import init_params
from ..serving import Engine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="smollm-360m")
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch) if args.full else get_smoke(args.arch)
    device = torch.device(args.device)
    params = init_params(args.seed, cfg, device=device)
    rng = np.random.default_rng(args.seed)
    eng = Engine(cfg, params, max_len=args.prompt_len + args.new + 8)
    prompt = torch.as_tensor(
        rng.integers(0, cfg.vocab_size, (args.batch, args.prompt_len)),
        dtype=torch.int32, device=device)

    t0 = time.perf_counter()
    out = eng.generate(prompt, max_new_tokens=args.new,
                       temperature=args.temperature, rng=args.seed)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    toks = args.batch * args.new
    print(f"arch={cfg.name} device={device} generated {tuple(out.shape)} in "
          f"{dt:.2f}s ({toks / dt:.1f} tok/s, first call)")
    print("sample:", out[0, :16].cpu().numpy())


if __name__ == "__main__":
    main()
