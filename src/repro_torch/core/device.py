"""Device policy of the port's entry points.

Entry points put their tensors on ``cuda`` unless the caller asks for
another device.  There is no silent fallback: without a GPU, a call that
did not pass ``device="cpu"`` raises.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> the first CUDA device (raises if there is none);
    anything else -> ``torch.device(device)``."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch entry points run on CUDA by default and no "
                "CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch path")
        return torch.device("cuda")
    return torch.device(device)
