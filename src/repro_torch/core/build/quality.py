"""Tree-quality workloads: the canonical clustered triangle soup.

The port's own copy of ``clustered_soup`` from
``repro/core/build/quality.py``: the same numpy construction, drawing the
same numbers from the same generator, so a seed gives the same soup in
both packages.  The rest of that module (SAH cost, jobs per ray) comes in
a later slice.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..types import Triangle


def clustered_soup(rng: np.random.Generator, n_clusters: int = 8,
                   per_cluster: int = 40, *, device=None) -> Triangle:
    """Tight triangle clusters flung across a wide volume: centres uniform
    in [-4, 4]^3, vertices normal around them (scale 0.06, edges 0.03)."""
    centers = rng.uniform(-4, 4, (n_clusters, 3)).astype(np.float32)
    ctr = (np.repeat(centers, per_cluster, axis=0)
           + rng.normal(scale=0.06, size=(n_clusters * per_cluster, 3))
           ).astype(np.float32)
    d1 = rng.normal(scale=0.03, size=ctr.shape).astype(np.float32)
    d2 = rng.normal(scale=0.03, size=ctr.shape).astype(np.float32)
    device = resolve_device(device)
    return Triangle(*(torch.as_tensor(v, device=device)
                      for v in (ctr, ctr + d1, ctr + d2)))
