"""Carry state across from the reference package, through numpy.

The port imports nothing of ``repro``; a caller who holds a ``repro``
BVH, ray batch, vector index, point cloud, datapath job stream, model
parameters or decode cache passes its arrays as numpy and gets the port's
objects back.  With these, traversal parity can be tested apart from
builder parity: both packages traverse the very same tree, under any
datapath config (a config crosses as its ``tag``, e.g.
``"bvh8_s64_bf16_compressed"``); and both compute a model with the same
weights.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

import re

from .core.bvh import BVH4, DatapathConfig, leaf_depth, num_nodes, resolve_config
from .core.device import resolve_device
from .core.session import PointCloudScene, Scene, VectorIndex
from .core.stream import DatapathJob
from .core.types import Box, DatapathState, Ray, Triangle
from .models.config import ModelConfig, derive_segments


def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(np.array(x, dtype=np.float32), device=device)


def _i32(x, device) -> torch.Tensor:
    return torch.as_tensor(np.array(x, dtype=np.int32), device=device)


_TAG = re.compile(r"bvh(\d+)_s(\d+)_(\w+?)_(\w+)")


def config_from_tag(tag) -> DatapathConfig:
    """A ``DatapathConfig.tag`` (``"bvh4_s64_fp32_fp32"``) -> the port's
    validated config; a config (or None) passes through ``resolve_config``."""
    if tag is None or isinstance(tag, DatapathConfig):
        return resolve_config(tag)
    m = _TAG.fullmatch(str(tag))
    if m is None:
        raise ValueError(f"not a DatapathConfig tag: {tag!r}")
    return DatapathConfig(int(m[1]), int(m[2]), m[3], m[4]).validate()


def bvh_from_numpy(node_lo, node_hi, leaf_tri, a, b, c, leaf_perm, *,
                   config=None, device=None) -> BVH4:
    """A ``repro`` ``BVH4``'s arrays (as numpy) -> the port's ``BVH4``.
    ``config`` (a tag or a config) checks that the arrays are a complete
    tree at its arity."""
    arity = config_from_tag(config).arity
    n_leaf = np.shape(leaf_tri)[0]
    depth = leaf_depth(n_leaf, arity)
    if arity**depth != n_leaf or np.shape(node_lo)[0] != num_nodes(depth, arity):
        raise ValueError(f"{n_leaf} leaves and {np.shape(node_lo)[0]} nodes are "
                         f"not a complete {arity}-ary tree")
    device = resolve_device(device)
    return BVH4(node_lo=_f32(node_lo, device), node_hi=_f32(node_hi, device),
                leaf_tri=_i32(leaf_tri, device),
                triangles=Triangle(_f32(a, device), _f32(b, device),
                                   _f32(c, device)),
                leaf_perm=_i32(leaf_perm, device))


def scene_from_numpy(node_lo, node_hi, leaf_tri, a, b, c, leaf_perm, depth, *,
                     builder: str = "lbvh", config=None, device=None) -> Scene:
    """A ``repro`` ``BuildResult`` (its tree's arrays as numpy, its depth,
    builder and config or config tag) -> the port's ``Scene`` over the same
    tree, traced under the same config."""
    config = config_from_tag(config)
    bvh = bvh_from_numpy(node_lo, node_hi, leaf_tri, a, b, c, leaf_perm,
                         config=config, device=device)
    if config.arity**int(depth) != bvh.leaf_tri.shape[0]:
        raise ValueError(f"depth {depth} does not match {bvh.leaf_tri.shape[0]} "
                         f"leaves at arity {config.arity}")
    return Scene(bvh, int(depth), builder=builder, config=config)


def rays_from_numpy(origin, direction, inv, extent, kx, ky, kz, shear, *,
                    device=None) -> Ray:
    """A ``repro`` ``Ray``'s fields (as numpy) -> the port's ``Ray``."""
    device = resolve_device(device)
    return Ray(origin=_f32(origin, device), direction=_f32(direction, device),
               inv=_f32(inv, device), extent=_f32(extent, device),
               kx=_i32(kx, device), ky=_i32(ky, device), kz=_i32(kz, device),
               shear=_f32(shear, device))


def index_from_numpy(database, sq_norms=None, *, device=None) -> VectorIndex:
    """A ``repro`` ``VectorIndex``'s database (and, optionally, its
    ``sq_norms``) as numpy -> the port's ``VectorIndex``."""
    device = resolve_device(device)
    return VectorIndex(_f32(database, device),
                       None if sq_norms is None else _f32(sq_norms, device),
                       device=device)


def point_cloud_from_numpy(node_lo, node_hi, leaf_tri, points, leaf_perm, depth,
                           *, config=None, device=None) -> PointCloudScene:
    """A ``repro`` point BVH's arrays (as numpy; ``points`` is its
    ``triangles.a``) and its config or config tag -> the port's
    ``PointCloudScene`` over the same tree."""
    device = resolve_device(device)
    pts = _f32(points, device)
    bvh = BVH4(node_lo=_f32(node_lo, device), node_hi=_f32(node_hi, device),
               leaf_tri=_i32(leaf_tri, device), triangles=Triangle(pts, pts, pts),
               leaf_perm=_i32(leaf_perm, device))
    return PointCloudScene(bvh, int(depth), config=config_from_tag(config))


def jobs_from_numpy(jobs, *, device=None) -> DatapathJob:
    """A ``repro`` ``DatapathJob`` whose leaves are numpy arrays (for
    example ``jax.tree.map(np.asarray, jobs)``) -> the port's
    ``DatapathJob``, field by field."""
    device = resolve_device(device)
    r = jobs.ray
    return DatapathJob(
        opcode=_i32(jobs.opcode, device),
        ray=rays_from_numpy(r.origin, r.direction, r.inv, r.extent, r.kx, r.ky,
                            r.kz, r.shear, device=device),
        boxes=Box(_f32(jobs.boxes.lo, device), _f32(jobs.boxes.hi, device)),
        triangle=Triangle(*(_f32(v, device) for v in jobs.triangle)),
        vec_a=_f32(jobs.vec_a, device), vec_b=_f32(jobs.vec_b, device),
        mask=torch.as_tensor(np.array(jobs.mask, dtype=bool), device=device),
        reset_accum=torch.as_tensor(np.array(jobs.reset_accum, dtype=bool),
                                    device=device))


def datapath_state_from_numpy(state, *, device=None) -> DatapathState:
    """A ``repro`` ``DatapathState`` with numpy leaves -> the port's."""
    device = resolve_device(device)
    return DatapathState(*(_f32(x, device) for x in state))


def _tensor(x, device) -> torch.Tensor:
    """A numpy array (bf16 from ``ml_dtypes`` too) as a tensor of its dtype."""
    x = np.asarray(x)
    if x.dtype.name == "bfloat16":
        return torch.from_numpy(x.view(np.int16).copy()).view(torch.bfloat16).to(device)
    return torch.as_tensor(x.copy(), device=device)


def _modules(tree, device):
    """A dict of dicts of arrays -> ``nn.ModuleDict`` (dicts only) or
    ``nn.ParameterDict`` (arrays, and any dicts beside them)."""
    if all(isinstance(v, dict) for v in tree.values()):
        return nn.ModuleDict({k: _modules(v, device) for k, v in tree.items()})
    return nn.ParameterDict({k: _modules(v, device) if isinstance(v, dict)
                             else nn.Parameter(_tensor(v, device))
                             for k, v in tree.items()})


def model_params_from_numpy(cfg: ModelConfig, params, *, device=None) -> nn.ModuleDict:
    """A ``repro`` parameter tree with numpy leaves (for example
    ``jax.tree.map(np.asarray, params)``) -> the port's modules: the
    reference's stacked segment arrays split into one block per layer, in
    layer order, and the MTP head, where the tree has one, with its block
    unstacked."""
    device = resolve_device(device)
    layers = []
    for (pattern, repeats), seg in zip(derive_segments(cfg), params["segments"],
                                       strict=True):
        if len(seg) != len(pattern):
            raise ValueError(f"a segment of {len(seg)} blocks for a pattern of "
                             f"{len(pattern)}")
        for r in range(repeats):
            for blk in seg:
                layers.append(_modules(_slice(blk, r), device))
    out = nn.ModuleDict({"embed": _modules(params["embed"], device),
                         "layers": nn.ModuleList(layers),
                         "final_norm": _modules(params["final_norm"], device)})
    if "mtp" in params:  # its one block stacked on a leading axis of 1
        mtp = params["mtp"]
        out["mtp"] = _modules({**mtp, "block": _slice(mtp["block"], 0)}, device)
    return out


def _slice(tree, r):
    return {k: _slice(v, r) if isinstance(v, dict) else np.asarray(v)[r]
            for k, v in tree.items()}


def cache_from_numpy(cfg: ModelConfig, cache, *, device=None) -> dict:
    """A ``repro`` decode cache with numpy leaves -> the port's: the same
    per-segment stacked buffers, and ``len`` as a host integer."""
    device = resolve_device(device)
    segs = [[{k: _tensor(v, device) for k, v in blk.items()} for blk in seg]
            for seg in cache["segs"]]
    if len(segs) != len(derive_segments(cfg)):
        raise ValueError(f"{len(segs)} cache segments for "
                         f"{len(derive_segments(cfg))} in {cfg.name}")
    return {"segs": segs, "len": int(cache["len"])}
