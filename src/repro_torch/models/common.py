"""Parameter descriptors + shared layer math.

Every model declares its parameters as a tree (nested dicts and tuples)
of `ParamDesc` — shape, dtype, initialisation, and which dimension the
JAX package shards over its tensor-parallel ("model") and FSDP ("data")
mesh axes. From one descriptor tree the port derives real initialised
parameters (`init_params`) and counts (`count_params`); the JAX
package's `shape_structs` and `partition_specs` describe XLA sharding
and wait for the mesh level (ROADMAP.md queue 1 item 3).

`params_from_numpy` carries the JAX package's parameters across: both
packages' trees have the same keys, the layers stacked `[L, ...]`.

The layer math keeps the JAX package's cast points: `rms_norm` and
`layer_norm` normalise in fp32 and cast back to the input's dtype before
the scale; `apply_rope` rotates in fp32 and casts back.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch

from repro_torch.ann.index import resolve_device


@dataclasses.dataclass(frozen=True)
class ParamDesc:
    shape: tuple
    dtype: Any = torch.float32
    tp: int | None = None       # dim the JAX package shards over "model"
    fsdp: int | None = None     # dim the JAX package shards over "data"
    scale: float | None = None  # init std; default fan-in
    zero: bool = False          # zero-init (biases, norm offsets...)
    one: bool = False           # ones-init (norm scales)


def is_desc(x) -> bool:
    return isinstance(x, ParamDesc)


def map_descs(fn, tree):
    """`fn` over every leaf of a tree of dicts and tuples (a leaf is
    anything else: a `ParamDesc`, a tensor, an array)."""
    if isinstance(tree, dict):
        return {k: map_descs(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(map_descs(fn, v) for v in tree)
    return fn(tree)


def tree_leaves(tree) -> list:
    """The leaves in `jax.tree.flatten`'s order: dict keys sorted, tuple
    and list items in order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_unflatten(tree, leaves):
    """`tree`'s structure with `leaves` (an iterator, in `tree_leaves`
    order) in place of its leaves."""
    if isinstance(tree, dict):
        filled = {k: tree_unflatten(tree[k], leaves) for k in sorted(tree)}
        return {k: filled[k] for k in tree}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_unflatten(v, leaves) for v in tree)
    return next(leaves)


def _torch_dtype(dt) -> torch.dtype:
    return dt if isinstance(dt, torch.dtype) else getattr(torch, str(dt))


# ---- derivations -----------------------------------------------------------

def init_std(d: ParamDesc) -> float:
    """A drawn leaf's std: `scale`, else 1/sqrt(fan-in) as the JAX
    package computes it (a stacked leaf's fan-in counts its layer dim)."""
    if d.scale is not None:
        return d.scale
    return 1.0 / math.sqrt(d.shape[0] if len(d.shape) <= 2
                           else np.prod(d.shape[:-1]))


def init_params(tree, *, seed: int, device="cuda", dtype=None):
    """Initialised parameters for a descriptor tree, on `device`.

    Leaves are drawn in `jax.tree.flatten`'s order from one CPU
    `torch.Generator(seed)` (fp32 normals times `init_std`), then cast to
    `dtype` (default: the leaf's) and moved to `device`, so the card and
    the CPU get identical weights from one seed. `one` and `zero` leaves
    draw nothing. The JAX package draws with `jax.random`, which torch
    does not reproduce: to compare with it, carry its parameters across
    with `params_from_numpy`. `device="cuda"` without a card raises.
    """
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(int(seed))
    out = []
    for d in tree_leaves(tree):
        dt = _torch_dtype(dtype or d.dtype)
        if d.one:
            t = torch.ones(d.shape, dtype=dt)
        elif d.zero:
            t = torch.zeros(d.shape, dtype=dt)
        else:
            t = torch.randn(d.shape, generator=gen, dtype=torch.float32)
            t = t.mul_(np.float32(init_std(d))).to(dt)
        out.append(t.to(dev))
    return tree_unflatten(tree, iter(out))


def params_from_numpy(tree, device="cuda"):
    """The JAX package's parameter tree, taken as numpy arrays
    (`jax.tree.map(np.asarray, params)`), as the port's tree of tensors
    on `device`: the same keys, the layers stacked `[L, ...]`, each
    array's dtype kept (bfloat16 arrays too)."""
    dev = resolve_device(device)

    def one(a):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            t = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
        else:
            t = torch.from_numpy(np.ascontiguousarray(a).copy())
        return t.to(dev)

    return map_descs(one, tree)


def count_params(tree) -> int:
    return sum(int(np.prod(d.shape)) for d in tree_leaves(tree))


# ---- layer math -------------------------------------------------------------

def cast_floats(tree, dtype):
    """Cast all floating leaves to `dtype` (params -> compute dtype); a
    leaf already in `dtype` is returned as it is, not copied."""
    dt = _torch_dtype(dtype)
    return map_descs(lambda p: p.to(dt) if p.is_floating_point() else p,
                     tree)


def rms_norm(x, scale, eps=1e-5):
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * scale.to(x.dtype)


def layer_norm(x, scale, bias, eps=1e-5):
    x32 = x.float()
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x32 - mu), dim=-1, keepdim=True)
    return ((x32 - mu) * torch.rsqrt(var + eps)).to(x.dtype) * scale + bias


def rope_freqs(head_dim: int, theta: float, device=None):
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x, positions, theta: float = 1e4):
    """x [..., S, H, hd]; positions [..., S] integers."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, device=x.device)          # [hd/2]
    ang = positions[..., None].float() * freqs              # [..., S, hd/2]
    cos = torch.cos(ang)[..., None, :]                      # [..., S, 1, hd/2]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)
