"""Parameter descriptors + shared layer math.

Every model declares its parameters as a tree (nested dicts and tuples)
of `ParamDesc` — shape, dtype, initialisation, and which dimension the
tensor-parallel ("model") and FSDP ("data", with "pod") mesh axes shard.
From one descriptor tree the port derives real initialised parameters
(`init_params`), counts (`count_params`), meta-device stand-ins
(`shape_structs`) and partition specs (`partition_specs`): one
`PartitionSpec` a leaf, a tuple with an axis name, a tuple of axis names
or None for each dimension, as the JAX package's. `placements` turns a
spec into a `DeviceMesh`'s DTensor placements and `distribute` places a
tensor by it.

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
    tp: int | None = None       # dim sharded over the "model" axis
    fsdp: int | None = None     # dim sharded over the data(+pod) axes
    scale: float | None = None  # init std; default fan-in
    zero: bool = False          # zero-init (biases, norm offsets...)
    one: bool = False           # ones-init (norm scales)


class PartitionSpec(tuple):
    """One entry a tensor dimension: a mesh axis name, a tuple of names
    (the dimension sharded over each, the first outermost), or None
    (replicated). A leaf of the port's trees, as the JAX package's
    `PartitionSpec`, whose contents it equals."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"


def is_desc(x) -> bool:
    return isinstance(x, ParamDesc)


def map_descs(fn, tree):
    """`fn` over every leaf of a tree of dicts and tuples (a leaf is
    anything else: a `ParamDesc`, a `PartitionSpec`, a tensor, an
    array)."""
    if isinstance(tree, PartitionSpec):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: map_descs(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(map_descs(fn, v) for v in tree)
    return fn(tree)


def tree_leaves(tree) -> list:
    """The leaves in `jax.tree.flatten`'s order: dict keys sorted, tuple
    and list items in order."""
    if isinstance(tree, PartitionSpec):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_unflatten(tree, leaves):
    """`tree`'s structure with `leaves` (an iterator, in `tree_leaves`
    order) in place of its leaves."""
    if isinstance(tree, PartitionSpec):
        return next(leaves)
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


def shape_structs(tree, dtype=None):
    """Each descriptor as an empty tensor of its shape and dtype (or
    `dtype`) on the `meta` device: no memory is allocated."""
    return map_descs(lambda d: torch.empty(
        d.shape, dtype=_torch_dtype(dtype or d.dtype), device="meta"), tree)


def partition_specs(tree, *, tp_axis="model", tp_size: int,
                    fsdp_axes=(), fsdp_size: int = 1):
    """PartitionSpecs honouring divisibility (falls back to replication):
    a leaf's `tp` dimension over `tp_axis` where `tp_size` divides it,
    then its `fsdp` dimension over `fsdp_axes` where `fsdp_size` divides
    it and `tp` did not take it."""

    def spec(d: ParamDesc):
        parts = [None] * len(d.shape)
        if d.tp is not None and tp_size > 1 and d.shape[d.tp] % tp_size == 0:
            parts[d.tp] = tp_axis
        if (d.fsdp is not None and fsdp_axes and fsdp_size > 1
                and d.fsdp != d.tp and parts[d.fsdp] is None
                and d.shape[d.fsdp] % fsdp_size == 0):
            parts[d.fsdp] = fsdp_axes if len(fsdp_axes) > 1 else fsdp_axes[0]
        return PartitionSpec(*parts)

    return map_descs(spec, tree)


def placements(spec, mesh) -> tuple:
    """DTensor placements of `spec` on `mesh`: `Shard(d)` on each mesh
    dimension that the spec names for tensor dimension d, `Replicate()`
    on the others. A dimension named with several axes is sharded over
    each, in the mesh's order of those axes (the JAX package's order
    when the spec lists them as the mesh does). A spec naming an axis
    the mesh lacks raises ValueError."""
    from torch.distributed.tensor import Replicate, Shard

    names = mesh.mesh_dim_names
    out = [Replicate()] * len(names)
    for d, part in enumerate(spec):
        if part is None:
            continue
        for ax in (part if isinstance(part, tuple) else (part,)):
            if ax not in names:
                raise ValueError(f"spec {spec} names axis {ax!r}; the mesh "
                                 f"has {names}")
            out[names.index(ax)] = Shard(d)
    return tuple(out)


def distribute(t, spec, mesh):
    """`t` (the same full tensor on every rank, on any device) as a
    DTensor on `mesh`, sharded by `spec`: each rank copies only its own
    shard to its device (a copy even where the shard is all of `t` on
    that device), and no collective runs."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset

    place = placements(spec, mesh)
    shape, offset = compute_local_shape_and_global_offset(t.shape, mesh,
                                                          place)
    local = t[tuple(slice(o, o + n) for o, n in zip(offset, shape))]
    dev = (torch.device("cuda", torch.cuda.current_device())
           if mesh.device_type == "cuda" else torch.device(mesh.device_type))
    local = local.to(device=dev, memory_format=torch.contiguous_format,
                     copy=True)
    return DTensor.from_local(local, mesh, place,
                              run_check=False, shape=t.shape,
                              stride=t.new_empty(t.shape,
                                                 device="meta").stride())


# ---- mesh layouts -----------------------------------------------------------

def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def on_mesh(ctx) -> bool:
    """Whether `ctx` (a `ModelCtx` or None) carries a mesh."""
    return ctx is not None and getattr(ctx, "mesh", None) is not None


def dp_part(ctx):
    """The batch dimension's spec entry: the data axis, or the tuple of
    data axes on a multi-pod mesh; None off a mesh, and for a batch the
    data axes do not divide (`ModelCtx._shard_batch` off: replicated, as
    `launch.specs.batch_partition` lays it out)."""
    if not on_mesh(ctx) or not ctx._shard_batch:
        return None
    return ctx.dp_axes if len(ctx.dp_axes) > 1 else ctx.dp_axes[0]


def batch_axes(ctx) -> tuple:
    """The mesh axes the batch is sharded over (none where `dp_part` is
    None)."""
    return () if dp_part(ctx) is None else tuple(ctx.dp_axes)


def to_placements(x, place):
    """DTensor `x` redistributed to `place` (returned as it is when it
    has them). A mesh dimension that moves a shard from one tensor
    dimension to another goes through `Replicate()` (an all-gather, then
    a local slice) instead of an all-to-all."""
    from torch.distributed.tensor import Replicate, Shard

    place = tuple(place)
    cur = tuple(x.placements)
    if cur == place:
        return x
    mid = tuple(Replicate() if isinstance(c, Shard) and isinstance(t, Shard)
                and c.dim != t.dim else c for c, t in zip(cur, place))
    if mid != cur:
        x = x.redistribute(x.device_mesh, mid)
    return x.redistribute(x.device_mesh, place)


def constrain(x, ctx, *parts):
    """`x` laid out as `PartitionSpec(*parts)` on `ctx.mesh` (the JAX
    package's `with_sharding_constraint`); a tensor off the mesh is
    returned as it is."""
    if not on_mesh(ctx) or not is_dtensor(x):
        return x
    return to_placements(x, placements(PartitionSpec(*parts), ctx.mesh))


def shard_act(x, ctx, *, tp_last: bool = False):
    """An activation constrained to P(dp, None, ...) when `ctx.opt_acts`
    is on, its last dimension over "model" too with `tp_last` where it
    divides; `x` itself otherwise."""
    if not on_mesh(ctx) or not ctx.opt_acts:
        return x
    spec = [dp_part(ctx)] + [None] * (x.ndim - 1)
    if tp_last and x.shape[-1] % ctx.tp_size == 0:
        spec[-1] = ctx.tp_axis
    return constrain(x, ctx, *spec)


def local_call(ctx, body, ins, in_parts, out_parts, *, vary=()):
    """`body` on each rank's shards (the JAX package's `shard_map`): each
    input in `ins` laid out as its spec in `in_parts` and passed as its
    local tensor, each output taken as this rank's shard of its spec in
    `out_parts` (one spec, or a list of specs for a tuple of outputs).
    Off the mesh, `body(*ins)`.

    Gradients: an input replicated along a mesh axis gets the same
    gradient on every rank of it, right where the body's work is the same
    on every rank of that axis. `vary` names the axes along which the
    body's work differs although an input is replicated along them (its
    outputs are then sharded along each, as a stacked leading dimension
    where the JAX package would `psum` or `pmean`): such an input's
    gradient is the sum over the ranks of those axes."""
    if not on_mesh(ctx):
        return body(*ins)
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map

    mesh = ctx.mesh
    ins = [constrain(t, ctx, *sp) for t, sp in zip(ins, in_parts)]
    # one tensor's placements are a list, several tensors' a tuple of them
    place = lambda sp: list(placements(PartitionSpec(*sp), mesh))
    in_pl = tuple(place(sp) for sp in in_parts)
    names = mesh.mesh_dim_names
    grad_pl = tuple(
        [Partial() if isinstance(p, Replicate) and names[d] in vary else p
         for d, p in enumerate(pl)] for pl in in_pl)
    out_pl = (tuple(place(sp) for sp in out_parts)
              if isinstance(out_parts, list) else place(out_parts))
    return local_map(body, out_placements=out_pl, in_placements=in_pl,
                     in_grad_placements=grad_pl, device_mesh=mesh)(*ins)


def write_at(cache, new, dim: int, pos: int) -> None:
    """Writes `new` (size 1 along `dim`) into `cache` at `pos` along
    `dim`, in place. On a mesh only the rank whose shard holds `pos`
    writes; `new` is first laid out as the cache is, replicated along
    `dim` (a plain tensor counts as replicated)."""
    if not is_dtensor(cache):
        cache.narrow(dim, pos, 1).copy_(new)
        return
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset

    want = tuple(Replicate() if isinstance(p, Shard) and p.dim == dim
                 else p for p in cache.placements)
    if is_dtensor(new):
        new = to_placements(new, want).to_local()
    shape, offset = compute_local_shape_and_global_offset(
        cache.shape, cache.device_mesh, cache.placements)
    if offset[dim] <= pos < offset[dim] + shape[dim]:
        cache.to_local().narrow(dim, pos - offset[dim], 1).copy_(new)


def uniform_range(n: int):
    """range(n), for a loop whose iterations all run the same operations
    on the same shapes. Under a dispatch mode that counts such a loop by
    one iteration (`launch.step_analysis.StepCounter`, which has a
    `uniform_range` method), the mode gives the iterations: with its
    repeats on, the first only, what it does counted n times (the HLO
    analyser's loop trip counts); the values the loop writes are then
    those of its first iteration only."""
    from torch.utils._python_dispatch import _get_current_dispatch_mode_stack

    for mode in _get_current_dispatch_mode_stack():
        loop = getattr(mode, "uniform_range", None)
        if loop is not None:
            return loop(n)
    return range(n)


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
