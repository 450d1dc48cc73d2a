"""Device meshes: the JAX package's `launch/mesh.py` as `DeviceMesh`
builders.

Single pod: (data=16, model=16) = 256 ranks. Multi-pod: (pod=2, data=16,
model=16) = 512 ranks; the `pod` axis composes with `data` for batch and
FSDP sharding. The axis names are the mesh's `mesh_dim_names`.

A mesh spans the ranks of the default process group, whose size must be
the product of the shape. A caller with many ranks starts the group
first (`torch.distributed.init_process_group` with its backend, address,
rank and world size); for a mesh of one rank `make_mesh` starts a
one-rank group itself when none is running (NCCL on the card, gloo on
the CPU). Every builder is a function, so importing this module starts
nothing.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch.ann.index import resolve_device


def make_mesh(shape, axes, device="cuda") -> DeviceMesh:
    """A `DeviceMesh` of `shape` named `axes` over the default process
    group, on `device`'s type ("cuda", the default, or "cpu"). Without a
    card "cuda" raises RuntimeError."""
    shape, axes = tuple(int(n) for n in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in "
                         f"length")
    dev = resolve_device(device)
    if not dist.is_initialized():
        if math.prod(shape) != 1:
            raise RuntimeError(
                f"a mesh of {math.prod(shape)} ranks needs the default "
                f"process group started first")
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                store=dist.HashStore(), rank=0,
                                world_size=1)
    if math.prod(shape) != dist.get_world_size():
        raise ValueError(f"mesh {shape} needs {math.prod(shape)} ranks; the "
                         f"process group has {dist.get_world_size()}")
    return init_device_mesh(dev.type, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, device="cuda"):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device=device)


@dataclasses.dataclass(frozen=True)
class MeshAxes:
    dp_axes: tuple      # axes batch/FSDP shard over (includes "pod")
    tp_axis: str
    dp_size: int
    tp_size: int


def mesh_axes(mesh: DeviceMesh) -> MeshAxes:
    names = mesh.mesh_dim_names
    tp_axis = "model"
    dp_axes = tuple(n for n in names if n != tp_axis)
    dp_size = 1
    for n in dp_axes:
        dp_size *= mesh.size(names.index(n))
    return MeshAxes(dp_axes=dp_axes, tp_axis=tp_axis, dp_size=dp_size,
                    tp_size=mesh.size(names.index(tp_axis)))


def on_device(mesh: DeviceMesh) -> torch.device:
    """The torch device of this rank's shards."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)
