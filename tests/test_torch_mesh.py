"""The port's mesh descriptions against the JAX package's, on the CPU: the
parameter, optimizer, batch and decode-cache partition specs of all ten
configurations on both production meshes ((16, 16) and (2, 16, 16)),
leaf by leaf; the meta-device stand-ins against the reference's
ShapeDtypeStructs; `make_production_mesh` and `mesh_axes` under the fake
process group; and `placements`, the spec-to-DTensor translation.

The reference's `MeshAxes` is built directly, so the JAX side needs no
devices. Nothing here draws random numbers. The file holds fewer than
34 tests on purpose: the full test command (`pytest -n 6 --dist
loadfile`) queues files by test count, and a file of 34 or more enters
that queue ahead of the reference's `tests/test_live_fused.py`, whose
`test_label_prune_parity_under_churn` fails `[1]`, `[2]` or both by
what ran before it on its worker (ROADMAP.md queue 3 item 1).
"""

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import PartitionSpec as JP

from repro.configs import base as jconfigs
from repro.launch import specs as JSP
from repro.launch.mesh import MeshAxes as JMeshAxes
from repro.optim import AdamConfig as JAdamConfig
from repro_torch.configs import base as tconfigs
from repro_torch.launch import mesh as TM
from repro_torch.launch import specs as TSP
from repro_torch.models import common as TC
from repro_torch.optim import AdamConfig as TAdamConfig

ARCH_IDS = jconfigs.ARCH_IDS
MESHES = {"16x16": (("data", "model"), (16, 16)),
          "2x16x16": (("pod", "data", "model"), (2, 16, 16))}


def _axes(mesh_id):
    names, shape = MESHES[mesh_id]
    dp = tuple(n for n in names if n != "model")
    size = dict(zip(names, shape))
    dp_size = int(np.prod([size[n] for n in dp]))
    return (JMeshAxes(dp_axes=dp, tp_axis="model", dp_size=dp_size,
                      tp_size=size["model"]),
            TM.MeshAxes(dp_axes=dp, tp_axis="model", dp_size=dp_size,
                        tp_size=size["model"]))


def _jleaves(tree) -> dict:
    """{path: leaf} of a JAX tree, PartitionSpecs as leaves."""
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, JP))
    key = lambda k: str(getattr(k, "key", getattr(k, "idx", k)))
    return {"/".join(key(k) for k in path): leaf for path, leaf in flat}


def _tleaves(tree, prefix=()) -> dict:
    """{path: leaf} of a port tree (dict keys and tuple indices)."""
    if isinstance(tree, dict):
        return {p: v for k in tree for p, v in _tleaves(tree[k],
                                                        prefix + (k,)).items()}
    if isinstance(tree, (tuple, list)) and not isinstance(tree,
                                                          TC.PartitionSpec):
        return {p: v for i, t in enumerate(tree)
                for p, v in _tleaves(t, prefix + (i,)).items()}
    return {"/".join(str(p) for p in prefix): tree}


def _same_specs(jtree, ttree) -> int:
    j, t = _jleaves(jtree), _tleaves(ttree)
    assert sorted(j) == sorted(t)
    for path, spec in j.items():
        assert isinstance(t[path], TC.PartitionSpec), path
        assert tuple(t[path]) == tuple(spec), (path, t[path], spec)
    # the port's leaf order is the reference's flatten order
    assert [tuple(s) for s in TC.tree_leaves(ttree)] == \
        [tuple(s) for s in jax.tree.leaves(jtree,
                                           is_leaf=lambda x: isinstance(x, JP))]
    return len(j)


def _same_structs(jtree, ttree) -> None:
    j, t = _jleaves(jtree), _tleaves(ttree)
    assert sorted(j) == sorted(t)
    for path, s in j.items():
        assert t[path].device.type == "meta", path
        assert tuple(t[path].shape) == tuple(s.shape), path
        assert str(t[path].dtype).replace("torch.", "") == str(s.dtype), path


@pytest.mark.parametrize("mesh_id", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_partitions_match_reference(arch, mesh_id):
    """Parameter specs with and without FSDP and their stand-ins; the
    optimizer state's specs and stand-ins with fp32 and 8-bit moments;
    every input shape's batch specs and stand-ins; the decode cache's
    specs and stand-ins of every decode shape the config supports."""
    import repro.models.common as JC

    jcfg, tcfg = jconfigs.get_config(arch), tconfigs.get_config(arch)
    jaxes, taxes = _axes(mesh_id)
    jstructs, jdesc = JSP.param_structs(jcfg)
    tstructs, tdesc = TSP.param_structs(tcfg)
    _same_structs(jstructs, tstructs)
    for fsdp in (True, False):
        n = _same_specs(JSP.param_partition(jdesc, jaxes, fsdp=fsdp),
                        TSP.param_partition(tdesc, taxes, fsdp=fsdp))
        assert n == len(jax.tree.leaves(jstructs))
    for compress in (False, True):
        jo = JSP.opt_structs(jdesc, jcfg, JAdamConfig(compress=compress))
        to = TSP.opt_structs(tdesc, tcfg, TAdamConfig(compress=compress))
        _same_specs(JSP.param_partition(jo, jaxes, fsdp=True),
                    TSP.param_partition(to, taxes, fsdp=True))
        _same_structs(JC.shape_structs(jo), TC.shape_structs(to))
    decodes = 0
    for name, jshape in jconfigs.SHAPES.items():
        tshape = tconfigs.SHAPES[name]
        _same_specs(JSP.batch_partition(jcfg, jshape, jaxes),
                    TSP.batch_partition(tcfg, tshape, taxes))
        _same_structs(JSP.batch_specs(jcfg, jshape),
                      TSP.batch_specs(tcfg, tshape))
        if jshape.kind != "decode" or not jconfigs.shape_supported(
                jcfg, jshape)[0]:
            continue
        jstructs, jspecs = JSP.cache_structs(jcfg, jshape, jaxes)
        tstructs, tspecs = TSP.cache_structs(tcfg, tshape, taxes)
        _same_specs(jspecs, tspecs)
        _same_structs(jstructs, tstructs)
        decodes += 1
    assert decodes >= 1


@pytest.fixture
def fake_world():
    """A fake process group of `size` ranks, destroyed after the test."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    def start(size):
        if dist.is_initialized():
            dist.destroy_process_group()
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=size)
    yield start
    if dist.is_initialized():
        dist.destroy_process_group()


@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_mesh(fake_world, multi_pod):
    names, shape = MESHES["2x16x16" if multi_pod else "16x16"]
    fake_world(int(np.prod(shape)))
    mesh = TM.make_production_mesh(multi_pod=multi_pod, device="cpu")
    assert mesh.mesh_dim_names == names
    assert tuple(mesh.shape) == shape
    jaxes, taxes = _axes("2x16x16" if multi_pod else "16x16")
    got = TM.mesh_axes(mesh)
    assert got == taxes
    assert (got.dp_axes, got.tp_axis, got.dp_size, got.tp_size) == (
        jaxes.dp_axes, jaxes.tp_axis, jaxes.dp_size, jaxes.tp_size)
    # a multi-axis entry shards over each of its axes, the first outermost
    from torch.distributed.tensor import Replicate, Shard
    spec = TC.PartitionSpec(("pod", "data") if multi_pod else "data",
                            "model")
    want = ((Shard(0),) * (len(names) - 1)) + (Shard(1),)
    assert TC.placements(spec, mesh) == want
    assert TC.placements(TC.PartitionSpec(None, None), mesh) == \
        (Replicate(),) * len(names)
    with pytest.raises(ValueError):
        TC.placements(TC.PartitionSpec("pod", None), TM.make_mesh(
            (int(np.prod(shape)) // 16, 16), ("data", "model"),
            device="cpu"))


def test_make_mesh_checks(fake_world):
    fake_world(4)
    with pytest.raises(ValueError):
        TM.make_mesh((2, 4), ("data", "model"), device="cpu")
    with pytest.raises(ValueError):
        TM.make_mesh((2, 2), ("data",), device="cpu")
    mesh = TM.make_mesh((2, 2), ("data", "model"), device="cpu")
    assert TM.mesh_axes(mesh) == TM.MeshAxes(("data",), "model", 2, 2)
    assert TM.on_device(mesh) == torch.device("cpu")
