"""The port's per-rank step counter (`launch/step_analysis.py`), held to
the checks `tests/test_hlo_analysis.py` makes of the JAX package's HLO
analyser: one matmul's FLOPs, a repeated loop multiplied, a nested loop,
no collectives on one rank, the bytes of a product. And two of its own:
on a fake (16, 16) mesh a DTensor product counts the rank's local
product, not the global one `torch.utils.flop_counter` counts; and the
dry run's repeats (the sLSTM's time steps run once and multiplied, the
layers and microbatches fitted from shallower traces) give exactly the
count of a full trace.
"""

import dataclasses

import pytest
import torch
import torch.distributed as dist

from repro_torch.configs.base import ShapeSpec, get_smoke_config
from repro_torch.launch import dryrun as DR
from repro_torch.launch import step_analysis as SA
from repro_torch.launch.mesh import make_production_mesh, mesh_axes
from repro_torch.models.common import uniform_range


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def test_single_matmul_flops():
    a = torch.randn(64, 128, generator=_gen(0))
    b = torch.randn(128, 32, generator=_gen(1))
    out, s = SA.analyze(lambda x, y: x @ y, a, b)
    assert torch.equal(out, a @ b)
    assert s.dot_flops == 2 * 64 * 128 * 32


@pytest.mark.parametrize("repeats", [False, True])
def test_loop_multiplies_flops(repeats):
    a = torch.randn(64, 64, generator=_gen(2)) / 8

    def ten_matmuls(x):
        for _ in uniform_range(10):
            x = x @ x
        return x

    _, s = SA.analyze(ten_matmuls, a, repeats=repeats)
    assert s.dot_flops == 10 * 2 * 64 ** 3
    assert s.n_ops == 10


@pytest.mark.parametrize("repeats", [False, True])
def test_nested_loop_multiplies(repeats):
    a = torch.randn(32, 32, generator=_gen(3)) / 6

    def nested(x):
        for _ in uniform_range(3):
            for _ in uniform_range(4):
                x = x @ x
        return x

    _, s = SA.analyze(nested, a, repeats=repeats)
    assert s.dot_flops == 12 * 2 * 32 ** 3


def test_no_collectives_on_one_rank():
    a = torch.randn(8, 8, generator=_gen(4))
    _, s = SA.analyze(lambda x: x @ x, a)
    assert s.coll_bytes == 0
    assert sum(s.as_dict()["coll_by_kind"].values()) == 0


def test_bytes_positive_and_reasonable():
    n = 512
    a = torch.randn(n, n, generator=_gen(5))
    _, s = SA.analyze(lambda x, y: x @ y, a, a)
    assert s.hbm_bytes >= n * n * 4
    assert s.hbm_bytes < 50 * n * n * 4


@pytest.fixture
def no_group():
    """No default process group before or after the test."""
    if dist.is_initialized():
        dist.destroy_process_group()
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def test_dtensor_product_counts_the_local_product(no_group):
    """[256, 4096] rows over "data" times a [4096, 4096] weight's
    transpose, its rows over "model", on a fake (16, 16) mesh: the rank
    multiplies [16, 4096] by [4096, 256], 3.36e7 FLOPs; FlopCounterMode
    over the DTensors counts the global product, 256 times as many."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.utils.flop_counter import FlopCounterMode

    with DR.fake_group(256):
        mesh = make_production_mesh(device="cpu")
        x = DTensor.from_local(torch.empty(16, 4096, device="meta"), mesh,
                               [Shard(0), Replicate()], run_check=False)
        w = DTensor.from_local(torch.empty(256, 4096, device="meta"), mesh,
                               [Replicate(), Shard(0)], run_check=False)
        y, s = SA.analyze(lambda a, b: a @ b.t(), x, w)
        assert tuple(y.to_local().shape) == (16, 256)
        with FlopCounterMode(display=False) as fc:
            x @ w.t()
    assert s.dot_flops == 2 * 16 * 4096 * 256 == 33_554_432
    assert fc.get_total_flops() == 256 * s.dot_flops
    assert s.coll_bytes == 0


SMALL_TRAIN = ShapeSpec("small_train", 32, 256, "train")   # accum 4


@pytest.mark.parametrize("arch,depth", [
    ("qwen2-0.5b", {"n_layers": 4}),
    ("xlstm-125m", {"n_layers": 16}),
    ("hymba-1.5b", {"n_layers": 4}),
    ("whisper-medium", {"n_layers": 4, "encoder_layers": 4})])
def test_repeats_equal_a_full_trace(no_group, arch, depth):
    """A smoke config at 4 units of layers, a train step of 4
    microbatches on the fake (16, 16) mesh: the dry run's count (layers
    at 2 and 3 units and microbatches at 2 and 3, fitted; the sLSTM's
    steps run once) equals the full trace's, field by field."""
    cfg = dataclasses.replace(get_smoke_config(arch), remat=True, **depth)
    with DR.fake_group(256):
        mesh = make_production_mesh(device="cpu")
        ctx = DR.build_ctx(mesh, mesh_axes(mesh), SMALL_TRAIN)
        ctx = dataclasses.replace(ctx, qc_train=16, gla_chunk=16)
        fitted, args, traced = DR.count_cell(cfg, SMALL_TRAIN, mesh, ctx,
                                             fsdp=False)
        full, args_full, _ = DR.count_cell(cfg, SMALL_TRAIN, mesh, ctx,
                                           fsdp=False, repeats=False,
                                           fit=False)
    assert traced == [(2, 2), (2, 3), (3, 2), (3, 3)]
    assert fitted.as_dict() == full.as_dict()
    assert fitted.dot_flops > 0 and args == args_full
