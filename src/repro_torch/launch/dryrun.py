"""The dry run: every (architecture × input shape × mesh) cell's step,
run as one rank of the production mesh and counted, the JAX package's
`launch/dryrun.py` for the port.

Each cell starts torch's `fake` process group of 256 ranks (the (16, 16)
"pod" mesh) or 512 (the (2, 16, 16) "multipod" mesh), builds
`launch.mesh.make_production_mesh` on it, places the `meta` stand-ins of
`launch.specs` (parameters, optimizer state, batch, cache) by their
partition specs, and runs the cell's train, prefill or decode step as
rank 0 under `launch.step_analysis`: per-rank dot FLOPs, bytes and
collective bytes by kind. Nothing is computed or allocated (the local
shards are `meta` tensors; the fake group's collectives move nothing),
and the group is destroyed when the cell ends. The numbers are a rank's
work, device-independent: no time on any chip is stated.

Repeats. Layers of one kind and microbatches repeat a unit; a cell with
more than three units of layers (one period of xLSTM's block pattern,
one encoder and one decoder layer of whisper, one layer elsewhere) is
counted at two and three units, and one with more than three
microbatches at two and three, and the count is fitted to the cell's
depth and accumulation exactly (`step_analysis.fit_counts`). Two, not
one: the first and the last layer (and microbatch) differ from the
others (the gradient reaching the last layer from the head arrives laid
out otherwise), so the count is affine only from two on. The sLSTM's time steps
run once and count S times (`models.common.uniform_range`).
`argument_size_in_bytes` is the sum of this rank's local shards of the
step's arguments at the cell's full depth, as the reference's
`memory_analysis` reports it: the arguments the step reads (the decode
step's int32 position where an attention reads it; not whisper's
encoder in decode).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-0.5b \\
      --shape decode_32k --mesh pod --device cpu
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --device cpu

Each cell's result (status, counts, the dot FLOPs by op and local
operand shapes, argument bytes, wall seconds) is
cached as JSON under artifacts/dryrun_torch/ (`$REPRO_ARTIFACTS`
respected); `--force` reruns cached cells.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import time
import traceback

import torch

from repro_torch.common import artifacts_dir
from repro_torch.configs.base import (ARCH_IDS, SHAPES, ModelConfig,
                                      ShapeSpec, get_config, shape_supported)
from repro_torch.launch import specs as SP
from repro_torch.launch import step_analysis
from repro_torch.launch import steps as ST
from repro_torch.launch.mesh import make_production_mesh, mesh_axes
from repro_torch.models import common, lm

FSDP_PARAM_THRESHOLD = 3e9   # shard params over data axes above this


OPT_LEVELS = {
    "none": {"ctx": {}, "cfg": {}},
    # activation sharding constraints + sequence-parallel flash decode
    "v1": {"ctx": {"opt_acts": True, "opt_flash_decode": True}, "cfg": {}},
    # + a query chunk of 512 in training and microbatches of 4 sequences
    "v2": {"ctx": {"opt_acts": True, "opt_flash_decode": True,
                   "qc_train": 512},
           "cfg": {"microbatch_seqs": 4}},
    # + microbatches of 2 sequences
    "v3": {"ctx": {"opt_acts": True, "opt_flash_decode": True,
                   "qc_train": 512},
           "cfg": {"microbatch_seqs": 2}},
}


def _apply_opt_cfg(cfg: ModelConfig, opt: str) -> ModelConfig:
    over = dict(OPT_LEVELS[opt]["cfg"])
    if over.get("microbatch_seqs") and \
            cfg.microbatch_seqs >= over["microbatch_seqs"]:
        over.pop("microbatch_seqs")        # only raise, never lower
    return dataclasses.replace(cfg, **over) if over else cfg


def build_ctx(mesh, axes, shape, opt: str = "none") -> lm.ModelCtx:
    del shape
    kw = {"qc_train": 1024, "qc_prefill": 256, "gla_chunk": 256}
    kw.update(OPT_LEVELS[opt]["ctx"])
    return lm.ModelCtx(mesh=mesh, tp_axis=axes.tp_axis,
                       dp_axes=axes.dp_axes, tp_size=axes.tp_size,
                       dp_size=axes.dp_size, **kw)


@contextlib.contextmanager
def fake_group(world: int):
    """torch's `fake` process group of `world` ranks, this process rank
    0, destroyed on exit (so no later code sees it)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("the dry run starts its own fake process group; "
                           "one is already running")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _stand_in(t, spec, mesh):
    """`t`'s rank-0 shard by `spec` on `mesh`: a DTensor over a `meta`
    local tensor."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset

    place = common.placements(spec, mesh)
    shape, _ = compute_local_shape_and_global_offset(t.shape, mesh, place)
    local = torch.empty(shape, dtype=t.dtype, device="meta")
    return DTensor.from_local(local, mesh, place, run_check=False,
                              shape=t.shape, stride=t.stride())


def _placed(structs, specs, mesh):
    return common.tree_unflatten(structs, iter(
        _stand_in(t, s, mesh) for t, s in zip(common.tree_leaves(structs),
                                               common.tree_leaves(specs))))


def _local_bytes(tree) -> int:
    """The bytes of this rank's shards of a tree's tensors."""
    total = 0
    for t in common.tree_leaves(tree):
        local = t.to_local() if common.is_dtensor(t) else t
        total += local.numel() * local.element_size()
    return total


def _units(cfg: ModelConfig):
    """(units, decoder layers a unit, encoder layers a unit): the period
    of layers the model repeats, and how many times."""
    if cfg.block_pattern:
        period = len(cfg.block_pattern)
        if cfg.n_layers % period:
            return 1, cfg.n_layers, cfg.encoder_layers
        return cfg.n_layers // period, period, 0
    if cfg.encoder_layers:
        g = math.gcd(cfg.n_layers, cfg.encoder_layers)
        return g, cfg.n_layers // g, cfg.encoder_layers // g
    return cfg.n_layers, 1, 0


def _cut(cfg: ModelConfig, units: int) -> ModelConfig:
    _, dec, enc = _units(cfg)
    return dataclasses.replace(cfg, n_layers=units * dec,
                               encoder_layers=units * enc)


def _step(cfg: ModelConfig, shape: ShapeSpec, mesh, ctx, *, fsdp: bool,
          accum: int | None = None):
    """(run, argument bytes): `run()` runs the cell's step once on the
    stand-ins; a train step with `accum` microbatches of the cell's size
    (the global batch scaled to match)."""
    axes = mesh_axes(mesh)
    param_sds, desc = SP.param_structs(cfg)
    params = _placed(param_sds, SP.param_partition(desc, axes, fsdp=fsdp),
                     mesh)
    if shape.kind == "train":
        full = ST.accum_steps(cfg, shape, axes.dp_size)
        accum = accum or full
        rows = shape.global_batch // full * accum
        shape = dataclasses.replace(shape, global_batch=rows)
        opt_cfg = ST.default_opt_cfg(cfg)
        opt_desc = SP.opt_structs(desc, cfg, opt_cfg)
        opt = _placed(common.shape_structs(opt_desc),
                      SP.param_partition(opt_desc, axes, fsdp=fsdp), mesh)
        opt["step"] = torch.zeros((), dtype=torch.int32)
        batch = _placed(SP.batch_specs(cfg, shape),
                        SP.batch_partition(cfg, shape, axes), mesh)
        step = ST.make_train_step(cfg, ctx, accum=accum, opt_cfg=opt_cfg)
        return (lambda: step(params, opt, batch)), \
            _local_bytes([params, opt, batch])
    if shape.kind == "prefill":
        batch = _placed(SP.batch_specs(cfg, shape),
                        SP.batch_partition(cfg, shape, axes), mesh)
        step = ST.make_prefill_step(cfg, ctx)

        def run():
            with torch.no_grad():
                return step(params, batch)
        return run, _local_bytes([params, batch])
    cache_sds, cache_specs = SP.cache_structs(cfg, shape, axes)
    cache = _placed(cache_sds, cache_specs, mesh)
    tokens = _stand_in(torch.empty((shape.global_batch, 1), dtype=torch.int32,
                                   device="meta"),
                       SP.batch_partition(cfg, shape, axes)["tokens"], mesh)
    step = ST.make_decode_step(cfg, ctx)

    def run():
        # position 0: rank 0 holds it, so its count includes the write
        with torch.no_grad():
            return step(params, cache, tokens, 0)
    return run, _local_bytes([_decode_reads(params, cfg), cache, tokens]) \
        + 4 * _reads_position(cfg)


def _decode_reads(params, cfg: ModelConfig):
    """The parameters a decode step reads: not whisper's encoder, nor its
    cross-attention's key and value projections, whose outputs the cache
    holds (the reference's jit prunes arguments its program never
    reads)."""
    if not cfg.encoder_layers:
        return params
    layers = {k: v for k, v in params["layers"].items() if k != "cross"}
    layers["cross"] = {k: v for k, v in params["layers"]["cross"].items()
                       if k not in ("wk", "wv")}
    return {k: v for k, v in params.items()
            if not k.startswith("enc_") and k != "layers"} | \
        {"layers": layers}


def _reads_position(cfg: ModelConfig) -> bool:
    """Whether a decode step reads its int32 position: where an attention
    cache is written (the recurrent layers' states need none)."""
    return bool({"attn", "hymba", "dec"} & set(lm._cache_kinds(cfg)))


def count_cell(cfg: ModelConfig, shape: ShapeSpec, mesh, ctx, *,
               fsdp: bool, repeats: bool = True, fit: bool = True):
    """(the step's `StepSummary` on rank 0 at the cell's full depth and
    accumulation, the argument bytes, the (units, accum) points
    traced). With `fit`, layers and microbatches are counted at two and
    three units and microbatches where the cell has more, and fitted;
    without it, the whole step is traced."""
    axes = mesh_axes(mesh)
    n_units = _units(cfg)[0]
    accum = ST.accum_steps(cfg, shape, axes.dp_size) \
        if shape.kind == "train" else 1
    _, arg_bytes = _step(cfg, shape, mesh, ctx, fsdp=fsdp)
    u_pts = (2, 3) if fit and n_units > 3 else (n_units,)
    a_pts = (2, 3) if fit and accum > 3 else (accum,)
    counts = {}
    for u in u_pts:
        for a in a_pts:
            run, _ = _step(_cut(cfg, u), shape, mesh, ctx, fsdp=fsdp,
                           accum=a)
            counts[(u, a)] = step_analysis.analyze(run, repeats=repeats)[1]
    if len(counts) == 1:
        summary = next(iter(counts.values()))
    elif len(u_pts) == 2 and len(a_pts) == 2:
        summary = step_analysis.fit_counts(counts, (n_units, accum))
    elif len(u_pts) == 2:
        summary = step_analysis.fit_counts(
            {(u,): s for (u, _), s in counts.items()}, (n_units,))
    else:
        summary = step_analysis.fit_counts(
            {(a,): s for (_, a), s in counts.items()}, (accum,))
    return summary, arg_bytes, sorted(counts)


def _cell(arch: str, shape_name: str, multi_pod: bool, opt: str, device):
    """(cfg, shape, mesh, ctx, meta) of one cell; inside `fake_group`."""
    cfg = _apply_opt_cfg(get_config(arch), opt)
    shape = SHAPES[shape_name]
    mesh = make_production_mesh(multi_pod=multi_pod, device=device)
    axes = mesh_axes(mesh)
    n_params = common.count_params(SP.param_structs(cfg)[1])
    meta = {"arch": arch, "shape": shape_name,
            "mesh": "2x16x16" if multi_pod else "16x16",
            "n_params": n_params, "fsdp": n_params > FSDP_PARAM_THRESHOLD,
            "family": cfg.family, "device": device}
    if shape.kind == "train":
        meta["accum_steps"] = ST.accum_steps(cfg, shape, axes.dp_size)
    return cfg, shape, mesh, build_ctx(mesh, axes, shape, opt), meta


def lower_cell(arch: str, shape_name: str, multi_pod: bool,
               opt: str = "none", *, device="cuda"):
    """(run, meta) for one cell at full depth: `run()` runs its step once
    on the stand-ins. Call it inside `fake_group` of the mesh's size."""
    cfg, shape, mesh, ctx, meta = _cell(arch, shape_name, multi_pod, opt,
                                        device)
    run, meta["argument_size_in_bytes"] = _step(cfg, shape, mesh, ctx,
                                                fsdp=meta["fsdp"])
    return run, meta


def run_cell(arch: str, shape_name: str, multi_pod: bool, *,
             opt: str = "none", device="cuda") -> dict:
    cfg = _apply_opt_cfg(get_config(arch), opt)
    shape = SHAPES[shape_name]
    ok, reason = shape_supported(cfg, shape)
    mesh_name = "2x16x16" if multi_pod else "16x16"
    if not ok:
        return {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                "status": "skipped", "reason": reason}
    t0 = time.time()
    try:
        with fake_group(512 if multi_pod else 256):
            cfg, shape, mesh, ctx, res = _cell(arch, shape_name, multi_pod,
                                               opt, device)
            summary, arg_bytes, traced = count_cell(cfg, shape, mesh, ctx,
                                                    fsdp=res["fsdp"])
        res["status"] = "ok"
        d = summary.as_dict()
        res.update({"dot_flops": d["dot_flops"], "hbm_bytes": d["hbm_bytes"],
                    "collective_bytes": d["coll_bytes"],
                    "collective_by_kind": d["coll_by_kind"],
                    "n_ops": d["n_ops"],
                    "dot_flops_by_op": d["dot_by_op"],
                    "argument_size_in_bytes": arg_bytes,
                    "traced": [list(p) for p in traced],
                    "wall_s": round(time.time() - t0, 2)})
        return res
    except Exception as e:
        return {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                "status": "error", "error": f"{type(e).__name__}: {e}",
                "traceback": traceback.format_exc()[-2000:],
                "wall_s": round(time.time() - t0, 2)}


def cell_path(arch, shape_name, mesh_name, opt: str = "none"):
    sub = "dryrun_torch" if opt == "none" else f"dryrun_torch_{opt}"
    return os.path.join(artifacts_dir(sub),
                        f"{arch}_{shape_name}_{mesh_name}.json")


def summary_line(res: dict) -> str:
    tag = res["status"]
    extra = ""
    if tag == "ok":
        extra = (f"flops={res['dot_flops']:.4e} "
                 f"bytes={res['hbm_bytes']:.4e} "
                 f"coll={res['collective_bytes']:.4e}B "
                 f"args={res['argument_size_in_bytes']} "
                 f"wall={res['wall_s']}s")
    elif tag == "error":
        extra = res["error"][:160]
    else:
        extra = res.get("reason", "")
    return (f"{tag:8s} {res['arch']:18s} {res['shape']:12s} "
            f"{res['mesh']}: {extra}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="both",
                    choices=["pod", "multipod", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--opt", default="none", choices=list(OPT_LEVELS))
    ap.add_argument("--device", default="cuda",
                    help="the mesh's device type (the local shards are "
                         "meta tensors either way)")
    args = ap.parse_args(argv)

    archs = ARCH_IDS if (args.all or args.arch is None) else [args.arch]
    shapes = list(SHAPES) if (args.all or args.shape is None) \
        else [args.shape]
    meshes = {"pod": [False], "multipod": [True],
              "both": [False, True]}[args.mesh]

    n_ok = n_skip = n_err = 0
    for arch in archs:
        for shape_name in shapes:
            for multi_pod in meshes:
                mesh_name = "2x16x16" if multi_pod else "16x16"
                path = cell_path(arch, shape_name, mesh_name, args.opt)
                if os.path.exists(path) and not args.force:
                    with open(path) as f:
                        prev = json.load(f)
                    if prev.get("status") in ("ok", "skipped"):
                        print(f"cached   {arch:18s} {shape_name:12s} "
                              f"{mesh_name}: {prev['status']}", flush=True)
                        n_ok += prev["status"] == "ok"
                        n_skip += prev["status"] == "skipped"
                        continue
                res = run_cell(arch, shape_name, multi_pod, opt=args.opt,
                               device=args.device)
                with open(path, "w") as f:
                    json.dump(res, f, indent=1)
                n_ok += res["status"] == "ok"
                n_skip += res["status"] == "skipped"
                n_err += res["status"] == "error"
                print(summary_line(res), flush=True)
    print(f"\nDRY-RUN SUMMARY: ok={n_ok} skipped={n_skip} errors={n_err}",
          flush=True)
    return 0 if n_err == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
