"""The port's side of `test_torch_distributed.py` and
`test_torch_mesh_families.py`: one of 4 `gloo` ranks running every mesh
case of the plan in DIR/plan.json (each section optional), from the
inputs the test wrote to DIR/inputs.npz; rank 0 writes the results to
DIR/torch.npz. The ranks meet through a FileStore in DIR.

    python tests/mesh_ranks_torch.py DIR RANK

Each rank runs on one torch thread; the collectives go through a plain
`gloo` process group.
"""

import dataclasses
import datetime
import json
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.ann import distributed
from repro_torch.configs.base import get_smoke_config
from repro_torch.launch import mesh as M
from repro_torch.launch import serve as SV
from repro_torch.launch import specs as SP
from repro_torch.launch import steps as ST
from repro_torch.launch import train as TR
from repro_torch.models import attention as A
from repro_torch.models import common as C
from repro_torch.models import lm

WORLD = 4


def main(root: str, rank: int) -> None:
    torch.set_num_threads(1)
    with open(os.path.join(root, "plan.json")) as f:
        plan = json.load(f)
    inp = dict(np.load(os.path.join(root, "inputs.npz")))
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(root, "store"), WORLD),
        rank=rank, world_size=WORLD, timeout=datetime.timedelta(seconds=120))
    out = {}

    def cfg_of(case):
        return dataclasses.replace(get_smoke_config(case["arch"]),
                                   compute_dtype="float32",
                                   **case.get("cfg", {}))

    def params_of(name, cfg):
        desc = lm.model_desc(cfg)
        n = len(C.tree_leaves(desc))
        leaves = iter(inp[f"{name}/p{i:04d}"] for i in range(n))
        return C.params_from_numpy(C.tree_unflatten(desc, leaves),
                                   device="cpu"), desc

    def mesh_of(case):
        shape = tuple(case["mesh"])
        names = ("pod", "data", "model")[-len(shape):]
        return M.make_mesh(shape, names, device="cpu")

    def batch_of(key):
        return {k: torch.from_numpy(inp[f"{key}/{k}"].copy())
                for k in ("tokens", "targets", "enc_inputs")
                if f"{key}/{k}" in inp}

    def serving(params, desc, mesh):
        return C.tree_unflatten(params, iter(
            C.distribute(t, s, mesh) for t, s in zip(
                C.tree_leaves(params), C.tree_leaves(SP.param_partition(
                    desc, M.mesh_axes(mesh), fsdp=False)))))

    def record(prefix, tree):
        for i, leaf in enumerate(C.tree_leaves(tree)):
            leaf = leaf.full_tensor() if C.is_dtensor(leaf) else leaf
            out[f"{prefix}/{i:04d}"] = leaf.numpy().copy()

    for name, case in plan.get("train", {}).items():
        cfg = cfg_of(case)
        params, desc = params_of(name, cfg)
        mesh = mesh_of(case)
        ctx = lm.mesh_ctx(mesh, qc_train=16, gla_chunk=16,
                          opt_acts=case.get("opt_acts", False))
        opt_cfg = dataclasses.replace(ST.default_opt_cfg(cfg),
                                      **case.get("opt", {}))
        params, opt = TR.place_state(params, ST.adam_init(params, opt_cfg),
                                     cfg, opt_cfg, mesh)
        if case.get("forward"):
            _, met = lm.forward_train(params, TR.place_batch(
                cfg, batch_of(f"{name}/b0"), mesh), cfg, ctx)
            out[f"{name}/fwd_loss"] = met["loss"].full_tensor().numpy()
            out[f"{name}/fwd_aux"] = met["aux"].full_tensor().numpy()
        step = ST.make_train_step(cfg, ctx, accum=case["accum"],
                                  opt_cfg=opt_cfg)
        for i in range(case["steps"]):
            params, opt, met = step(params, opt, TR.place_batch(
                cfg, batch_of(f"{name}/b{i}"), mesh))
            out[f"{name}/s{i}/loss"] = met["loss"].numpy()
            out[f"{name}/s{i}/grad_norm"] = met["grad_norm"].numpy()
            record(f"{name}/s{i}/params", params)
            record(f"{name}/s{i}/mu", opt["mu"])
        if name == plan.get("reshard", {}).get("from"):
            full = lambda t: t.full_tensor().clone()
            host_p = C.map_descs(full, params)
            host_o = {"step": opt["step"], "mu": C.map_descs(full, opt["mu"]),
                      "nu": C.map_descs(full, opt["nu"])}
            rcase = plan["reshard"]
            mesh2 = mesh_of(rcase)
            params2, opt2 = TR.place_state(host_p, host_o, cfg, opt_cfg,
                                           mesh2)
            _, _, met = ST.make_train_step(
                cfg, lm.mesh_ctx(mesh2, qc_train=16, gla_chunk=16),
                accum=case["accum"])(params2, opt2, TR.place_batch(
                    cfg, batch_of("reshard/b0"), mesh2))
            out["reshard/loss"] = met["loss"].numpy()
            out["reshard/grad_norm"] = met["grad_norm"].numpy()

    if "decode" in plan:
        flash_decode(plan["decode"], out, inp, params_of, cfg_of, mesh_of)
    if "generate" in plan:
        gcase = plan["generate"]
        cfg = cfg_of(gcase)
        params, desc = params_of("generate", cfg)
        mesh = mesh_of(gcase)
        out["generate/tokens"] = SV.generate(
            serving(params, desc, mesh), cfg,
            [list(map(int, r)) for r in inp["generate/prompts"]],
            max_new=gcase["max_new"],
            ctx=lm.mesh_ctx(mesh, qc_prefill=64, gla_chunk=64))

    for name, scase in plan.get("search", {}).items():
        mesh = mesh_of(scase)
        axes = tuple(scase["data_axes"])
        fn = distributed.make_sharded_search(mesh, k=scase["k"],
                                             data_axes=axes)
        base = [distributed.shard_rows(inp[f"search/{n}"], mesh, axes)
                for n in ("vectors", "norms", "bitmaps")]
        for p in range(3):
            out[f"search/{name}/{p}"] = fn(
                inp[f"search/q{p}"], inp[f"search/b{p}"], p,
                *base).numpy()

    if "loop" in plan:
        train_loops(plan["loop"], out, root, rank, cfg_of, mesh_of)

    # the recurrent and encoder-decoder families: a train step, prefill
    # and greedy decode steps on the mesh
    for name, case in plan.get("families", {}).items():
        cfg = cfg_of(case)
        params, desc = params_of(name, cfg)
        mesh = mesh_of(case)
        opt_cfg = ST.default_opt_cfg(cfg)
        tparams, opt = TR.place_state(params, ST.adam_init(params, opt_cfg),
                                      cfg, opt_cfg, mesh)
        _, _, met = ST.make_train_step(
            cfg, lm.mesh_ctx(mesh, qc_train=16, gla_chunk=16), accum=1,
            opt_cfg=opt_cfg)(tparams, opt, TR.place_batch(
                cfg, batch_of(f"{name}/b0"), mesh))
        out[f"{name}/loss"] = met["loss"].numpy()
        out[f"{name}/grad_norm"] = met["grad_norm"].numpy()
        ctx = lm.mesh_ctx(mesh, qc_prefill=8, gla_chunk=8)
        sparams = serving(params, desc, mesh)
        prompt = batch_of(f"{name}/prompt")
        plen = case["prompt_len"]
        b, s_max = prompt["tokens"].shape
        logits, cache = lm.forward_prefill(
            sparams, {k: SV._rows(v, ctx) for k, v in prompt.items()}, cfg,
            ctx, prompt_len=plen)
        cache = SV._place_cache(cache, cfg, ctx, b, s_max)
        toks = []
        for i in range(case["steps"]):
            out[f"{name}/logits{i}"] = logits.full_tensor().numpy()
            nxt = torch.argmax(logits.full_tensor()[:, -1], dim=-1)
            toks.append(nxt.numpy())
            logits, cache = lm.forward_decode(
                sparams, cache, SV._rows(nxt[:, None], ctx), plen + i, cfg,
                ctx)
        out[f"{name}/logits{case['steps']}"] = logits.full_tensor().numpy()
        out[f"{name}/tokens"] = np.stack(toks, axis=1)

    dist.barrier()
    if rank == 0:
        np.savez(os.path.join(root, "torch.npz"), **out)
    dist.destroy_process_group()


def flash_decode(dcase, out, inp, params_of, cfg_of, mesh_of):
    """The sequence-parallel flash decode, counted where it runs."""
    cfg = cfg_of(dcase)
    params, desc = params_of("decode", cfg)
    mesh = mesh_of(dcase)
    ctx = lm.mesh_ctx(mesh, qc_prefill=64, gla_chunk=64,
                      opt_flash_decode=True)
    params = C.tree_unflatten(params, iter(
        C.distribute(t, s, mesh) for t, s in zip(
            C.tree_leaves(params), C.tree_leaves(SP.param_partition(
                desc, M.mesh_axes(mesh), fsdp=False)))))
    flash = A.gqa_decode_flash
    calls = []

    def counted(*args, **kw):
        calls.append(1)
        return flash(*args, **kw)

    A.gqa_decode_flash = counted
    try:
        plen = dcase["prompt_len"]
        toks = torch.from_numpy(inp["decode/tokens"].astype(np.int64))
        logits, cache = lm.forward_prefill(
            params, {"tokens": SV._rows(toks, ctx)}, cfg, ctx,
            prompt_len=plen)
        cache = SV._place_cache(cache, cfg, ctx, toks.shape[0],
                                toks.shape[1])
        out["decode/logits0"] = logits.full_tensor().numpy()
        for i in range(dcase["steps"]):
            nxt = torch.argmax(logits.full_tensor()[:, -1], dim=-1)
            logits, cache = lm.forward_decode(
                params, cache, SV._rows(nxt[:, None], ctx), plen + i, cfg,
                ctx)
            out[f"decode/logits{i + 1}"] = logits.full_tensor().numpy()
        out["decode/k_placements"] = np.array(
            [str(p) for p in cache["k"].placements])
    finally:
        A.gqa_decode_flash = flash
    out["decode/flash_calls"] = np.array(len(calls))


def train_loops(tcase, out, root, rank, cfg_of, mesh_of):
    """`train_loop` on a mesh: checkpoints saved from DTensors (rank 0
    writes), a run resumed onto another mesh, one device alongside."""
    cfg = cfg_of(tcase)
    kw = dict(steps=tcase["steps"], global_batch=tcase["batch"][0],
              seq_len=tcase["batch"][1], save_every=tcase["save_every"],
              verbose=False, device="cpu", accum=tcase["accum"])
    ck = os.path.join(root, "ck")
    _, _, whole = TR.train_loop(cfg, mesh=mesh_of({"mesh": [2, 2]}), **kw)
    TR.train_loop(cfg, mesh=mesh_of({"mesh": [2, 2]}), ckpt_dir=ck,
                  **dict(kw, steps=tcase["save_every"]))
    _, _, resumed = TR.train_loop(cfg, mesh=mesh_of({"mesh": [1, 4]}),
                                  ckpt_dir=ck, **kw)
    out["loop/mesh"] = np.array([h["loss"] for h in whole])
    out["loop/resumed"] = np.array([h["loss"] for h in resumed])
    if rank == 0:
        _, _, one = TR.train_loop(cfg, **kw)
        out["loop/one"] = np.array([h["loss"] for h in one])


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]))
