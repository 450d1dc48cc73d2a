"""The JAX package's side of `test_torch_distributed.py` and
`test_torch_mesh_families.py`: every mesh case of the plan in
DIR/plan.json (each section optional) on 4 forced host devices, from the
inputs the test wrote to DIR/inputs.npz; the results go to DIR/jax.npz.

    python tests/mesh_reference_jax.py DIR

Run with XLA_FLAGS unset: this script sets the device count itself.
"""

import os
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"

import dataclasses  # noqa: E402
import json  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import NamedSharding  # noqa: E402

from repro.ann import distributed  # noqa: E402
from repro.configs.base import get_smoke_config  # noqa: E402
from repro.launch import serve as SV  # noqa: E402
from repro.launch import specs as SP  # noqa: E402
from repro.launch import steps as ST  # noqa: E402
from repro.launch.mesh import make_mesh_compat, mesh_axes  # noqa: E402
from repro.models import common, lm  # noqa: E402
from repro.runtime import elastic_reshard  # noqa: E402


def main(root):
    with open(os.path.join(root, "plan.json")) as f:
        plan = json.load(f)
    inp = dict(np.load(os.path.join(root, "inputs.npz")))
    out = {}

    def cfg_of(case):
        return dataclasses.replace(get_smoke_config(case["arch"]),
                                   compute_dtype="float32",
                                   **case.get("cfg", {}))

    def params_of(name, cfg):
        desc = lm.model_desc(cfg)
        n = len(jax.tree.leaves(common.shape_structs(desc)))
        leaves = [inp[f"{name}/p{i:04d}"] for i in range(n)]
        return jax.tree.unflatten(jax.tree.structure(
            common.shape_structs(desc)), leaves), desc

    def mesh_of(case):
        shape = tuple(case["mesh"])
        names = ("pod", "data", "model")[-len(shape):]
        return make_mesh_compat(shape, names)

    def ctx_of(mesh, **kw):
        axes = mesh_axes(mesh)
        return lm.ModelCtx(mesh=mesh, dp_axes=axes.dp_axes,
                           tp_size=axes.tp_size, dp_size=axes.dp_size, **kw)

    def place(tree, specs, mesh):
        return jax.tree.map(lambda a, s: jax.device_put(
            a, NamedSharding(mesh, s)), tree, specs)

    def batch_of(key):
        return {k: jnp.asarray(inp[f"{key}/{k}"])
                for k in ("tokens", "targets", "enc_inputs")
                if f"{key}/{k}" in inp}

    def record(prefix, tree):
        for i, leaf in enumerate(jax.tree.leaves(tree)):
            out[f"{prefix}/{i:04d}"] = np.asarray(leaf)

    for name, case in plan.get("train", {}).items():
        cfg = cfg_of(case)
        params, desc = params_of(name, cfg)
        mesh = mesh_of(case)
        ctx = ctx_of(mesh, qc_train=16, gla_chunk=16,
                     opt_acts=case.get("opt_acts", False))
        params = place(params, SP.param_partition(desc, mesh_axes(mesh),
                                                  fsdp=True), mesh)
        opt_cfg = dataclasses.replace(ST.default_opt_cfg(cfg),
                                      **case.get("opt", {}))
        opt = ST.adam_init(params, opt_cfg)
        with mesh:
            if case.get("forward"):
                _, met = jax.jit(lambda p, b: lm.forward_train(
                    p, b, cfg, ctx))(params, batch_of(f"{name}/b0"))
                out[f"{name}/fwd_loss"] = np.asarray(met["loss"])
                out[f"{name}/fwd_aux"] = np.asarray(met["aux"])
            step = jax.jit(ST.make_train_step(cfg, ctx, accum=case["accum"],
                                              opt_cfg=opt_cfg))
            for i in range(case["steps"]):
                params, opt, met = step(params, opt,
                                        batch_of(f"{name}/b{i}"))
                out[f"{name}/s{i}/loss"] = np.asarray(met["loss"])
                out[f"{name}/s{i}/grad_norm"] = np.asarray(met["grad_norm"])
                record(f"{name}/s{i}/params", params)
                record(f"{name}/s{i}/mu", opt["mu"])
        if name == plan.get("reshard", {}).get("from"):
            host_p = jax.tree.map(np.asarray, params)
            host_o = jax.tree.map(np.asarray, opt)
            rcase = plan["reshard"]
            mesh2 = mesh_of(rcase)
            ctx2 = ctx_of(mesh2, qc_train=16, gla_chunk=16)
            params2 = elastic_reshard(
                host_p, SP.param_partition(desc, mesh_axes(mesh2),
                                           fsdp=True), mesh2)
            with mesh2:
                _, _, met = jax.jit(ST.make_train_step(
                    cfg, ctx2, accum=case["accum"]))(
                    params2, jax.device_put(host_o), batch_of("reshard/b0"))
            out["reshard/loss"] = np.asarray(met["loss"])
            out["reshard/grad_norm"] = np.asarray(met["grad_norm"])

    if "decode" in plan:
        flash_decode(plan["decode"], out, inp, params_of, cfg_of, mesh_of,
                     ctx_of, place)
    if "generate" in plan:
        gcase = plan["generate"]
        cfg = cfg_of(gcase)
        params, desc = params_of("generate", cfg)
        mesh = mesh_of(gcase)
        params = place(params, SP.param_partition(desc, mesh_axes(mesh),
                                                  fsdp=False), mesh)
        out["generate/tokens"] = SV.generate(
            params, cfg,
            [list(map(int, r)) for r in inp["generate/prompts"]],
            max_new=gcase["max_new"],
            ctx=ctx_of(mesh, qc_prefill=64, gla_chunk=64))

    for name, scase in plan.get("search", {}).items():
        # the same row shards where the reference cannot build the mesh's
        mesh = mesh_of({"mesh": scase.get("ref_mesh", scase["mesh"])})
        fn = distributed.make_sharded_search(
            mesh, k=scase["k"], data_axes=tuple(scase.get(
                "ref_data_axes", scase["data_axes"])))
        for p in range(3):
            out[f"search/{name}/{p}"] = np.asarray(fn(
                inp[f"search/q{p}"], inp[f"search/b{p}"], jnp.int32(p),
                inp["search/vectors"], inp["search/norms"],
                inp["search/bitmaps"]))

    # the recurrent and encoder-decoder families: a train step, prefill
    # and greedy decode steps on the mesh
    for name, case in plan.get("families", {}).items():
        cfg = cfg_of(case)
        params, desc = params_of(name, cfg)
        mesh = mesh_of(case)
        axes = mesh_axes(mesh)
        opt_cfg = ST.default_opt_cfg(cfg)
        tparams = place(params, SP.param_partition(desc, axes, fsdp=True),
                        mesh)
        ctx = ctx_of(mesh, qc_train=16, gla_chunk=16)
        with mesh:
            _, _, met = jax.jit(ST.make_train_step(
                cfg, ctx, accum=1, opt_cfg=opt_cfg))(
                tparams, ST.adam_init(tparams, opt_cfg),
                batch_of(f"{name}/b0"))
        out[f"{name}/loss"] = np.asarray(met["loss"])
        out[f"{name}/grad_norm"] = np.asarray(met["grad_norm"])
        sctx = ctx_of(mesh, qc_prefill=8, gla_chunk=8)
        sparams = place(params, SP.param_partition(desc, axes, fsdp=False),
                        mesh)
        plen = case["prompt_len"]
        toks = []
        with mesh:
            logits, cache = jax.jit(lambda p, b: lm.forward_prefill(
                p, b, cfg, sctx, prompt_len=plen))(
                sparams, batch_of(f"{name}/prompt"))
            decode = jax.jit(lambda p, c, t, pos: lm.forward_decode(
                p, c, t, pos, cfg, sctx))
            for i in range(case["steps"]):
                out[f"{name}/logits{i}"] = np.asarray(logits)
                nxt = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)
                toks.append(np.asarray(nxt))
                logits, cache = decode(sparams, cache, nxt[:, None],
                                       jnp.asarray(plen + i, jnp.int32))
        out[f"{name}/logits{case['steps']}"] = np.asarray(logits)
        out[f"{name}/tokens"] = np.stack(toks, axis=1)

    np.savez(os.path.join(root, "jax.npz"), **out)


def flash_decode(dcase, out, inp, params_of, cfg_of, mesh_of, ctx_of,
                 place):
    """internlm2's decode with the sequence-parallel flash decode."""
    cfg = cfg_of(dcase)
    params, desc = params_of("decode", cfg)
    mesh = mesh_of(dcase)
    ctx = ctx_of(mesh, qc_prefill=64, gla_chunk=64, opt_flash_decode=True)
    params = place(params, SP.param_partition(desc, mesh_axes(mesh),
                                              fsdp=False), mesh)
    plen = dcase["prompt_len"]
    with mesh:
        logits, cache = jax.jit(lambda p, b: lm.forward_prefill(
            p, b, cfg, ctx, prompt_len=plen))(
            params, {"tokens": jnp.asarray(inp["decode/tokens"])})
        decode = jax.jit(lambda p, c, t, pos: lm.forward_decode(
            p, c, t, pos, cfg, ctx))
        out["decode/logits0"] = np.asarray(logits)
        for i in range(dcase["steps"]):
            nxt = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)
            logits, cache = decode(params, cache, nxt[:, None],
                                   jnp.asarray(plen + i, jnp.int32))
            out[f"decode/logits{i + 1}"] = np.asarray(logits)


if __name__ == "__main__":
    main(sys.argv[1])
