"""Model assembly: descriptors, the training forward, prefill and cached
decode of every configuration the JAX package supports — the dense decoders,
MoE and MLA (grok-1, deepseek-v2), the xLSTM stack (sLSTM + mLSTM), the
Hymba hybrid (attention + Mamba heads, ring-buffer KV cache) and the
Whisper-style encoder-decoder.

One descriptor tree (`model_desc`) gives the parameters: the embedding,
the final norm, the head, and the layers — stacked `[L, ...]` when every
layer has one kind, a tuple of per-layer dicts when kinds mix (xLSTM), as
in the JAX package; whisper adds its encoder's stacked layers, positions
and final norm. The forwards loop over the layers in Python where the
JAX package scans. The cache has the same structure: a dict of
`[L, ...]` tensors, or a tuple of per-layer dicts. Decode writes each
step into it in place (attention K/V, MLA's c_kv and k_r, the ring's
slots) and copies each recurrent layer's new state over its old one.

Prefill takes `prompt_len` when the tokens are right-padded to the cache
length, as in the JAX package: recurrent layers mask writes beyond it
(their state must not absorb padding), the Hymba ring holds the window
ending at it, and the logits are taken at prompt_len - 1. Padded rows
still dispatch through an MoE layer and take expert capacity, as there.

The JAX package casts the parameters to the compute dtype inside every
call. The port's forwards call `cast_floats` too, which returns a leaf
already in that dtype as it is; `launch.serve.generate` casts once
before prefill, which gives the same values, so the decode loop moves no
cast (at qwen2-0.5b's full width each would be 3.8 GB of traffic).

On a mesh (`ModelCtx.mesh`, a `DeviceMesh` with a "model" axis and data
axes) the parameters are DTensors placed by their partition specs and
the token batches are sharded over the data axes; the forwards run under
DTensor's `implicit_replication` (plain tensors such as positions and
masks count as replicated), keep the residual stream batch-sharded and
replicated over "model", and run the attention, the embedding lookup,
the MoE layer and the recurrent layers' gates and scans on each rank's
shards (`common.local_call`): every family runs there.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as A
from repro_torch.models import moe as M
from repro_torch.models import ssm as S
from repro_torch.models.common import (ParamDesc, batch_axes, cast_floats,
                                       constrain, dp_part, is_dtensor,
                                       local_call, map_descs, on_mesh,
                                       rms_norm, shard_act, to_placements)


@dataclasses.dataclass(frozen=True)
class ModelCtx:
    """Execution context: mesh + axis names + chunking knobs. `mesh` None
    runs on one device."""
    mesh: Any = None
    tp_axis: str = "model"
    dp_axes: tuple = ("data",)
    tp_size: int = 1
    dp_size: int = 1
    qc_train: int = 1024
    qc_prefill: int = 256
    gla_chunk: int = 256
    # perf knobs, off by default as in the JAX package
    opt_acts: bool = False         # Megatron-style activation constraints
    opt_flash_decode: bool = False # sequence-parallel LSE decode
    # the batch over the data axes; set by the forwards alone
    # (`_for_batch`), off for a batch the data axes do not divide, which
    # is then replicated over them
    _shard_batch: bool = dataclasses.field(default=True, repr=False)


def mesh_ctx(mesh, **kw) -> ModelCtx:
    """The context of `mesh` (its axis names and sizes), with `kw`'s
    knobs."""
    from repro_torch.launch.mesh import mesh_axes

    axes = mesh_axes(mesh)
    return ModelCtx(mesh=mesh, tp_axis=axes.tp_axis, dp_axes=axes.dp_axes,
                    tp_size=axes.tp_size, dp_size=axes.dp_size, **kw)


def _for_batch(ctx: ModelCtx, rows: int) -> ModelCtx:
    """`ctx` for a batch of `rows`: replicated over the data axes where
    they do not divide it (`launch.specs.batch_partition`'s layout)."""
    if on_mesh(ctx) and rows % ctx.dp_size:
        return dataclasses.replace(ctx, _shard_batch=False)
    return ctx


def mesh_mode(ctx):
    """DTensor's `implicit_replication` on a mesh (plain tensors mixed
    with DTensors count as replicated), a no-op off it. The forwards
    enter it themselves; a caller that differentiates through them on a
    mesh runs the backward inside it too."""
    if not on_mesh(ctx):
        return contextlib.nullcontext()
    from torch.distributed.tensor.experimental import implicit_replication

    return implicit_replication()


def _residual(x, ctx: ModelCtx):
    """The residual stream's layout on a mesh: batch over the data axes,
    replicated over "model"."""
    return constrain(x, ctx, dp_part(ctx), None, None)


def _unshard(tree, ctx: ModelCtx):
    """Parameters gathered over the data axes for their use (FSDP's
    all-gather; the gradient's way back is a reduce-scatter), each
    keeping its tensor-parallel shard. Off a mesh, the tree itself."""
    if not on_mesh(ctx):
        return tree
    from torch.distributed.tensor import Replicate

    names = ctx.mesh.mesh_dim_names
    return map_descs(lambda t: to_placements(t, [
        Replicate() if names[d] in ctx.dp_axes else p
        for d, p in enumerate(t.placements)]) if is_dtensor(t) else t, tree)


def _embed(table, tokens, ctx: ModelCtx):
    """The embedding rows of `tokens`. On a mesh each rank looks its
    tokens up in its slice of the vocabulary (where the vocabulary
    divides "model") and the ranks' rows are summed."""
    if not on_mesh(ctx):
        return table[tokens.long()]
    tp, dp = ctx.tp_axis, dp_part(ctx)
    v = table.shape[0]
    vt = tp if ctx.tp_size > 1 and v % ctx.tp_size == 0 else None

    def body(tab, tok):
        tok = tok.long()
        if vt is None:
            return tab[tok]
        lo = ctx.mesh.get_local_rank(tp) * tab.shape[0]
        mine = (tok >= lo) & (tok < lo + tab.shape[0])
        rows = tab[torch.where(mine, tok - lo, 0)]
        return (rows * mine[..., None].to(rows.dtype))[None]

    if vt is None:
        return local_call(ctx, body, [table, tokens], [(None, None),
                                                       (dp, None)],
                          (dp, None, None), vary=batch_axes(ctx))
    x = local_call(ctx, body, [table, tokens], [(tp, None), (dp, None)],
                   (tp, dp, None, None), vary=batch_axes(ctx) + (tp,))
    return _residual(x.sum(0), ctx)


# ---------------------------------------------------------------------------
# layer structure
# ---------------------------------------------------------------------------

def layer_kinds(cfg: ModelConfig) -> tuple:
    if cfg.block_pattern:
        pat = tuple(cfg.block_pattern)
        return tuple(pat[i % len(pat)] for i in range(cfg.n_layers))
    if cfg.encoder_layers:
        return ("dec",) * cfg.n_layers
    if cfg.family == "hybrid":
        return ("hymba",) * cfg.n_layers
    if cfg.family == "ssm":
        return ("mlstm",) * cfg.n_layers
    return ("attn",) * cfg.n_layers


def layer_desc(cfg: ModelConfig, kind: str) -> dict:
    d = cfg.d_model
    ln = lambda: ParamDesc((d,), one=True)
    if kind == "attn":
        p = {"ln1": ln(),
             "attn": A.mla_desc(cfg) if cfg.use_mla else A.gqa_desc(cfg),
             "ln2": ln()}
        if cfg.is_moe:
            p["moe"] = M.moe_desc(cfg)
        else:
            p["mlp"] = M.mlp_desc(cfg)
        return p
    if kind == "mlstm":
        return {"ln1": ln(), "mlstm": S.mlstm_desc(cfg)}
    if kind == "slstm":
        return {"ln1": ln(), "slstm": S.slstm_desc(cfg)}
    if kind == "hymba":
        return {"ln1": ln(), "attn": A.gqa_desc(cfg),
                "mamba": S.mamba_desc(cfg), "ln2": ln(),
                "mlp": M.mlp_desc(cfg)}
    if kind == "enc":   # whisper encoder block (bidirectional, gelu MLP)
        return {"ln1": ln(), "attn": A.gqa_desc(cfg), "ln2": ln(),
                "mlp": M.mlp_desc(cfg, gated=False)}
    if kind == "dec":   # whisper decoder block (self + cross + gelu MLP)
        return {"ln1": ln(), "attn": A.gqa_desc(cfg),
                "lnx": ln(), "cross": A.cross_desc(cfg), "ln2": ln(),
                "mlp": M.mlp_desc(cfg, gated=False)}
    raise ValueError(kind)


def _stack_desc(desc: dict, n: int) -> dict:
    def add_dim(d: ParamDesc) -> ParamDesc:
        return ParamDesc((n,) + d.shape, d.dtype,
                         tp=None if d.tp is None else d.tp + 1,
                         fsdp=None if d.fsdp is None else d.fsdp + 1,
                         scale=d.scale, zero=d.zero, one=d.one)
    return map_descs(add_dim, desc)


def model_desc(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    kinds = layer_kinds(cfg)
    tree: dict = {
        "embed": ParamDesc((cfg.vocab, d), tp=0, fsdp=1, scale=0.02),
        "ln_f": ParamDesc((d,), one=True),
        "head": ParamDesc((d, cfg.vocab), tp=1, fsdp=0),
    }
    if len(set(kinds)) == 1:
        tree["layers"] = _stack_desc(layer_desc(cfg, kinds[0]), cfg.n_layers)
    else:
        tree["layers"] = tuple(layer_desc(cfg, k) for k in kinds)
    if cfg.encoder_layers:
        tree["enc_pos"] = ParamDesc((cfg.encoder_seq, d), scale=0.02, fsdp=0)
        tree["enc_layers"] = _stack_desc(layer_desc(cfg, "enc"),
                                         cfg.encoder_layers)
        tree["enc_ln_f"] = ParamDesc((d,), one=True)
    return tree


def _cache_kinds(cfg: ModelConfig) -> list:
    return ["dec" if cfg.encoder_layers else k for k in layer_kinds(cfg)]


def cache_desc(cfg: ModelConfig, batch: int, s_max: int):
    """The cache's descriptors: stacked `[L, ...]` for one layer kind, a
    tuple of per-layer dicts for mixed kinds (the JAX package's tree)."""
    dt = getattr(torch, cfg.compute_dtype)
    f32 = torch.float32

    def one(kind: str):
        if kind == "attn":
            if cfg.use_mla:
                return {"c_kv": ParamDesc((batch, s_max, cfg.kv_lora_rank),
                                          dt, fsdp=0, tp=1),
                        "k_r": ParamDesc((batch, s_max, cfg.mla_rope_dim),
                                         dt, fsdp=0, tp=1)}
            kv_shardable = cfg.n_kv_heads % 16 == 0
            return {"k": ParamDesc((batch, s_max, cfg.n_kv_heads, cfg.hd), dt,
                                   fsdp=0, tp=2 if kv_shardable else 1),
                    "v": ParamDesc((batch, s_max, cfg.n_kv_heads, cfg.hd), dt,
                                   fsdp=0, tp=2 if kv_shardable else 1)}
        if kind == "dec":
            return {"k": ParamDesc((batch, s_max, cfg.n_kv_heads, cfg.hd), dt,
                                   fsdp=0, tp=2),
                    "v": ParamDesc((batch, s_max, cfg.n_kv_heads, cfg.hd), dt,
                                   fsdp=0, tp=2),
                    "xk": ParamDesc((batch, cfg.encoder_seq, cfg.n_heads,
                                     cfg.hd), dt, fsdp=0, tp=2),
                    "xv": ParamDesc((batch, cfg.encoder_seq, cfg.n_heads,
                                     cfg.hd), dt, fsdp=0, tp=2)}
        if kind == "hymba":
            w = min(cfg.sliding_window or s_max, s_max)
            return {"k": ParamDesc((batch, w, cfg.n_kv_heads, cfg.hd), dt,
                                   fsdp=0),
                    "v": ParamDesc((batch, w, cfg.n_kv_heads, cfg.hd), dt,
                                   fsdp=0),
                    "slot_pos": ParamDesc((w,), torch.int32),
                    "state": ParamDesc(S.mamba_state_shape(cfg, batch), f32,
                                       fsdp=0, tp=1)}
        if kind == "mlstm":
            return {"state": ParamDesc(S.mlstm_state_shape(cfg, batch), f32,
                                       fsdp=0, tp=1)}
        if kind == "slstm":
            z = (batch, cfg.n_heads, cfg.hd)
            return {"c": ParamDesc(z, f32, fsdp=0, tp=1),
                    "n": ParamDesc(z, f32, fsdp=0, tp=1),
                    "h": ParamDesc(z, dt, fsdp=0, tp=1),
                    "m": ParamDesc(z, f32, fsdp=0, tp=1)}
        raise ValueError(kind)

    kinds = _cache_kinds(cfg)
    if len(set(kinds)) == 1:
        return _stack_desc(one(kinds[0]), cfg.n_layers)
    return tuple(one(k) for k in kinds)


def _layer(layers, i: int) -> dict:
    """Layer i's parameters or cache: views of a stacked tree, or the
    tuple's i-th dict."""
    if isinstance(layers, tuple):
        return layers[i]
    return {k: _layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in layers.items()}


def _unstack(layers, n: int) -> list:
    """The n per-layer parameter dicts: of a stacked tree, views from one
    `torch.unbind` a leaf; of a tuple, its dicts."""
    if isinstance(layers, tuple):
        return list(layers)
    per = {k: _unstack(v, n) if isinstance(v, dict) else v.unbind(0)
           for k, v in layers.items()}
    return [{k: v[i] for k, v in per.items()} for i in range(n)]


def _remat(cfg: ModelConfig, fn, x):
    """fn(x), under activation checkpointing where `cfg.remat` is set and
    autograd records through x (serving, whose parameters need no
    gradient, runs fn as it is)."""
    if cfg.remat and torch.is_grad_enabled() and x.requires_grad:
        return checkpoint(fn, x, use_reentrant=False,
                          preserve_rng_state=False)
    return fn(x)


# ---------------------------------------------------------------------------
# block application (training and the encoder)
# ---------------------------------------------------------------------------

def _apply_block(kind: str, lp, x, cfg: ModelConfig, ctx: ModelCtx,
                 positions, enc_kv=None, *, qc: int):
    """Residual block, the JAX package's training math. Returns (x, aux):
    aux the MoE layer's load-balance loss, else 0."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    lp = _unshard(lp, ctx)
    if kind in ("attn", "enc", "dec"):
        h = shard_act(rms_norm(x, lp["ln1"], cfg.norm_eps), ctx)
        if cfg.use_mla:
            y = A.mla_train(lp["attn"], h, cfg, positions, qc=qc, ctx=ctx)
        else:
            y = A.gqa_train(lp["attn"], h, cfg, positions,
                            causal=(kind != "enc"), qc=qc, ctx=ctx)
        x = _residual(shard_act(x + shard_act(y, ctx), ctx), ctx)
        if kind == "dec":
            h = rms_norm(x, lp["lnx"], cfg.norm_eps)
            x = _residual(x + A.cross_attend(lp["cross"], h, enc_kv, cfg,
                                             qc=qc, ctx=ctx), ctx)
        h = shard_act(rms_norm(x, lp["ln2"], cfg.norm_eps), ctx)
        if "moe" in lp:
            y, aux = M.moe_apply(lp["moe"], h, cfg, ctx)
        elif kind == "attn":
            y = M.mlp_apply(lp["mlp"], h, ctx=ctx)
        else:
            y = M.mlp_apply(lp["mlp"], h, gated=False, act=M.gelu, ctx=ctx)
        return _residual(shard_act(x + shard_act(y, ctx), ctx), ctx), aux
    if kind == "mlstm":
        h = rms_norm(x, lp["ln1"], cfg.norm_eps)
        return _residual(x + S.mlstm_train(lp["mlstm"], h, cfg,
                                           chunk=ctx.gla_chunk, ctx=ctx),
                         ctx), aux
    if kind == "slstm":
        h = rms_norm(x, lp["ln1"], cfg.norm_eps)
        y, _ = S.slstm_train(lp["slstm"], h, cfg, ctx=ctx)
        return _residual(x + y, ctx), aux
    if kind == "hymba":
        h = rms_norm(x, lp["ln1"], cfg.norm_eps)
        y_attn = A.gqa_train(lp["attn"], h, cfg, positions, qc=qc, ctx=ctx)
        y_ssm = S.mamba_train(lp["mamba"], h, cfg, chunk=ctx.gla_chunk,
                              ctx=ctx)
        x = _residual(x + 0.5 * (y_attn + y_ssm), ctx)
        h = rms_norm(x, lp["ln2"], cfg.norm_eps)
        return _residual(x + M.mlp_apply(lp["mlp"], h, ctx=ctx), ctx), aux
    raise ValueError(kind)


def _run_layers(params, x, cfg: ModelConfig, ctx: ModelCtx, positions, *,
                qc: int):
    """Every layer in order, each under `_remat`; (x, the summed aux)."""
    aux_tot = torch.zeros((), dtype=torch.float32, device=x.device)
    for kind, lp in zip(layer_kinds(cfg),
                        _unstack(params["layers"], cfg.n_layers)):
        x, aux = _remat(cfg, lambda xx, kind=kind, lp=lp: _apply_block(
            kind, lp, xx, cfg, ctx, positions, qc=qc), x)
        aux_tot = aux_tot + aux
    return x, aux_tot


def _run_layers_encdec(params, x, cfg: ModelConfig, ctx: ModelCtx,
                       positions, enc_out):
    """Whisper's decoder layers over the encoder's output: each layer's
    cross K/V projected inside its (rematerialised) body."""
    aux_tot = torch.zeros((), dtype=torch.float32, device=x.device)
    for lp in _unstack(params["layers"], cfg.n_layers):
        def body(xx, lp=lp):
            kv = A.cross_kv(lp["cross"], enc_out, cfg, ctx)
            return _apply_block("dec", lp, xx, cfg, ctx, positions, kv,
                                qc=ctx.qc_train)
        x, aux = _remat(cfg, body, x)
        aux_tot = aux_tot + aux
    return x, aux_tot


# ---------------------------------------------------------------------------
# whisper's encoder
# ---------------------------------------------------------------------------

def _encode(params, enc_inputs, cfg: ModelConfig, ctx: ModelCtx):
    """Whisper encoder over precomputed frame embeddings [B, S_enc, D]:
    bidirectional attention with the query chunk `ctx.qc_train` (the JAX
    package's; `pick_qc(1500, 1024)` = 750), the ungated GELU MLP; each
    layer under `_remat`."""
    dt = getattr(torch, cfg.compute_dtype)
    x = _residual(enc_inputs.to(dt) + params["enc_pos"].to(dt), ctx)
    positions = torch.arange(x.shape[1], device=x.device)
    for lp in _unstack(params["enc_layers"], cfg.encoder_layers):
        x, _ = _remat(cfg, lambda xx, lp=lp: _apply_block(
            "enc", lp, xx, cfg, ctx, positions, qc=ctx.qc_train), x)
    return rms_norm(x, params["enc_ln_f"], cfg.norm_eps)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def forward_train(params, batch, cfg: ModelConfig, ctx: ModelCtx):
    """batch: {"tokens" [B, S], "targets" [B, S] integer tensors (a target
    < 0 is masked out), and "enc_inputs" [B, S_enc, D] for the
    encoder-decoder}. Returns (total loss, {"loss", "aux", "tokens"}),
    0-d fp32 tensors: the masked mean NLL of the fp32 logits, the summed
    MoE aux loss, the count of unmasked targets; total = loss + 0.01 ·
    aux / n_layers."""
    ctx = _for_batch(ctx, batch["tokens"].shape[0])
    with mesh_mode(ctx):
        return _forward_train(params, batch, cfg, ctx)


def _forward_train(params, batch, cfg: ModelConfig, ctx: ModelCtx):
    tokens = batch["tokens"]
    s = tokens.shape[1]
    params = cast_floats(params, getattr(torch, cfg.compute_dtype))
    x = _embed(params["embed"], tokens, ctx)
    positions = torch.arange(s, device=x.device)
    if cfg.encoder_layers:
        enc_out = _encode(params, batch["enc_inputs"], cfg, ctx)
        x, aux = _run_layers_encdec(params, x, cfg, ctx, positions, enc_out)
    else:
        x, aux = _run_layers(params, x, cfg, ctx, positions,
                             qc=ctx.qc_train)
    x = rms_norm(x, params["ln_f"], cfg.norm_eps)
    logits = x @ _unshard(params["head"], ctx)
    # on a mesh the vocabulary whole on each rank's rows
    logits = constrain(logits, ctx, dp_part(ctx), None, None)
    logp = torch.log_softmax(logits.float(), dim=-1)
    targets = batch["targets"].long()
    mask = (targets >= 0).float()
    nll = -torch.gather(logp, -1, torch.clamp(targets, min=0)[..., None]
                        )[..., 0]
    n_tok = torch.sum(mask)
    loss = torch.sum(nll * mask) / torch.clamp(n_tok, min=1.0)
    total = loss + 0.01 * aux / max(cfg.n_layers, 1)
    return total, {"loss": loss, "aux": aux, "tokens": n_tok}


# ---------------------------------------------------------------------------
# serving: prefill
# ---------------------------------------------------------------------------

def _ffn(lp, x, cfg: ModelConfig, ctx: ModelCtx, *, gated: bool = True):
    """A block's feed-forward half: MoE (its aux loss dropped, as in
    serving), the gated SiLU MLP, or whisper's ungated GELU MLP."""
    h = rms_norm(x, lp["ln2"], cfg.norm_eps)
    if "moe" in lp:
        return _residual(x + M.moe_apply(lp["moe"], h, cfg, ctx)[0], ctx)
    if gated:
        return _residual(x + M.mlp_apply(lp["mlp"], h, ctx=ctx), ctx)
    return _residual(x + M.mlp_apply(lp["mlp"], h, gated=False, act=M.gelu,
                                     ctx=ctx), ctx)


def _ring(c, w: int, s: int, end: int, cfg: ModelConfig, ctx: ModelCtx):
    """The Hymba ring of `w` slots from prefill's K/V over `s` positions:
    slot j holds the latest position p < end with p % w == j; a slot no
    position reaches gets slot_pos 2^30. On a mesh each rank takes its
    own rows and heads of the K/V."""
    dev = c["k"].device
    slots = torch.arange(w, dtype=torch.int64, device=dev)
    start = end - w
    p_j = start + torch.remainder(slots - start, w)
    ring_idx = torch.clamp(p_j, 0, s - 1)
    slot_pos = torch.where((p_j >= 0) & (p_j < end), p_j, 2 ** 30)
    part = (dp_part(ctx), None, A.heads_part(ctx, cfg.n_heads,
                                             cfg.n_kv_heads), None)
    k, v = local_call(ctx, lambda k, v: (k.index_select(1, ring_idx),
                                         v.index_select(1, ring_idx)),
                      [c["k"], c["v"]], [part] * 2, [part] * 2)
    return {"k": k, "v": v, "slot_pos": slot_pos.to(torch.int32)}


def _prefill_block(kind, lp, x, cfg, ctx, positions, valid, prompt_len,
                   enc_out):
    """One layer of prefill: (x, the layer's cache)."""
    s = x.shape[1]
    lp = _unshard(lp, ctx)
    if kind == "attn":
        h = rms_norm(x, lp["ln1"], cfg.norm_eps)
        if cfg.use_mla:
            y, c = A.mla_prefill(lp["attn"], h, cfg, positions,
                                 qc=ctx.qc_prefill, ctx=ctx)
        else:
            y, c = A.gqa_prefill(lp["attn"], h, cfg, positions,
                                 qc=ctx.qc_prefill, ctx=ctx)
        return _ffn(lp, _residual(x + y, ctx), cfg, ctx), c
    if kind == "dec":
        h = rms_norm(x, lp["ln1"], cfg.norm_eps)
        y, c = A.gqa_prefill(lp["attn"], h, cfg, positions,
                             qc=ctx.qc_prefill, ctx=ctx)
        x = _residual(x + y, ctx)
        kv = A.cross_kv(lp["cross"], enc_out, cfg, ctx)
        h = rms_norm(x, lp["lnx"], cfg.norm_eps)
        x = _residual(x + A.cross_attend(lp["cross"], h, kv, cfg,
                                         qc=ctx.qc_prefill, ctx=ctx), ctx)
        return _ffn(lp, x, cfg, ctx, gated=False), \
            {"k": c["k"], "v": c["v"], "xk": kv["k"], "xv": kv["v"]}
    if kind == "mlstm":
        h = rms_norm(x, lp["ln1"], cfg.norm_eps)
        y, st = S.mlstm_prefill(lp["mlstm"], h, cfg, chunk=ctx.gla_chunk,
                                valid=valid, ctx=ctx)
        return _residual(x + y, ctx), {"state": st}
    if kind == "slstm":
        h = rms_norm(x, lp["ln1"], cfg.norm_eps)
        y, st = S.slstm_train(lp["slstm"], h, cfg, valid=valid, ctx=ctx)
        return _residual(x + y, ctx), \
            {"c": st[0], "n": st[1], "h": st[2], "m": st[3]}
    if kind == "hymba":
        h = rms_norm(x, lp["ln1"], cfg.norm_eps)
        y_attn, c = A.gqa_prefill(lp["attn"], h, cfg, positions,
                                  qc=ctx.qc_prefill, ctx=ctx)
        y_ssm, st = S.mamba_prefill(lp["mamba"], h, cfg, chunk=ctx.gla_chunk,
                                    valid=valid, ctx=ctx)
        x = _ffn(lp, _residual(x + 0.5 * (y_attn + y_ssm), ctx), cfg, ctx)
        w = min(cfg.sliding_window or s, s)
        ring = _ring(c, w, s, s if prompt_len is None else prompt_len, cfg,
                     ctx)
        return x, {**ring, "state": st}
    raise ValueError(kind)


def forward_prefill(params, batch, cfg: ModelConfig, ctx: ModelCtx,
                    prompt_len: int | None = None):
    """Prefill: full-sequence forward returning next-token logits + cache.

    batch: {"tokens": [B, S] integer tensor} (and "enc_inputs" [B, S_enc,
    D] for the encoder-decoder). `prompt_len` marks the true prompt end
    when the tokens are right-padded to the cache length (see the module
    docstring); None = the whole sequence is real. Returns (logits
    [B, 1, V] fp32, the cache: stacked `[L, ...]` tensors or a tuple of
    per-layer dicts, as `cache_desc` describes with S_max = S). On a mesh
    the logits and the cache are DTensors."""
    ctx = _for_batch(ctx, batch["tokens"].shape[0])
    with mesh_mode(ctx):
        return _forward_prefill(params, batch, cfg, ctx, prompt_len)


def _stack_layers(ts: list):
    """[L, ...] from L per-layer tensors; DTensors stacked rank by rank,
    each keeping its layout (shifted one dimension in)."""
    if not is_dtensor(ts[0]):
        return torch.stack(ts)
    from torch.distributed.tensor import DTensor, Shard

    t0 = ts[0]
    place = tuple(Shard(p.dim + 1) if isinstance(p, Shard) else p
                  for p in t0.placements)
    shape = (len(ts),) + tuple(t0.shape)
    stride = torch.empty(shape, device="meta").stride()
    return DTensor.from_local(torch.stack([t.to_local() for t in ts]),
                              t0.device_mesh, place, run_check=False,
                              shape=torch.Size(shape), stride=stride)


def _forward_prefill(params, batch, cfg, ctx, prompt_len):
    tokens = batch["tokens"]
    b, s = tokens.shape
    params = cast_floats(params, getattr(torch, cfg.compute_dtype))
    x = _embed(params["embed"], tokens, ctx)
    positions = torch.arange(s, device=x.device)
    prompt_len = None if prompt_len is None else int(prompt_len)
    valid = None if prompt_len is None else positions < prompt_len
    enc_out = None
    if cfg.encoder_layers:
        if "enc_inputs" not in batch:
            raise ValueError(f"{cfg.name}: the encoder-decoder needs "
                             f"batch['enc_inputs'] [B, {cfg.encoder_seq}, "
                             f"{cfg.d_model}]")
        enc_out = _encode(params, batch["enc_inputs"], cfg, ctx)
    kinds = _cache_kinds(cfg)
    stacked = not isinstance(params["layers"], tuple)
    caches, cache = [], None
    for i, kind in enumerate(kinds):
        x, c = _prefill_block(kind, _layer(params["layers"], i), x, cfg,
                              ctx, positions, valid, prompt_len, enc_out)
        if not stacked or on_mesh(ctx):
            caches.append(c)
            continue
        if cache is None:              # one [L, ...] tensor per entry
            cache = {name: torch.empty((len(kinds),) + t.shape,
                                       dtype=t.dtype, device=t.device)
                     for name, t in c.items()}
        for name, t in c.items():
            cache[name][i] = t
    if stacked and on_mesh(ctx):
        cache = {name: _stack_layers([c[name] for c in caches])
                 for name in caches[0]}
    last = (s - 1) if prompt_len is None else (prompt_len - 1)
    x = rms_norm(x[:, last:last + 1], params["ln_f"], cfg.norm_eps)
    logits = (x @ _unshard(params["head"], ctx)).float()
    return logits, (cache if stacked else tuple(caches))


# ---------------------------------------------------------------------------
# serving: decode
# ---------------------------------------------------------------------------

def _decode_block(kind, lp, cache, x, cfg, ctx, pos: int):
    """One layer of decode: (x, the layer's new cache entries)."""
    lp = _unshard(lp, ctx)
    if kind in ("attn", "dec"):
        h = rms_norm(x, lp["ln1"], cfg.norm_eps)
        kv = {"k": cache.get("k"), "v": cache.get("v")}
        if cfg.use_mla:
            y, c2 = A.mla_decode(lp["attn"], h, cache, cfg, pos, ctx=ctx)
        elif (ctx.opt_flash_decode and ctx.tp_size > 1
              and cfg.n_kv_heads % ctx.tp_size != 0
              and cache["k"].shape[1] % ctx.tp_size == 0):
            # S-sharded cache: sequence-parallel LSE decode (perf opt)
            y, c2 = A.gqa_decode_flash(lp["attn"], h, kv, cfg, pos, ctx)
        else:
            y, c2 = A.gqa_decode(lp["attn"], h, kv, cfg, pos, ctx=ctx)
        x = _residual(x + y, ctx)
        if kind == "attn":
            return _ffn(lp, x, cfg, ctx), c2
        h = rms_norm(x, lp["lnx"], cfg.norm_eps)
        x = _residual(x + A.cross_attend(
            lp["cross"], h, {"k": cache["xk"], "v": cache["xv"]}, cfg, qc=1,
            ctx=ctx), ctx)
        return _ffn(lp, x, cfg, ctx, gated=False), c2
    if kind == "hymba":
        h = rms_norm(x, lp["ln1"], cfg.norm_eps)
        y_attn, ring = A.gqa_decode_ring(lp["attn"], h, cache, cfg, pos,
                                         ctx=ctx)
        y_ssm, state = S.mamba_decode(lp["mamba"], h, cache["state"], cfg,
                                      ctx=ctx)
        x = _residual(x + 0.5 * (y_attn + y_ssm), ctx)
        return _ffn(lp, x, cfg, ctx), {**ring, "state": state}
    if kind == "mlstm":
        h = rms_norm(x, lp["ln1"], cfg.norm_eps)
        y, state = S.mlstm_decode(lp["mlstm"], h, cache["state"], cfg,
                                  ctx=ctx)
        return _residual(x + y, ctx), {"state": state}
    if kind == "slstm":
        h = rms_norm(x, lp["ln1"], cfg.norm_eps)
        y, st = S.slstm_decode(lp["slstm"], h, (
            cache["c"], cache["n"], cache["h"], cache["m"]), cfg, ctx=ctx)
        return _residual(x + y, ctx), \
            {"c": st[0], "n": st[1], "h": st[2], "m": st[3]}
    raise ValueError(kind)


def forward_decode(params, cache, tokens, pos: int, cfg: ModelConfig,
                   ctx: ModelCtx):
    """One decode step. tokens [B, 1], pos: the current position (an
    int). Updates `cache` in place: the attention caches are written at
    `pos` (the ring at pos % w), and each recurrent state's new value is
    copied over the old. Returns (logits [B, 1, V] fp32, the cache). On a
    mesh the tokens, the logits and the cache are DTensors; each cache
    write lands on the rank whose shard holds `pos`."""
    ctx = _for_batch(ctx, tokens.shape[0])
    with mesh_mode(ctx):
        return _forward_decode(params, cache, tokens, pos, cfg, ctx)


def _forward_decode(params, cache, tokens, pos, cfg, ctx):
    params = cast_floats(params, getattr(torch, cfg.compute_dtype))
    x = _embed(params["embed"], tokens, ctx)
    pos = int(pos)
    for i, kind in enumerate(_cache_kinds(cfg)):
        cl = _layer(cache, i)
        x, c2 = _decode_block(kind, _layer(params["layers"], i), cl, x, cfg,
                              ctx, pos)
        for name, t in c2.items():
            if t is not cl[name]:
                cl[name].copy_(t)
    x = rms_norm(x, params["ln_f"], cfg.norm_eps)
    logits = (x @ _unshard(params["head"], ctx)).float()
    return logits, cache
