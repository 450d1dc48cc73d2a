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
Training (`forward_train`) waits for ROADMAP.md queue 1 item 2c.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as A
from repro_torch.models import moe as M
from repro_torch.models import ssm as S
from repro_torch.models.common import ParamDesc, cast_floats, map_descs, \
    rms_norm


@dataclasses.dataclass(frozen=True)
class ModelCtx:
    """Execution context on one device: the chunking knobs. The JAX
    package's mesh fields (mesh, axis names and sizes, and the
    sharding options) wait for the mesh level (ROADMAP.md queue 1 item
    3)."""
    qc_train: int = 1024
    qc_prefill: int = 256
    gla_chunk: int = 256


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
    if kind in ("attn", "enc", "dec"):
        h = rms_norm(x, lp["ln1"], cfg.norm_eps)
        if cfg.use_mla:
            y = A.mla_train(lp["attn"], h, cfg, positions, qc=qc)
        else:
            y = A.gqa_train(lp["attn"], h, cfg, positions,
                            causal=(kind != "enc"), qc=qc)
        x = x + y
        if kind == "dec":
            h = rms_norm(x, lp["lnx"], cfg.norm_eps)
            x = x + A.cross_attend(lp["cross"], h, enc_kv, cfg, qc=qc)
        h = rms_norm(x, lp["ln2"], cfg.norm_eps)
        if "moe" in lp:
            y, aux = M.moe_apply(lp["moe"], h, cfg, ctx)
        elif kind == "attn":
            y = M.mlp_apply(lp["mlp"], h)
        else:
            y = M.mlp_apply(lp["mlp"], h, gated=False, act=M.gelu)
        return x + y, aux
    if kind == "mlstm":
        h = rms_norm(x, lp["ln1"], cfg.norm_eps)
        return x + S.mlstm_train(lp["mlstm"], h, cfg, chunk=ctx.gla_chunk), \
            aux
    if kind == "slstm":
        h = rms_norm(x, lp["ln1"], cfg.norm_eps)
        y, _ = S.slstm_train(lp["slstm"], h, cfg)
        return x + y, aux
    if kind == "hymba":
        h = rms_norm(x, lp["ln1"], cfg.norm_eps)
        y_attn = A.gqa_train(lp["attn"], h, cfg, positions, qc=qc)
        y_ssm = S.mamba_train(lp["mamba"], h, cfg, chunk=ctx.gla_chunk)
        x = x + 0.5 * (y_attn + y_ssm)
        h = rms_norm(x, lp["ln2"], cfg.norm_eps)
        return x + M.mlp_apply(lp["mlp"], h), aux
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
            kv = A.cross_kv(lp["cross"], enc_out, cfg)
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
    x = enc_inputs.to(dt) + params["enc_pos"].to(dt)
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
    tokens = batch["tokens"]
    s = tokens.shape[1]
    params = cast_floats(params, getattr(torch, cfg.compute_dtype))
    x = params["embed"][tokens.long()]
    positions = torch.arange(s, device=x.device)
    if cfg.encoder_layers:
        enc_out = _encode(params, batch["enc_inputs"], cfg, ctx)
        x, aux = _run_layers_encdec(params, x, cfg, ctx, positions, enc_out)
    else:
        x, aux = _run_layers(params, x, cfg, ctx, positions,
                             qc=ctx.qc_train)
    x = rms_norm(x, params["ln_f"], cfg.norm_eps)
    logp = torch.log_softmax((x @ params["head"]).float(), dim=-1)
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

def _ffn(lp, x, cfg: ModelConfig, ctx: ModelCtx):
    """An "attn" block's feed-forward half: MoE (its aux loss dropped, as
    in serving) or the gated SiLU MLP."""
    h = rms_norm(x, lp["ln2"], cfg.norm_eps)
    if "moe" in lp:
        return x + M.moe_apply(lp["moe"], h, cfg, ctx)[0]
    return x + M.mlp_apply(lp["mlp"], h)


def _ring(c, w: int, s: int, end: int):
    """The Hymba ring of `w` slots from prefill's K/V over `s` positions:
    slot j holds the latest position p < end with p % w == j; a slot no
    position reaches gets slot_pos 2^30."""
    dev = c["k"].device
    slots = torch.arange(w, dtype=torch.int64, device=dev)
    start = end - w
    p_j = start + torch.remainder(slots - start, w)
    ring_idx = torch.clamp(p_j, 0, s - 1)
    slot_pos = torch.where((p_j >= 0) & (p_j < end), p_j, 2 ** 30)
    return {"k": c["k"].index_select(1, ring_idx),
            "v": c["v"].index_select(1, ring_idx),
            "slot_pos": slot_pos.to(torch.int32)}


def _prefill_block(kind, lp, x, cfg, ctx, positions, valid, prompt_len,
                   enc_out):
    """One layer of prefill: (x, the layer's cache)."""
    b, s, _ = x.shape

    def mask_writes(k, log_f):
        """Zero recurrent writes (k) and freeze decay (f=1) past the
        prompt."""
        if valid is None:
            return k, log_f
        return torch.where(valid[None, :, None, None], k, 0).to(k.dtype), \
            torch.where(valid[None, :, None], log_f, 0.0)

    if kind == "attn":
        h = rms_norm(x, lp["ln1"], cfg.norm_eps)
        if cfg.use_mla:
            y, c = A.mla_prefill(lp["attn"], h, cfg, positions,
                                 qc=ctx.qc_prefill)
        else:
            y, c = A.gqa_prefill(lp["attn"], h, cfg, positions,
                                 qc=ctx.qc_prefill)
        return _ffn(lp, x + y, cfg, ctx), c
    if kind == "dec":
        h = rms_norm(x, lp["ln1"], cfg.norm_eps)
        y, c = A.gqa_prefill(lp["attn"], h, cfg, positions,
                             qc=ctx.qc_prefill)
        x = x + y
        kv = A.cross_kv(lp["cross"], enc_out, cfg)
        h = rms_norm(x, lp["lnx"], cfg.norm_eps)
        x = x + A.cross_attend(lp["cross"], h, kv, cfg, qc=ctx.qc_prefill)
        h = rms_norm(x, lp["ln2"], cfg.norm_eps)
        x = x + M.mlp_apply(lp["mlp"], h, gated=False, act=M.gelu)
        return x, {"k": c["k"], "v": c["v"], "xk": kv["k"], "xv": kv["v"]}
    if kind == "mlstm":
        h = rms_norm(x, lp["ln1"], cfg.norm_eps)
        q, k, v, log_f, o = S._mlstm_qkvgates(lp["mlstm"], h, cfg)
        k, log_f = mask_writes(k, log_f)
        y, st = S.gla_chunk_scan(q, k, v, log_f, chunk=ctx.gla_chunk)
        y = (y.reshape(b, s, -1) * o) @ lp["mlstm"]["wo"]
        return x + y, {"state": st}
    if kind == "slstm":
        h = rms_norm(x, lp["ln1"], cfg.norm_eps)
        y, st = S.slstm_train(lp["slstm"], h, cfg, valid=valid)
        return x + y, {"c": st[0], "n": st[1], "h": st[2], "m": st[3]}
    if kind == "hymba":
        h = rms_norm(x, lp["ln1"], cfg.norm_eps)
        y_attn, c = A.gqa_prefill(lp["attn"], h, cfg, positions,
                                  qc=ctx.qc_prefill)
        q, kk, vv, log_f = S._mamba_qkv(lp["mamba"], h, cfg)
        kk, log_f = mask_writes(kk, log_f)
        y_ssm, st = S.gla_chunk_scan(q, kk, vv, log_f, chunk=ctx.gla_chunk,
                                     normalize=False)
        y_ssm = y_ssm.reshape(b, s, -1) @ lp["mamba"]["w_out"]
        x = x + 0.5 * (y_attn + y_ssm)
        h = rms_norm(x, lp["ln2"], cfg.norm_eps)
        x = x + M.mlp_apply(lp["mlp"], h)
        w = min(cfg.sliding_window or s, s)
        ring = _ring(c, w, s, s if prompt_len is None else prompt_len)
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
    per-layer dicts, as `cache_desc` describes with S_max = S)."""
    tokens = batch["tokens"]
    b, s = tokens.shape
    params = cast_floats(params, getattr(torch, cfg.compute_dtype))
    x = params["embed"][tokens.long()]
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
        if not stacked:
            caches.append(c)
            continue
        if cache is None:              # one [L, ...] tensor per entry
            cache = {name: torch.empty((len(kinds),) + t.shape,
                                       dtype=t.dtype, device=t.device)
                     for name, t in c.items()}
        for name, t in c.items():
            cache[name][i] = t
    last = (s - 1) if prompt_len is None else (prompt_len - 1)
    x = rms_norm(x[:, last:last + 1], params["ln_f"], cfg.norm_eps)
    logits = (x @ params["head"]).float()
    return logits, (cache if stacked else tuple(caches))


# ---------------------------------------------------------------------------
# serving: decode
# ---------------------------------------------------------------------------

def _gqa_decode_ring(p, x, cache, cfg: ModelConfig, pos: int):
    """Sliding-window ring-buffer KV cache decode (Hymba): writes the
    step's K/V and position at slot pos % w in place; slots whose
    position is past the window, or 2^30 (never written), are masked."""
    b = x.shape[0]
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    w = cache["k"].shape[1]
    positions = torch.full((1,), pos, dtype=torch.int64, device=x.device)
    q, knew, vnew = A._qkv(p, x, cfg, positions)
    slot = pos % w
    k, v, slot_pos = cache["k"], cache["v"], cache["slot_pos"]
    k[:, slot:slot + 1] = knew
    v[:, slot:slot + 1] = vnew
    slot_pos[slot] = pos
    valid = (slot_pos <= pos) & (slot_pos > pos - (cfg.sliding_window or w))
    qr = q.reshape(b, 1, kv, h // kv, hd)
    scores = A._scores(qr, k) / float(np.sqrt(np.float32(hd)))
    scores = torch.where(valid, scores, A.NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bgrqt,btgh->bqgrh", probs, v).reshape(b, 1, -1)
    return out @ p["wo"], {"k": k, "v": v, "slot_pos": slot_pos}


def _decode_block(kind, lp, cache, x, cfg, ctx, pos: int):
    """One layer of decode: (x, the layer's new cache entries)."""
    if kind in ("attn", "dec"):
        h = rms_norm(x, lp["ln1"], cfg.norm_eps)
        if cfg.use_mla:
            y, c2 = A.mla_decode(lp["attn"], h, cache, cfg, pos)
        else:
            y, c2 = A.gqa_decode(lp["attn"], h, {"k": cache["k"],
                                                 "v": cache["v"]}, cfg, pos)
        x = x + y
        if kind == "attn":
            return _ffn(lp, x, cfg, ctx), c2
        h = rms_norm(x, lp["lnx"], cfg.norm_eps)
        x = x + A.cross_attend(lp["cross"], h,
                               {"k": cache["xk"], "v": cache["xv"]},
                               cfg, qc=1)
        h = rms_norm(x, lp["ln2"], cfg.norm_eps)
        return x + M.mlp_apply(lp["mlp"], h, gated=False, act=M.gelu), c2
    if kind == "hymba":
        h = rms_norm(x, lp["ln1"], cfg.norm_eps)
        y_attn, ring = _gqa_decode_ring(lp["attn"], h, cache, cfg, pos)
        y_ssm, state = S.mamba_decode(lp["mamba"], h, cache["state"], cfg)
        x = x + 0.5 * (y_attn + y_ssm)
        h = rms_norm(x, lp["ln2"], cfg.norm_eps)
        return x + M.mlp_apply(lp["mlp"], h), {**ring, "state": state}
    if kind == "mlstm":
        h = rms_norm(x, lp["ln1"], cfg.norm_eps)
        y, state = S.mlstm_decode(lp["mlstm"], h, cache["state"], cfg)
        return x + y, {"state": state}
    if kind == "slstm":
        h = rms_norm(x, lp["ln1"], cfg.norm_eps)
        y, st = S.slstm_decode(lp["slstm"], h, (
            cache["c"], cache["n"], cache["h"], cache["m"]), cfg)
        return x + y, {"c": st[0], "n": st[1], "h": st[2], "m": st[3]}
    raise ValueError(kind)


def forward_decode(params, cache, tokens, pos: int, cfg: ModelConfig,
                   ctx: ModelCtx):
    """One decode step. tokens [B, 1], pos: the current position (an
    int). Updates `cache` in place: the attention caches are written at
    `pos` (the ring at pos % w), and each recurrent state's new value is
    copied over the old. Returns (logits [B, 1, V] fp32, the cache)."""
    params = cast_floats(params, getattr(torch, cfg.compute_dtype))
    x = params["embed"][tokens.long()]
    pos = int(pos)
    for i, kind in enumerate(_cache_kinds(cfg)):
        cl = _layer(cache, i)
        x, c2 = _decode_block(kind, _layer(params["layers"], i), cl, x, cfg,
                              ctx, pos)
        for name, t in c2.items():
            if t is not cl[name]:
                cl[name].copy_(t)
    x = rms_norm(x, params["ln_f"], cfg.norm_eps)
    logits = (x @ params["head"]).float()
    return logits, cache
