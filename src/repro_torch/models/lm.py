"""Model assembly for the dense decoders' serving path: descriptors,
prefill and KV-cache decode.

One descriptor tree (`model_desc`) gives the parameters: the embedding,
the final norm, the head, and the layers stacked `[L, ...]`, as in the
JAX package. The forwards loop over the stacked layers in Python where
the JAX package scans. The KV cache is a dict of `[L, B, S, KV, hd]`
tensors in the compute dtype; decode writes each step's K/V into it in
place.

The port runs the `"attn"` layer kind without MoE or MLA: the dense
decoders qwen2-0.5b, internlm2-1.8b/20b, codeqwen1.5-7b and the
chameleon-34b backbone. The other families the JAX package supports
(MoE and MLA, the SSM and hybrid blocks, the encoder-decoder) raise
`NotImplementedError` naming their ROADMAP.md item, queue 1 item 2b;
training (`forward_train`) is item 2c.

The JAX package casts the parameters to the compute dtype inside every
call. The port's forwards call `cast_floats` too, which returns a leaf
already in that dtype as it is; `launch.serve.generate` casts once
before prefill, which gives the same values, so the decode loop moves no
cast (at qwen2-0.5b's full width each would be 3.8 GB of traffic).
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as A
from repro_torch.models import moe as M
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


def _unported(cfg: ModelConfig, what: str):
    return NotImplementedError(
        f"{cfg.name}: {what} is not ported yet (ROADMAP.md queue 1 item "
        f"2b, the other families' serving forwards); the port runs the "
        f"dense decoders")


def _check_dense(cfg: ModelConfig) -> None:
    """Raise for a configuration whose layers the port cannot run."""
    if cfg.encoder_layers:
        raise _unported(cfg, "the encoder-decoder with cross-attention")
    if cfg.is_moe:
        raise _unported(cfg, "the Mixture-of-Experts layer")
    if cfg.use_mla:
        raise _unported(cfg, "multi-head latent attention (MLA)")
    kinds = set(layer_kinds(cfg))
    if kinds != {"attn"}:
        raise _unported(cfg, f"the {sorted(kinds)} block kinds")


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
    if kind != "attn" or cfg.is_moe or cfg.use_mla:
        _check_dense(cfg)
        raise _unported(cfg, f"the {kind!r} block")
    ln = lambda: ParamDesc((cfg.d_model,), one=True)
    return {"ln1": ln(), "attn": A.gqa_desc(cfg), "ln2": ln(),
            "mlp": M.mlp_desc(cfg)}


def _stack_desc(desc: dict, n: int) -> dict:
    def add_dim(d: ParamDesc) -> ParamDesc:
        return ParamDesc((n,) + d.shape, d.dtype,
                         tp=None if d.tp is None else d.tp + 1,
                         fsdp=None if d.fsdp is None else d.fsdp + 1,
                         scale=d.scale, zero=d.zero, one=d.one)
    return map_descs(add_dim, desc)


def model_desc(cfg: ModelConfig) -> dict:
    _check_dense(cfg)
    d = cfg.d_model
    return {
        "embed": ParamDesc((cfg.vocab, d), tp=0, fsdp=1, scale=0.02),
        "ln_f": ParamDesc((d,), one=True),
        "head": ParamDesc((d, cfg.vocab), tp=1, fsdp=0),
        "layers": _stack_desc(layer_desc(cfg, "attn"), cfg.n_layers),
    }


def cache_desc(cfg: ModelConfig, batch: int, s_max: int) -> dict:
    """The stacked KV cache's descriptors: k and v `[L, B, S, KV, hd]` in
    the compute dtype."""
    _check_dense(cfg)
    dt = getattr(torch, cfg.compute_dtype)
    kv_shardable = cfg.n_kv_heads % 16 == 0
    one = {"k": ParamDesc((batch, s_max, cfg.n_kv_heads, cfg.hd), dt,
                          fsdp=0, tp=2 if kv_shardable else 1),
           "v": ParamDesc((batch, s_max, cfg.n_kv_heads, cfg.hd), dt,
                          fsdp=0, tp=2 if kv_shardable else 1)}
    return _stack_desc(one, cfg.n_layers)


def _layer(layers: dict, i: int) -> dict:
    """Layer i's parameters (views) of the stacked tree."""
    return {k: _layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in layers.items()}


# ---------------------------------------------------------------------------
# serving: prefill + decode
# ---------------------------------------------------------------------------

def forward_prefill(params, batch, cfg: ModelConfig, ctx: ModelCtx,
                    prompt_len: int | None = None):
    """Prefill: full-sequence forward returning next-token logits + cache.

    batch: {"tokens": [B, S] integer tensor}. `prompt_len` marks the true
    prompt end when the tokens are right-padded to the cache length: the
    logits are taken at prompt_len - 1 (else at S - 1). Returns (logits
    [B, 1, V] fp32, cache {"k", "v": [L, B, S, KV, hd]})."""
    _check_dense(cfg)
    tokens = batch["tokens"]
    b, s = tokens.shape
    params = cast_floats(params, getattr(torch, cfg.compute_dtype))
    x = params["embed"][tokens.long()]
    positions = torch.arange(s, device=x.device)
    cache = {name: torch.empty((cfg.n_layers, b, s, cfg.n_kv_heads, cfg.hd),
                               dtype=x.dtype, device=x.device)
             for name in ("k", "v")}
    for i in range(cfg.n_layers):
        lp = _layer(params["layers"], i)
        h = rms_norm(x, lp["ln1"], cfg.norm_eps)
        y, c = A.gqa_prefill(lp["attn"], h, cfg, positions,
                             qc=ctx.qc_prefill)
        cache["k"][i] = c["k"]
        cache["v"][i] = c["v"]
        x = x + y
        h = rms_norm(x, lp["ln2"], cfg.norm_eps)
        x = x + M.mlp_apply(lp["mlp"], h)
    last = (s - 1) if prompt_len is None else (int(prompt_len) - 1)
    x = rms_norm(x[:, last:last + 1], params["ln_f"], cfg.norm_eps)
    logits = (x @ params["head"]).float()
    return logits, cache


def forward_decode(params, cache, tokens, pos: int, cfg: ModelConfig,
                   ctx: ModelCtx):
    """One decode step. tokens [B, 1], pos: the current position (an
    int). Writes the step's K/V into `cache` in place. Returns (logits
    [B, 1, V] fp32, the cache)."""
    _check_dense(cfg)
    params = cast_floats(params, getattr(torch, cfg.compute_dtype))
    x = params["embed"][tokens.long()]
    for i in range(cfg.n_layers):
        lp = _layer(params["layers"], i)
        h = rms_norm(x, lp["ln1"], cfg.norm_eps)
        y, _ = A.gqa_decode(lp["attn"], h,
                            {"k": cache["k"][i], "v": cache["v"][i]}, cfg,
                            pos)
        x = x + y
        h = rms_norm(x, lp["ln2"], cfg.norm_eps)
        x = x + M.mlp_apply(lp["mlp"], h)
    x = rms_norm(x, params["ln_f"], cfg.norm_eps)
    logits = (x @ params["head"]).float()
    return logits, cache
