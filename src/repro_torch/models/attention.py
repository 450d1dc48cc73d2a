"""Attention blocks: GQA (+ sliding window), MLA and cross-attention.

Prefill attention is **query-chunked** (a loop over Q chunks with full-K
inner attention, as the JAX package's `jax.lax.map`): the peak
intermediate is [B, KV, R, qc, T] instead of [B, H, S, S]. Decode is a
single-token read of a preallocated KV cache.

Numerics follow the JAX package: the scores are fp32 (its
`preferred_element_type=float32`: bf16 inputs are widened, so each
product is exact and the sum is fp32), masked with `NEG_INF` (a finite
-1e30, not -inf), soft-maxed in fp32, and the probabilities cast to V's
dtype before the PV product. Prefill multiplies the scores by
1/sqrt(hd) and decode divides them by sqrt(hd), as the JAX package
does; they round differently. No path calls
`scaled_dot_product_attention`, whose fused kernels round otherwise.

MLA (deepseek-v2) caches the compressed c_kv and the shared rope key,
and its decode recomputes the per-head keys and values from the whole
c_kv cache each step, as the JAX package does; its scores multiply by
1/sqrt(nope + rope dims) in prefill and decode alike. Cross-attention
(whisper's decoder) reads the encoder's K/V through the same chunked
attention, unmasked. The sequence-sharded flash decode
(`gqa_decode_flash`, a `shard_map` that never runs on one device) waits
for the mesh level (ROADMAP.md queue 1 item 3).

Training (`gqa_train`, `mla_train`) runs the prefill's chunked attention
under autograd: the masked scores are `torch.where`'s `NEG_INF`, so a
masked pair's gradient is 0, as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import ParamDesc, apply_rope, rms_norm

NEG_INF = -1e30


def pick_qc(s: int, qc: int) -> int:
    """Largest divisor of s that is ≤ qc (query-chunk size must tile s —
    e.g. whisper's 1500-frame encoder gets 750 instead of 1024)."""
    qc = min(qc, s)
    while s % qc:
        qc -= 1
    return max(qc, 1)


# ============================ GQA ============================

def gqa_desc(cfg: ModelConfig) -> dict:
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    p = {
        "wq": ParamDesc((d, h * hd), tp=1, fsdp=0),
        "wk": ParamDesc((d, kv * hd), tp=1, fsdp=0),
        "wv": ParamDesc((d, kv * hd), tp=1, fsdp=0),
        "wo": ParamDesc((h * hd, d), tp=0, fsdp=1),
    }
    if cfg.qkv_bias:
        p["bq"] = ParamDesc((h * hd,), zero=True)
        p["bk"] = ParamDesc((kv * hd,), zero=True)
        p["bv"] = ParamDesc((kv * hd,), zero=True)
    return p


def _qkv(p, x, cfg: ModelConfig, positions, rope: bool = True):
    b, s, _ = x.shape
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(b, s, h, hd)
    k = k.reshape(b, s, kv, hd)
    v = v.reshape(b, s, kv, hd)
    if rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _scores(q, k):
    """fp32 scores of q [B,Q,KV,R,hd] against k [B,T,KV,hd] -> [B,KV,R,Q,T]:
    the inputs widened to fp32 (exact for bf16), summed in fp32."""
    return torch.einsum("bqgrh,btgh->bgrqt", q.float(), k.float())


def _attend_chunked(q, k, v, *, causal: bool, window: int, q_offset: int,
                    qc: int, n_rep: int):
    """q [B,S,H,hd], k/v [B,T,KV,hd]; loop over Q chunks. Returns
    [B,S,H,hd] in V's dtype.

    q_offset: position of q[0] relative to k[0] (prefill: 0)."""
    b, s, h, hd = q.shape
    t = k.shape[1]
    kvh = k.shape[2]
    scale = float(np.float32(1.0) / np.sqrt(np.float32(hd)))   # fp32 value
    qc = pick_qc(s, qc)
    n_chunks = s // qc
    qr = q.reshape(b, n_chunks, qc, kvh, n_rep, hd)
    kpos = torch.arange(t, device=q.device)
    outs = []
    for ci in range(n_chunks):
        scores = _scores(qr[:, ci], k) * scale
        qpos = ci * qc + torch.arange(qc, device=q.device) + q_offset
        mask = torch.ones((qc, t), dtype=torch.bool, device=q.device)
        if causal:
            mask &= kpos[None, :] <= qpos[:, None]
        if window > 0:
            mask &= kpos[None, :] > qpos[:, None] - window
        scores = torch.where(mask, scores, NEG_INF)
        probs = torch.softmax(scores, dim=-1).to(v.dtype)
        outs.append(torch.einsum("bgrqt,btgh->bqgrh", probs, v))
    return torch.cat(outs, dim=1).reshape(b, s, h, hd)


def gqa_train(p, x, cfg: ModelConfig, positions, *, causal=True,
              qc: int = 1024):
    """Full-sequence attention without a cache: the training forward's,
    and the encoder's (`causal=False`)."""
    b, s, _ = x.shape
    q, k, v = _qkv(p, x, cfg, positions)
    out = _attend_chunked(q, k, v, causal=causal, window=cfg.sliding_window,
                          q_offset=0, qc=qc,
                          n_rep=cfg.n_heads // cfg.n_kv_heads)
    return out.reshape(b, s, -1) @ p["wo"]


def gqa_prefill(p, x, cfg: ModelConfig, positions, *, qc: int = 256):
    """Returns (y, cache{k,v})."""
    b, s, _ = x.shape
    q, k, v = _qkv(p, x, cfg, positions)
    out = _attend_chunked(q, k, v, causal=True, window=cfg.sliding_window,
                          q_offset=0, qc=qc,
                          n_rep=cfg.n_heads // cfg.n_kv_heads)
    y = out.reshape(b, s, -1) @ p["wo"]
    return y, {"k": k, "v": v}


def _check_pos(pos: int, t: int) -> int:
    pos = int(pos)
    if not 0 <= pos < t:
        raise IndexError(f"decode position {pos} is outside the cache's "
                         f"{t} slots")
    return pos


def gqa_decode(p, x, cache, cfg: ModelConfig, pos: int):
    """x [B,1,D]; cache k/v [B,S,KV,hd]; pos: the current length (an int).

    Writes the new K/V at `pos` into the cache **in place** (the JAX
    package's `dynamic_update_slice` returns a new array; the port's
    caller owns the one preallocated cache) and attends over positions
    <= pos. Returns (y [B,1,D], the cache)."""
    b = x.shape[0]
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    t = cache["k"].shape[1]
    pos = _check_pos(pos, t)
    positions = torch.full((1,), pos, dtype=torch.int64, device=x.device)
    q, knew, vnew = _qkv(p, x, cfg, positions)
    k, v = cache["k"], cache["v"]
    k[:, pos:pos + 1] = knew
    v[:, pos:pos + 1] = vnew
    qr = q.reshape(b, 1, kv, h // kv, hd)
    # an fp32 divisor; on the card PyTorch may multiply by its reciprocal
    # instead, the same value when hd is a power of 4 (qwen2's 64)
    scores = _scores(qr, k) / float(np.sqrt(np.float32(hd)))
    kpos = torch.arange(t, device=x.device)
    mask = kpos <= pos
    if cfg.sliding_window > 0:
        mask &= kpos > pos - cfg.sliding_window
    scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bgrqt,btgh->bqgrh", probs, v).reshape(b, 1, -1)
    return out @ p["wo"], {"k": k, "v": v}


# ============================ MLA (DeepSeek-V2) ============================
# Decoupled RoPE MLA: the cache holds the compressed c_kv [B,S,r] and the
# shared rope key [B,S,rope_dim] only.

MLA_NOPE = 128   # per-head no-rope dim (DeepSeek-V2)
MLA_V = 128      # per-head value dim


def mla_desc(cfg: ModelConfig) -> dict:
    d, h = cfg.d_model, cfg.n_heads
    r = cfg.kv_lora_rank
    rd = cfg.mla_rope_dim
    return {
        "wq": ParamDesc((d, h * (MLA_NOPE + rd)), tp=1, fsdp=0),
        "w_dkv": ParamDesc((d, r), fsdp=0),
        "kv_norm": ParamDesc((r,), one=True),
        "w_uk": ParamDesc((r, h * MLA_NOPE), tp=1, fsdp=0),
        "w_uv": ParamDesc((r, h * MLA_V), tp=1, fsdp=0),
        "w_kr": ParamDesc((d, rd), fsdp=0),
        "wo": ParamDesc((h * MLA_V, d), tp=0, fsdp=1),
    }


def _mla_qkv(p, x, cfg: ModelConfig, positions):
    b, s, _ = x.shape
    h, rd = cfg.n_heads, cfg.mla_rope_dim
    q = (x @ p["wq"]).reshape(b, s, h, MLA_NOPE + rd)
    q_c, q_r = q[..., :MLA_NOPE], q[..., MLA_NOPE:]
    q_r = apply_rope(q_r, positions, cfg.rope_theta)
    c_kv = rms_norm(x @ p["w_dkv"], p["kv_norm"], cfg.norm_eps)  # [B,S,r]
    k_r = apply_rope((x @ p["w_kr"])[:, :, None, :], positions,
                     cfg.rope_theta)[:, :, 0]                    # [B,S,rd]
    return q_c, q_r, c_kv, k_r


def _mla_scale(cfg: ModelConfig) -> float:
    """1/sqrt(nope + rope dims) as the JAX package's fp32 value."""
    return float(np.float32(1.0) / np.sqrt(np.float32(MLA_NOPE
                                                      + cfg.mla_rope_dim)))


def _mla_kv(p, c_kv, cfg: ModelConfig):
    """The per-head keys [B,T,H,nope] and values [B,T,H,v] from c_kv."""
    b, t, _ = c_kv.shape
    k_c = (c_kv @ p["w_uk"]).reshape(b, t, cfg.n_heads, MLA_NOPE)
    v = (c_kv @ p["w_uv"]).reshape(b, t, cfg.n_heads, MLA_V)
    return k_c, v


def _mla_scores(q_c, q_r, k_c32, k_r32, scale: float):
    """fp32 scores [B,H,Q,T]: the no-rope and the rope products of the
    widened inputs, summed, times `scale`."""
    s1 = torch.einsum("bqhd,bthd->bhqt", q_c.float(), k_c32)
    s2 = torch.einsum("bqhd,btd->bhqt", q_r.float(), k_r32)
    return (s1 + s2) * scale


def _mla_attend(p, q_c, q_r, c_kv, k_r, cfg: ModelConfig, *, causal: bool,
                q_offset: int, qc: int):
    b, s, h, _ = q_c.shape
    t = c_kv.shape[1]
    k_c, v = _mla_kv(p, c_kv, cfg)
    k_c32, k_r32 = k_c.float(), k_r.float()
    scale = _mla_scale(cfg)
    qc = pick_qc(s, qc)
    kpos = torch.arange(t, device=q_c.device)
    outs = []
    for ci in range(s // qc):
        rows = slice(ci * qc, (ci + 1) * qc)
        scores = _mla_scores(q_c[:, rows], q_r[:, rows], k_c32, k_r32, scale)
        if causal:
            qpos = ci * qc + torch.arange(qc, device=q_c.device) + q_offset
            scores = torch.where(kpos[None, :] <= qpos[:, None], scores,
                                 NEG_INF)
        probs = torch.softmax(scores, dim=-1).to(v.dtype)
        outs.append(torch.einsum("bhqt,bthd->bqhd", probs, v))
    out = torch.cat(outs, dim=1).reshape(b, s, h * MLA_V)
    return out @ p["wo"]


def mla_train(p, x, cfg: ModelConfig, positions, *, qc: int = 1024):
    q_c, q_r, c_kv, k_r = _mla_qkv(p, x, cfg, positions)
    return _mla_attend(p, q_c, q_r, c_kv, k_r, cfg, causal=True,
                       q_offset=0, qc=qc)


def mla_prefill(p, x, cfg: ModelConfig, positions, *, qc: int = 256):
    """Returns (y, cache{c_kv [B,S,r], k_r [B,S,rd]})."""
    q_c, q_r, c_kv, k_r = _mla_qkv(p, x, cfg, positions)
    y = _mla_attend(p, q_c, q_r, c_kv, k_r, cfg, causal=True, q_offset=0,
                    qc=qc)
    return y, {"c_kv": c_kv, "k_r": k_r}


def mla_decode(p, x, cache, cfg: ModelConfig, pos: int):
    """x [B,1,D]; cache c_kv [B,S,r] and k_r [B,S,rd]; pos an int. Writes
    the step's c_kv and k_r at `pos` in place, then recomputes the keys
    and values from the whole c_kv cache (the JAX package's form; the
    absorbed form rounds otherwise). Returns (y [B,1,D], the cache)."""
    b = x.shape[0]
    pos = _check_pos(pos, cache["c_kv"].shape[1])
    positions = torch.full((1,), pos, dtype=torch.int64, device=x.device)
    q_c, q_r, c_new, kr_new = _mla_qkv(p, x, cfg, positions)
    c_kv, k_r = cache["c_kv"], cache["k_r"]
    c_kv[:, pos:pos + 1] = c_new
    k_r[:, pos:pos + 1] = kr_new
    t = c_kv.shape[1]
    k_c, v = _mla_kv(p, c_kv, cfg)
    scores = _mla_scores(q_c, q_r, k_c.float(), k_r.float(), _mla_scale(cfg))
    mask = torch.arange(t, device=x.device) <= pos
    scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bhqt,bthd->bqhd", probs, v).reshape(b, 1, -1)
    return out @ p["wo"], {"c_kv": c_kv, "k_r": k_r}


# ============================ cross-attention (enc-dec) ====================

def cross_desc(cfg: ModelConfig) -> dict:
    d, h, hd = cfg.d_model, cfg.n_heads, cfg.hd
    return {
        "wq": ParamDesc((d, h * hd), tp=1, fsdp=0),
        "wk": ParamDesc((d, h * hd), tp=1, fsdp=0),
        "wv": ParamDesc((d, h * hd), tp=1, fsdp=0),
        "wo": ParamDesc((h * hd, d), tp=0, fsdp=1),
    }


def cross_kv(p, enc_out, cfg: ModelConfig):
    b, t, _ = enc_out.shape
    k = (enc_out @ p["wk"]).reshape(b, t, cfg.n_heads, cfg.hd)
    v = (enc_out @ p["wv"]).reshape(b, t, cfg.n_heads, cfg.hd)
    return {"k": k, "v": v}


def cross_attend(p, x, kv, cfg: ModelConfig, *, qc: int = 1024):
    b, s, _ = x.shape
    q = (x @ p["wq"]).reshape(b, s, cfg.n_heads, cfg.hd)
    out = _attend_chunked(q, kv["k"], kv["v"], causal=False, window=0,
                          q_offset=0, qc=qc, n_rep=1)
    return out.reshape(b, s, -1) @ p["wo"]
