"""Attention blocks: GQA (+ sliding window), the dense decoders' attention.

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

MLA (deepseek-v2), cross-attention (whisper) and the sequence-sharded
flash decode (`gqa_decode_flash`, a `shard_map` that never runs on one
device) wait for their families and the mesh level (ROADMAP.md queue 1
items 2b and 3).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import ParamDesc, apply_rope

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
    """The training forward's attention (forward only; the port has no
    training path yet, ROADMAP.md queue 1 item 2c)."""
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


def gqa_decode(p, x, cache, cfg: ModelConfig, pos: int):
    """x [B,1,D]; cache k/v [B,S,KV,hd]; pos: the current length (an int).

    Writes the new K/V at `pos` into the cache **in place** (the JAX
    package's `dynamic_update_slice` returns a new array; the port's
    caller owns the one preallocated cache) and attends over positions
    <= pos. Returns (y [B,1,D], the cache)."""
    b = x.shape[0]
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    t = cache["k"].shape[1]
    pos = int(pos)
    if not 0 <= pos < t:
        raise IndexError(f"decode position {pos} is outside the cache's "
                         f"{t} slots")
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
