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
attention, unmasked.

On a mesh (`ctx.mesh`; the parameters and activations are DTensors) the
projections are DTensor matmuls, which keep each weight's tensor-parallel
shard, and the rest runs on each rank's own heads (`common.local_call`,
the JAX package's per-shard view): the heads split over the "model" axis
where both the query and the key/value heads divide it, else every rank
computes all heads. Decode writes the new K/V only on the rank whose
shard holds `pos` (`common.write_at`; Hymba's ring at pos % w) and reads
a cache sharded by heads on each rank's heads; a cache sharded along the
sequence it reads gathered, with every head, or, with
`ctx.opt_flash_decode`, by the sequence-parallel flash decode
(`gqa_decode_flash`: each rank's partial attention over its slice of the
sequence, combined by log-sum-exp across the "model" ranks). Whisper's
cross-attention projects the encoder's K/V and attends on each rank's
heads.

Training (`gqa_train`, `mla_train`) runs the prefill's chunked attention
under autograd: the masked scores are `torch.where`'s `NEG_INF`, so a
masked pair's gradient is 0, as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed._functional_collectives as funcol

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import (ParamDesc, apply_rope, constrain,
                                       dp_part, is_dtensor, local_call,
                                       on_mesh, rms_norm, write_at)

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


def _proj(p, x, cfg: ModelConfig):
    """The q, k, v projections [B, S, heads * hd] (biases added)."""
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    return q, k, v


def _heads(q, k, v, cfg: ModelConfig, positions, rope: bool = True):
    """[B, S, heads * hd] projections as [B, S, heads, hd], rotated; the
    head counts are the tensors' own (a rank's share on a mesh)."""
    b, s, _ = q.shape
    hd = cfg.hd
    q = q.reshape(b, s, -1, hd)
    k = k.reshape(b, s, -1, hd)
    v = v.reshape(b, s, -1, hd)
    if rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _qkv(p, x, cfg: ModelConfig, positions, rope: bool = True):
    return _heads(*_proj(p, x, cfg), cfg, positions, rope)


def heads_part(ctx, n_heads: int, n_kv: int):
    """The head dimension's spec entry on a mesh: the "model" axis where
    both head counts divide it, else None (every rank computes every
    head, as does one device)."""
    if not on_mesh(ctx):
        return None
    t = ctx.tp_size
    return ctx.tp_axis if t > 1 and n_heads % t == 0 and n_kv % t == 0 \
        else None


def _shard_heads(x, ctx, head_dim_idx: int):
    """Pin an attention tensor when `opt_acts` is on: batch over the data
    axes, heads over TP when divisible, else replicated over TP (the JAX
    package's guard against partial sums of the score einsum over a
    sharded head_dim)."""
    if not on_mesh(ctx) or not ctx.opt_acts:
        return x
    parts = [None] * x.ndim
    parts[0] = dp_part(ctx)
    if x.shape[head_dim_idx] % ctx.tp_size == 0:
        parts[head_dim_idx] = ctx.tp_axis
    return constrain(x, ctx, *parts)


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


def _gqa_full(p, x, cfg: ModelConfig, positions, *, causal: bool, qc: int,
              ctx):
    """Full-sequence attention: (y, k, v). On a mesh each rank attends
    with its own heads; off it `local_call` is the body itself."""
    n_rep = cfg.n_heads // cfg.n_kv_heads

    def body(q, k, v):
        q, k, v = _heads(q, k, v, cfg, positions)
        out = _attend_chunked(q, k, v, causal=causal,
                              window=cfg.sliding_window, q_offset=0, qc=qc,
                              n_rep=n_rep)
        return out.reshape(out.shape[0], out.shape[1], -1), k, v

    dp, hp = dp_part(ctx), heads_part(ctx, cfg.n_heads, cfg.n_kv_heads)
    flat, four = (dp, None, hp), (dp, None, hp, None)
    out, k, v = local_call(ctx, body, list(_proj(p, x, cfg)), [flat] * 3,
                           [flat, four, four])
    return out @ p["wo"], _shard_heads(k, ctx, 2), _shard_heads(v, ctx, 2)


def gqa_train(p, x, cfg: ModelConfig, positions, *, causal=True,
              qc: int = 1024, ctx=None):
    """Full-sequence attention without a cache: the training forward's,
    and the encoder's (`causal=False`)."""
    return _gqa_full(p, x, cfg, positions, causal=causal, qc=qc, ctx=ctx)[0]


def gqa_prefill(p, x, cfg: ModelConfig, positions, *, qc: int = 256,
                ctx=None):
    """Returns (y, cache{k,v})."""
    y, k, v = _gqa_full(p, x, cfg, positions, causal=True, qc=qc, ctx=ctx)
    return y, {"k": k, "v": v}


def _check_pos(pos: int, t: int) -> int:
    pos = int(pos)
    if not 0 <= pos < t:
        raise IndexError(f"decode position {pos} is outside the cache's "
                         f"{t} slots")
    return pos


def _decode_attend(q, k, v, cfg: ModelConfig, pos: int):
    """One query position q [B,1,H,hd] against the cache k/v [B,T,KV,hd]
    over positions <= pos (and inside the window): [B,1,H*hd]."""
    b, hd = q.shape[0], cfg.hd
    t = k.shape[1]
    qr = q.reshape(b, 1, k.shape[2], -1, hd)
    # an fp32 divisor; on the card PyTorch may multiply by its reciprocal
    # instead, the same value when hd is a power of 4 (qwen2's 64)
    scores = _scores(qr, k) / float(np.sqrt(np.float32(hd)))
    kpos = torch.arange(t, device=q.device)
    mask = kpos <= pos
    if cfg.sliding_window > 0:
        mask &= kpos > pos - cfg.sliding_window
    scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bgrqt,btgh->bqgrh", probs, v).reshape(b, 1, -1)


def _decode_qkv(p, x, cfg: ModelConfig, pos: int, ctx, hp=None):
    """The step's rotated q, k, v [B,1,heads,hd]; on a mesh with the heads
    over "model" where `hp` says so, else every head on every rank."""
    positions = torch.full((1,), pos, dtype=torch.int64, device=x.device)
    dp = dp_part(ctx)
    return local_call(ctx, lambda q, k, v: _heads(q, k, v, cfg, positions),
                      list(_proj(p, x, cfg)), [(dp, None, hp)] * 3,
                      [(dp, None, hp, None)] * 3)


def _decode_heads(ctx, cfg: ModelConfig, cache_k):
    """The heads' spec entry of a decode step against `cache_k` [B, T,
    KV, hd]: "model" where both head counts divide it and the cache is
    not sharded along its sequence there (a sequence-sharded cache is
    gathered and every rank attends with every head), else None."""
    hp = heads_part(ctx, cfg.n_heads, cfg.n_kv_heads)
    if hp is None or not is_dtensor(cache_k):
        return None
    d = ctx.mesh.mesh_dim_names.index(ctx.tp_axis)
    return None if cache_k.placements[d].is_shard(1) else hp


def gqa_decode(p, x, cache, cfg: ModelConfig, pos: int, ctx=None):
    """x [B,1,D]; cache k/v [B,S,KV,hd]; pos: the current length (an int).

    Writes the new K/V at `pos` into the cache **in place** (the JAX
    package's `dynamic_update_slice` returns a new array; the port's
    caller owns the one preallocated cache) and attends over positions
    <= pos. Returns (y [B,1,D], the cache). On a mesh the write lands on
    the rank holding `pos`; a cache sharded by heads over "model" is read
    on each rank's heads, one sharded along the sequence is gathered over
    "model" (what the JAX package's partitioner does with a
    sequence-sharded cache) and read with every head."""
    pos = _check_pos(pos, cache["k"].shape[1])
    hp = _decode_heads(ctx, cfg, cache["k"])
    q, knew, vnew = _decode_qkv(p, x, cfg, pos, ctx, hp)
    k, v = cache["k"], cache["v"]
    write_at(k, knew, 1, pos)
    write_at(v, vnew, 1, pos)
    dp = dp_part(ctx)
    out = local_call(ctx, lambda q, k, v: _decode_attend(q, k, v, cfg, pos),
                     [q, k, v], [(dp, None, hp, None)] * 3, (dp, None, hp))
    return out @ p["wo"], {"k": k, "v": v}


def gqa_decode_ring(p, x, cache, cfg: ModelConfig, pos: int, ctx=None):
    """Sliding-window ring-buffer KV cache decode (Hymba): writes the
    step's K/V and position at slot pos % w in place; slots whose
    position is past the window, or 2^30 (never written), are masked. On
    a mesh the writes land on the ranks holding the slot, and each rank
    attends with its heads (`_decode_heads`)."""
    w, hd = cache["k"].shape[1], cfg.hd
    hp = _decode_heads(ctx, cfg, cache["k"])
    q, knew, vnew = _decode_qkv(p, x, cfg, pos, ctx, hp)
    slot = pos % w
    k, v, slot_pos = cache["k"], cache["v"], cache["slot_pos"]
    write_at(k, knew, 1, slot)
    write_at(v, vnew, 1, slot)
    write_at(slot_pos, torch.full((1,), pos, dtype=slot_pos.dtype,
                                  device=x.device), 0, slot)

    def attend(q, k, v, slot_pos):
        b = q.shape[0]
        valid = (slot_pos <= pos) & (slot_pos > pos - (cfg.sliding_window
                                                       or w))
        qr = q.reshape(b, 1, k.shape[2], -1, hd)
        scores = _scores(qr, k) / float(np.sqrt(np.float32(hd)))
        scores = torch.where(valid, scores, NEG_INF)
        probs = torch.softmax(scores, dim=-1).to(v.dtype)
        return torch.einsum("bgrqt,btgh->bqgrh", probs, v).reshape(b, 1, -1)

    dp = dp_part(ctx)
    out = local_call(ctx, attend, [q, k, v, slot_pos],
                     [(dp, None, hp, None)] * 3 + [(None,)], (dp, None, hp))
    return out @ p["wo"], {"k": k, "v": v, "slot_pos": slot_pos}


def _all_reduce(t, op: str, group):
    out = funcol.all_reduce(t, op, group)
    return out.wait() if isinstance(out, funcol.AsyncCollectiveTensor) \
        else out


def gqa_decode_flash(p, x, cache, cfg: ModelConfig, pos: int, ctx):
    """`gqa_decode` for a cache sharded over "model" along the sequence
    (P(dp, "model", None, None)): each rank attends over its slice of
    the sequence and the partial results combine by log-sum-exp, a max
    then two sums over the "model" ranks, [B, KV, R, hd]-sized, where
    gathering the cache would move all of it every step. The new K/V is
    written on the rank whose slice holds `pos`. Returns (y [B,1,D], the
    cache)."""
    pos = _check_pos(pos, cache["k"].shape[1])
    q, knew, vnew = _decode_qkv(p, x, cfg, pos, ctx)
    k, v = cache["k"], cache["v"]
    write_at(k, knew, 1, pos)
    write_at(v, vnew, 1, pos)
    mesh, tp, hd = ctx.mesh, ctx.tp_axis, cfg.hd
    group = (mesh, mesh.mesh_dim_names.index(tp))
    scale = float(np.sqrt(np.float32(hd)))

    def core(qs, ks, vs):
        b, s_l, kvh = ks.shape[0], ks.shape[1], ks.shape[2]
        qr = qs.reshape(b, kvh, -1, hd)
        kpos = torch.arange(s_l, device=ks.device) + \
            mesh.get_local_rank(tp) * s_l
        scores = torch.einsum("bgrh,btgh->bgrt", qr.float(),
                              ks.float()) / scale
        mask = kpos <= pos
        if cfg.sliding_window > 0:
            mask &= kpos > pos - cfg.sliding_window
        scores = torch.where(mask, scores, NEG_INF)
        m_loc = torch.amax(scores, dim=-1)                     # [B,KV,R]
        e = torch.exp(scores - m_loc[..., None])
        l_loc = torch.sum(e, dim=-1)
        o_loc = torch.einsum("bgrt,btgh->bgrh", e.to(vs.dtype), vs)
        # log-sum-exp combine across the sequence shards
        m_glob = _all_reduce(m_loc, "max", group)
        corr = torch.exp(m_loc - m_glob)
        l_glob = _all_reduce(l_loc * corr, "sum", group)
        o_glob = _all_reduce(o_loc * corr[..., None].to(vs.dtype), "sum",
                             group)
        out = o_glob / torch.clamp(l_glob, min=1e-30)[..., None].to(vs.dtype)
        return out.reshape(b, 1, -1)

    dp = dp_part(ctx)
    seq = (dp, tp, None, None)
    out = local_call(ctx, core, [q, k, v], [(dp, None, None, None), seq, seq],
                     (dp, None, None))
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


def _mla_proj(p, x, cfg: ModelConfig):
    """q [B,S,H*(nope+rd)], c_kv [B,S,r] (normed) and the unrotated rope
    key [B,S,rd]."""
    c_kv = rms_norm(x @ p["w_dkv"], p["kv_norm"], cfg.norm_eps)
    return x @ p["wq"], c_kv, x @ p["w_kr"]


def _mla_rope(q, kr, cfg: ModelConfig, positions):
    """(q_c [B,S,H,nope], rotated q_r [B,S,H,rd], rotated k_r [B,S,rd])
    from the projections; H is the tensor's own (a rank's share on a
    mesh)."""
    b, s, _ = q.shape
    q = q.reshape(b, s, -1, MLA_NOPE + cfg.mla_rope_dim)
    q_c, q_r = q[..., :MLA_NOPE], q[..., MLA_NOPE:]
    q_r = apply_rope(q_r, positions, cfg.rope_theta)
    k_r = apply_rope(kr[:, :, None, :], positions, cfg.rope_theta)[:, :, 0]
    return q_c, q_r, k_r


def _mla_scale(cfg: ModelConfig) -> float:
    """1/sqrt(nope + rope dims) as the JAX package's fp32 value."""
    return float(np.float32(1.0) / np.sqrt(np.float32(MLA_NOPE
                                                      + cfg.mla_rope_dim)))


def _mla_kv(p, c_kv):
    """The per-head keys [B,T,H*nope] and values [B,T,H*v] from c_kv."""
    return c_kv @ p["w_uk"], c_kv @ p["w_uv"]


def _mla_scores(q_c, q_r, k_c32, k_r32, scale: float):
    """fp32 scores [B,H,Q,T]: the no-rope and the rope products of the
    widened inputs, summed, times `scale`."""
    s1 = torch.einsum("bqhd,bthd->bhqt", q_c.float(), k_c32)
    s2 = torch.einsum("bqhd,btd->bhqt", q_r.float(), k_r32)
    return (s1 + s2) * scale


def _mla_core(q_c, q_r, k_c, v, k_r, cfg: ModelConfig, *, causal: bool,
              q_offset: int, qc: int):
    """Chunked MLA attention of q_c/q_r [B,S,H,*] over k_c [B,T,H*nope],
    v [B,T,H*v] and k_r [B,T,rd]: [B,S,H*v]."""
    b, s, h, _ = q_c.shape
    t = k_c.shape[1]
    k_c = k_c.reshape(b, t, h, MLA_NOPE)
    v = v.reshape(b, t, h, MLA_V)
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
    return torch.cat(outs, dim=1).reshape(b, s, h * MLA_V)


def _mla_full(p, x, cfg: ModelConfig, positions, *, qc: int, ctx):
    """Causal MLA over the sequence: (y, c_kv, rotated k_r). On a mesh
    each rank attends with its own heads (every head where the head
    count does not divide "model")."""
    q, c_kv, kr = _mla_proj(p, x, cfg)
    k_c, v = _mla_kv(p, c_kv)

    def body(q, kr, k_c, v):
        q_c, q_r, k_r = _mla_rope(q, kr, cfg, positions)
        return _mla_core(q_c, q_r, k_c, v, k_r, cfg, causal=True,
                         q_offset=0, qc=qc), k_r

    dp, hp = dp_part(ctx), heads_part(ctx, cfg.n_heads, cfg.n_heads)
    heads, rep = (dp, None, hp), (dp, None, None)
    out, k_r = local_call(ctx, body, [q, kr, k_c, v],
                          [heads, rep, heads, heads], [heads, rep],
                          vary=() if hp is None else (ctx.tp_axis,))
    return out @ p["wo"], c_kv, k_r


def mla_train(p, x, cfg: ModelConfig, positions, *, qc: int = 1024,
              ctx=None):
    return _mla_full(p, x, cfg, positions, qc=qc, ctx=ctx)[0]


def mla_prefill(p, x, cfg: ModelConfig, positions, *, qc: int = 256,
                ctx=None):
    """Returns (y, cache{c_kv [B,S,r], k_r [B,S,rd]})."""
    y, c_kv, k_r = _mla_full(p, x, cfg, positions, qc=qc, ctx=ctx)
    return y, {"c_kv": c_kv, "k_r": k_r}


def _mla_decode_attend(q_c, q_r, k_c, v, k_r, cfg: ModelConfig, pos: int):
    """One query position against the whole cache: [B,1,H*v]."""
    b, _, h, _ = q_c.shape
    t = k_c.shape[1]
    k_c = k_c.reshape(b, t, h, MLA_NOPE)
    v = v.reshape(b, t, h, MLA_V)
    scores = _mla_scores(q_c, q_r, k_c.float(), k_r.float(), _mla_scale(cfg))
    mask = torch.arange(t, device=q_c.device) <= pos
    scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bhqt,bthd->bqhd", probs, v).reshape(b, 1, -1)


def mla_decode(p, x, cache, cfg: ModelConfig, pos: int, ctx=None):
    """x [B,1,D]; cache c_kv [B,S,r] and k_r [B,S,rd]; pos an int. Writes
    the step's c_kv and k_r at `pos` in place, then recomputes the keys
    and values from the whole c_kv cache (the JAX package's form; the
    absorbed form rounds otherwise). Returns (y [B,1,D], the cache). On a
    mesh the write lands on the rank holding `pos`, and the attention
    reads the cache gathered over "model" with every head on every
    rank."""
    pos = _check_pos(pos, cache["c_kv"].shape[1])
    positions = torch.full((1,), pos, dtype=torch.int64, device=x.device)
    q, c_new, kr = _mla_proj(p, x, cfg)
    c_kv, k_r = cache["c_kv"], cache["k_r"]
    dp = dp_part(ctx)
    rep3, rep4 = (dp, None, None), (dp, None, None, None)
    q_c, q_r, kr_new = local_call(
        ctx, lambda q, kr: _mla_rope(q, kr, cfg, positions), [q, kr],
        [rep3, rep3], [rep4, rep4, rep3])
    write_at(c_kv, c_new, 1, pos)
    write_at(k_r, kr_new, 1, pos)
    k_c, v = _mla_kv(p, constrain(c_kv, ctx, *rep3))
    out = local_call(
        ctx, lambda q_c, q_r, k_c, v, k_r: _mla_decode_attend(
            q_c, q_r, k_c, v, k_r, cfg, pos),
        [q_c, q_r, k_c, v, k_r], [rep4, rep4, rep3, rep3, rep3], rep3)
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


def cross_kv(p, enc_out, cfg: ModelConfig, ctx=None):
    """The encoder's K/V [B, T, H, hd] for one decoder layer; on a mesh
    the heads over "model" where they divide it."""
    k, v = enc_out @ p["wk"], enc_out @ p["wv"]
    dp, hp = dp_part(ctx), heads_part(ctx, cfg.n_heads, cfg.n_heads)
    split = lambda t: t.reshape(t.shape[0], t.shape[1], -1, cfg.hd)
    k, v = local_call(ctx, lambda k, v: (split(k), split(v)), [k, v],
                      [(dp, None, hp)] * 2, [(dp, None, hp, None)] * 2)
    return {"k": k, "v": v}


def cross_attend(p, x, kv, cfg: ModelConfig, *, qc: int = 1024, ctx=None):
    """x's queries over the encoder's K/V, unmasked; on a mesh each rank
    attends with its heads."""
    dp, hp = dp_part(ctx), heads_part(ctx, cfg.n_heads, cfg.n_heads)

    def body(q, k, v):
        b, s = q.shape[:2]
        out = _attend_chunked(q.reshape(b, s, -1, cfg.hd), k, v,
                              causal=False, window=0, q_offset=0, qc=qc,
                              n_rep=1)
        return out.reshape(b, s, -1)

    out = local_call(ctx, body, [x @ p["wq"], kv["k"], kv["v"]],
                     [(dp, None, hp)] + [(dp, None, hp, None)] * 2,
                     (dp, None, hp))
    return out @ p["wo"]
