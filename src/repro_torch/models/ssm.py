"""Recurrent sequence mixers: the gated linear attention (GLA) chunk scan,
mLSTM (xLSTM's matrix memory), sLSTM (xLSTM's scalar memory, truly
recurrent) and Mamba-style SSD heads (Hymba), for serving and training.

mLSTM and Mamba prefill run the GLA recurrence in chunkwise-parallel
form, as the JAX package does: within a chunk, decay-weighted attention;
across chunks, a loop carries the [dk, dv] matrix state. Decode is the
one-token recurrent update. sLSTM loops over time.

On CUDA a chunk's running sum of log-decays is a log-step scan
(`chunk_cumsum`): CUDA's floating-point cumsum is nondeterministic, and
training runs in deterministic mode on the card.

One deliberate divergence (ROADMAP.md queue 1 item 7): the JAX package
weights a chunk's causal pairs by scaling the queries by exp(cum) and
the keys by exp(-cum), cum the running sum of the log-decays. exp(-cum)
passes fp32's range once a chunk's summed log-decay falls below about
-88 (at random init an xLSTM or Hymba prefill of about 110 tokens in one
chunk of 256), and its outputs turn non-finite. The port weights each
causal pair by exp(cum_q - cum_k) instead, every exponent <= 0: the same
quantity in exact arithmetic, finite where the JAX package's overflows.

The training forwards (`mlstm_train`, `mamba_train`) run the same scan
under autograd; prefill calls the scan itself, as the JAX package's
`forward_prefill` does. The non-causal pairs' exponents are -inf before
the `exp` (a `masked_fill`), so their weights and their gradients are 0,
never inf · 0 = NaN.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import ParamDesc


# ---------------------------------------------------------------------------
# GLA chunk scan: y_t = (q_t / z_t) · Σ_{u≤t} (∏_{j=u+1..t} f_j) k_u v_uᵀ
# ---------------------------------------------------------------------------

def log_step_cumsum(x, dim: int = 1):
    """The inclusive cumsum of `x` along `dim` as a log-step scan
    (Hillis-Steele): ceil(log2 n) rounds, round k adding each element's
    value 2^k places back. Elementwise adds and slices only, so it is
    deterministic on CUDA and differentiable; its sums round in another
    order than a sequential cumsum, within fp32 rounding."""
    n = x.shape[dim]
    k = 1
    while k < n:
        x = torch.cat([x.narrow(dim, 0, k),
                       x.narrow(dim, k, n - k) + x.narrow(dim, 0, n - k)],
                      dim)
        k *= 2
    return x


def chunk_cumsum(x):
    """The running sum of a chunk's log-decays [B, c, H] along c:
    `torch.cumsum` on the CPU; `log_step_cumsum` on CUDA, whose
    floating-point cumsum has no deterministic implementation (it raises
    under `torch.use_deterministic_algorithms`, which training runs
    under on the card)."""
    return log_step_cumsum(x, 1) if x.is_cuda else torch.cumsum(x, dim=1)


def gla_chunk_scan(q, k, v, log_f, state0=None, *, chunk: int = 256,
                   normalize: bool = True):
    """q,k [B,S,H,dk], v [B,S,H,dv], log_f [B,S,H] (≤0 decay logs).

    Returns (y [B,S,H,dv] in q's dtype, final state [B,H,dk,dv(+1)]
    fp32). If normalize, a ones-column is appended to v to carry the
    xLSTM normalizer n; outputs are divided by max(|q·n|, 1). The chunk
    must tile S, as in the JAX package."""
    b, s, h, dk = q.shape
    if normalize:
        v = torch.cat([v, torch.ones(v.shape[:-1] + (1,), dtype=v.dtype,
                                     device=v.device)], -1)
    dv = v.shape[-1]
    c = min(chunk, s)
    if s % c:
        raise ValueError(f"the GLA chunk {c} does not tile {s} positions")
    state = state0 if state0 is not None else torch.zeros(
        (b, h, dk, dv), dtype=torch.float32, device=q.device)
    causal = torch.tril(torch.ones((c, c), dtype=torch.bool,
                                   device=q.device))
    ys = []
    for ci in range(s // c):
        rows = slice(ci * c, (ci + 1) * c)
        qi, ki = q[:, rows].float(), k[:, rows].float()
        vi = v[:, rows].float()
        cum = chunk_cumsum(log_f[:, rows].float())                  # [B,c,H]
        tot = cum[:, -1:]                                           # [B,1,H]
        # intra-chunk: each causal pair (q >= k) weighted by
        # exp(cum_q - cum_k) <= 1; the other pairs by exp(-inf) = 0
        cum_h = cum.transpose(1, 2)                                 # [B,H,c]
        diff = (cum_h[..., :, None] - cum_h[..., None, :]).masked_fill(
            ~causal, float("-inf"))
        att = torch.einsum("bqhd,bkhd->bhqk", qi, ki) * torch.exp(diff)
        y_intra = torch.einsum("bhqk,bkhv->bqhv", att, vi)
        # inter-chunk contribution from the carried state
        qd = qi * torch.exp(cum)[..., None]
        y_inter = torch.einsum("bqhd,bhdv->bqhv", qd, state)
        # state update
        kdec = ki * torch.exp(tot - cum)[..., None]
        state = torch.exp(tot)[:, 0, :, None, None] * state + \
            torch.einsum("bkhd,bkhv->bhdv", kdec, vi)
        ys.append(y_intra + y_inter)
    y = torch.cat(ys, dim=1)
    if normalize:
        n = y[..., -1:]
        y = y[..., :-1] / torch.clamp(torch.abs(n), min=1.0)
    return y.to(q.dtype), state


def gla_decode_step(q1, k1, v1, log_f1, state, *, normalize: bool = True):
    """One-token recurrent update. q1/k1 [B,1,H,dk], v1 [B,1,H,dv],
    log_f1 [B,1,H], state [B,H,dk,dv(+1)]. Returns (y [B,1,H,dv], state)."""
    if normalize:
        v1 = torch.cat([v1, torch.ones(v1.shape[:-1] + (1,), dtype=v1.dtype,
                                       device=v1.device)], -1)
    f = torch.exp(log_f1.float())[:, 0, :, None, None]             # [B,H,1,1]
    kv = torch.einsum("bhd,bhv->bhdv", k1[:, 0].float(), v1[:, 0].float())
    state = f * state + kv
    y = torch.einsum("bhd,bhdv->bhv", q1[:, 0].float(), state)
    if normalize:
        n = y[..., -1:]
        y = y[..., :-1] / torch.clamp(torch.abs(n), min=1.0)
    return y[:, None].to(q1.dtype), state


def _as_dtype(x, value: float):
    """`value` as a 0-d tensor of x's dtype: the JAX package's weakly
    typed scalars round to the array's dtype before the operation."""
    return torch.tensor(np.float32(value), dtype=x.dtype, device=x.device)


# ---------------------------------------------------------------------------
# mLSTM block (xLSTM): matrix memory + exponential gating
# ---------------------------------------------------------------------------

def mlstm_desc(cfg: ModelConfig) -> dict:
    d, h, hd = cfg.d_model, cfg.n_heads, cfg.hd
    return {
        "wq": ParamDesc((d, h * hd), tp=1, fsdp=0),
        "wk": ParamDesc((d, h * hd), tp=1, fsdp=0),
        "wv": ParamDesc((d, h * hd), tp=1, fsdp=0),
        "wi": ParamDesc((d, h)),        # input gate (exp)
        "wf": ParamDesc((d, h)),        # forget gate
        "wo_gate": ParamDesc((d, h * hd), tp=1, fsdp=0),
        "wo": ParamDesc((h * hd, d), tp=0, fsdp=1),
    }


def _mlstm_qkvgates(p, x, cfg: ModelConfig):
    b, s, _ = x.shape
    h, hd = cfg.n_heads, cfg.hd
    q = (x @ p["wq"]).reshape(b, s, h, hd)
    k = (x @ p["wk"]).reshape(b, s, h, hd)
    k = k / _as_dtype(k, np.sqrt(np.float32(hd)))
    v = (x @ p["wv"]).reshape(b, s, h, hd)
    log_f = F.logsigmoid((x @ p["wf"]).float())                     # [B,S,H]
    i_gate = torch.exp(torch.clamp((x @ p["wi"]).float(), max=8.0))
    k = k * i_gate[..., None].to(k.dtype)   # fold input gate into writes
    o = torch.sigmoid(x @ p["wo_gate"])
    return q, k, v, log_f, o


def mlstm_train(p, x, cfg: ModelConfig, *, chunk: int = 256):
    b, s, _ = x.shape
    q, k, v, log_f, o = _mlstm_qkvgates(p, x, cfg)
    y, _ = gla_chunk_scan(q, k, v, log_f, chunk=chunk)
    y = y.reshape(b, s, -1) * o
    return y @ p["wo"]


def mlstm_decode(p, x, state, cfg: ModelConfig):
    b = x.shape[0]
    q, k, v, log_f, o = _mlstm_qkvgates(p, x, cfg)
    y, state = gla_decode_step(q, k, v, log_f, state)
    y = y.reshape(b, 1, -1) * o
    return y @ p["wo"], state


def mlstm_state_shape(cfg: ModelConfig, batch: int):
    return (batch, cfg.n_heads, cfg.hd, cfg.hd + 1)


# ---------------------------------------------------------------------------
# sLSTM block (xLSTM): scalar memory, h_{t-1} recurrence, a loop over time
# ---------------------------------------------------------------------------

def slstm_desc(cfg: ModelConfig) -> dict:
    d, h, hd = cfg.d_model, cfg.n_heads, cfg.hd
    return {
        "wx": ParamDesc((d, h * hd * 4), tp=1, fsdp=0),    # i,f,z,o from x
        "wr": ParamDesc((h, hd, hd * 4), tp=0, fsdp=1),    # block-diag recurrence
        "wo": ParamDesc((h * hd, d), tp=0, fsdp=1),
    }


def slstm_train(p, x, cfg: ModelConfig, state0=None, valid=None):
    """x [B,S,D] -> (y [B,S,D], state (c, n, h, m) each [B,H,hd]).

    valid: optional [S] bool — False positions write nothing (i=0) and
    keep state (f=1); used by padded-prefill serving. The serving paths
    call it for prefill and, with S = 1 and the cached state, decode;
    training without `valid`. A step is a few dozen small launches, so
    each shared term is computed once and `valid`'s selects are skipped
    when it is None (the same values)."""
    b, s, _ = x.shape
    h, hd = cfg.n_heads, cfg.hd
    # the loop runs head-major ([H, B, ...]), so the recurrent product is
    # one bmm a step, with no permutes around it
    gx = (x @ p["wx"]).reshape(b, s, h, hd * 4).permute(1, 2, 0, 3)
    c, n, hprev, m = (t.transpose(0, 1) for t in (
        state0 if state0 is not None else
        slstm_init_state(cfg, b, h_dtype=x.dtype, device=x.device)))
    ys = []
    for t in range(s):
        gxt = gx[t]
        g = gxt + torch.bmm(hprev, p["wr"])
        gi, gf, gz, go = torch.chunk(g.float(), 4, dim=-1)
        log_i = torch.clamp(gi, max=8.0)
        log_f = F.logsigmoid(gf)
        if valid is not None:
            log_i = torch.where(valid[t], log_i, -30.0)
            log_f = torch.where(valid[t], log_f, 0.0)
        fm = log_f + m
        m_new = torch.maximum(fm, log_i)
        keep = torch.exp(fm - m_new)            # the JAX package's terms,
        write = torch.exp(log_i - m_new)        # each computed once
        c = keep * c + write * torch.tanh(gz)
        n = keep * n + write
        hnew = torch.sigmoid(go) * c / torch.clamp(n, min=1e-6)
        h_t = hnew.to(gxt.dtype)
        hprev = h_t if valid is None else torch.where(valid[t], h_t, hprev)
        m = m_new
        ys.append(hnew)
    y = torch.stack(ys, dim=2).permute(1, 2, 0, 3).reshape(b, s, h * hd)
    y = y.to(x.dtype)
    return y @ p["wo"], tuple(t.transpose(0, 1) for t in (c, n, hprev, m))


def slstm_decode(p, x, state, cfg: ModelConfig):
    return slstm_train(p, x, cfg, state0=state)


def slstm_init_state(cfg: ModelConfig, batch: int, h_dtype=torch.float32,
                     device=None):
    z = torch.zeros((batch, cfg.n_heads, cfg.hd), dtype=torch.float32,
                    device=device)
    return (z, z, z.to(h_dtype), z - 10.0)


# ---------------------------------------------------------------------------
# Mamba-style SSD heads (Hymba): scalar-decay GLA with small state dim
# ---------------------------------------------------------------------------

def mamba_desc(cfg: ModelConfig) -> dict:
    d, h, n = cfg.d_model, cfg.n_heads, cfg.ssm_state
    hd = cfg.hd
    return {
        "w_in": ParamDesc((d, h * hd), tp=1, fsdp=0),     # values (x path)
        "w_b": ParamDesc((d, h * n)),                      # input proj B (keys)
        "w_c": ParamDesc((d, h * n)),                      # output proj C (queries)
        "w_dt": ParamDesc((d, h)),                         # per-head step size
        "a_log": ParamDesc((h,), zero=True),               # per-head decay base
        "w_out": ParamDesc((h * hd, d), tp=0, fsdp=1),
    }


def _mamba_qkv(p, x, cfg: ModelConfig):
    b, s, _ = x.shape
    h, n, hd = cfg.n_heads, cfg.ssm_state, cfg.hd
    v = (x @ p["w_in"]).reshape(b, s, h, hd)
    kk = (x @ p["w_b"]).reshape(b, s, h, n)
    q = (x @ p["w_c"]).reshape(b, s, h, n)
    # jax.nn.softplus is logaddexp(x, 0)
    dt = torch.logaddexp((x @ p["w_dt"]).float(),
                         torch.zeros((), device=x.device))           # [B,S,H]
    a = -torch.exp(p["a_log"].float())                               # [H] < 0
    log_f = dt * a[None, None, :]
    v = v * dt[..., None].to(v.dtype)          # Euler-step input scaling
    return q, kk, v, log_f


def mamba_train(p, x, cfg: ModelConfig, *, chunk: int = 256):
    b, s, _ = x.shape
    q, k, v, log_f = _mamba_qkv(p, x, cfg)
    y, _ = gla_chunk_scan(q, k, v, log_f, chunk=chunk, normalize=False)
    return y.reshape(b, s, -1) @ p["w_out"]


def mamba_decode(p, x, state, cfg: ModelConfig):
    b = x.shape[0]
    q, k, v, log_f = _mamba_qkv(p, x, cfg)
    y, state = gla_decode_step(q, k, v, log_f, state, normalize=False)
    return y.reshape(b, 1, -1) @ p["w_out"], state


def mamba_state_shape(cfg: ModelConfig, batch: int):
    return (batch, cfg.n_heads, cfg.ssm_state, cfg.hd)
