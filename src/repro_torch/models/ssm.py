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
under autograd; prefill (`mlstm_prefill`, `mamba_prefill`) masks the
writes past the prompt, as the JAX package's `forward_prefill` does. The
non-causal pairs' exponents are -inf before the `exp` (a `masked_fill`),
so their weights and their gradients are 0, never inf · 0 = NaN.
Training runs the sLSTM's time loop as one autograd node
(`_SLSTMLoop`): the same values and gradients as the unrolled loop.

On a mesh (`ctx.mesh`) the projections are DTensor matmuls and the
gates, the scan and the decode step run on each rank's heads inside one
`common.local_call`: the heads over "model" where the head count divides
it, else every head on every rank; the batch over the data axes.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.attention import heads_part
from repro_torch.models.common import (ParamDesc, batch_axes, dp_part,
                                       local_call, uniform_range)


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
# the recurrent layers on a mesh
# ---------------------------------------------------------------------------

def _parts(ctx, n_heads: int):
    """(the batch's spec entry, the heads'): heads over "model" where
    `n_heads` divides it, else every head on every rank (the rule the
    attention follows, `attention.heads_part`)."""
    return dp_part(ctx), heads_part(ctx, n_heads, n_heads)


def _mask_writes(k, log_f, valid):
    """Zero recurrent writes (k) and freeze decay (f = 1) past the prompt:
    `valid` [S] bool, None when every position is real."""
    if valid is None:
        return k, log_f
    return torch.where(valid[None, :, None, None], k, 0).to(k.dtype), \
        torch.where(valid[None, :, None], log_f, 0.0)


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


def _mlstm_proj(p, x) -> list:
    """The projections: q, k, v and the output gate [B, S, H*hd], and the
    forget and input gates' fp32 logits [B, S, H]."""
    return [x @ p["wq"], x @ p["wk"], x @ p["wv"], x @ p["wo_gate"],
            (x @ p["wf"]).float(), (x @ p["wi"]).float()]


def _mlstm_gates(q, k, v, o, f, i, hd: int):
    """The projections of `_mlstm_proj` (a rank's heads on a mesh) as
    (q, k, v [B, S, heads, hd], log_f [B, S, heads], o)."""
    b, s = q.shape[:2]
    q = q.reshape(b, s, -1, hd)
    k = k.reshape(b, s, -1, hd)
    k = k / _as_dtype(k, np.sqrt(np.float32(hd)))
    v = v.reshape(b, s, -1, hd)
    log_f = F.logsigmoid(f)                                         # [B,S,H]
    i_gate = torch.exp(torch.clamp(i, max=8.0))
    k = k * i_gate[..., None].to(k.dtype)   # fold input gate into writes
    return q, k, v, log_f, torch.sigmoid(o)


def _mlstm_qkvgates(p, x, cfg: ModelConfig):
    return _mlstm_gates(*_mlstm_proj(p, x), cfg.hd)


def _mlstm(p, x, cfg: ModelConfig, ctx, state=None, *, chunk: int = 256,
           valid=None, decode: bool = False):
    """The mLSTM mixer: (y [B, S, D], the final state). The projections
    are the mesh's matmuls; the gates and the scan (or the decode step)
    run on each rank's heads."""
    dp, hp = _parts(ctx, cfg.n_heads)
    flat, st_part = (dp, None, hp), (dp, hp, None, None)

    def body(q, k, v, o, f, i, *st):
        b, s = q.shape[:2]
        q, k, v, log_f, o = _mlstm_gates(q, k, v, o, f, i, cfg.hd)
        if decode:
            y, st = gla_decode_step(q, k, v, log_f, st[0])
        else:
            k, log_f = _mask_writes(k, log_f, valid)
            y, st = gla_chunk_scan(q, k, v, log_f, chunk=chunk)
        return y.reshape(b, s, -1) * o, st

    ins = _mlstm_proj(p, x) + ([] if state is None else [state])
    y, st = local_call(ctx, body, ins, [flat] * len(ins[:6])
                       + [st_part] * (state is not None), [flat, st_part])
    return y @ p["wo"], st


def mlstm_train(p, x, cfg: ModelConfig, *, chunk: int = 256, ctx=None):
    return _mlstm(p, x, cfg, ctx, chunk=chunk)[0]


def mlstm_prefill(p, x, cfg: ModelConfig, *, chunk: int = 256, valid=None,
                  ctx=None):
    """(y, the state after the prompt); `valid` as `_mask_writes`'s."""
    return _mlstm(p, x, cfg, ctx, chunk=chunk, valid=valid)


def mlstm_decode(p, x, state, cfg: ModelConfig, ctx=None):
    return _mlstm(p, x, cfg, ctx, state, decode=True)


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


def _slstm_cell(gxt, wr, c, n, hprev, m, valid_t=None):
    """One time step, head-major: gxt [H, B, 4hd], wr [H, hd, 4hd], the
    state (c, n, hprev, m) each [H, B, hd]. Returns (h fp32, c, n, the
    next step's h in gxt's dtype, m). Each of the JAX package's shared
    terms is computed once; `valid_t` False writes nothing (i = 0) and
    keeps the state (f = 1)."""
    g = gxt + torch.bmm(hprev, wr)
    gi, gf, gz, go = torch.chunk(g.float(), 4, dim=-1)
    log_i = torch.clamp(gi, max=8.0)
    log_f = F.logsigmoid(gf)
    if valid_t is not None:
        log_i = torch.where(valid_t, log_i, -30.0)
        log_f = torch.where(valid_t, log_f, 0.0)
    fm = log_f + m
    m_new = torch.maximum(fm, log_i)
    keep = torch.exp(fm - m_new)
    write = torch.exp(log_i - m_new)
    c = keep * c + write * torch.tanh(gz)
    n = keep * n + write
    hnew = torch.sigmoid(go) * c / torch.clamp(n, min=1e-6)
    h_t = hnew.to(gxt.dtype)
    if valid_t is not None:
        h_t = torch.where(valid_t, h_t, hprev)
    return hnew, c, n, h_t, m_new


def _slstm_scan(gx, wr, state, valid=None, keep=None):
    """The time loop over gx [S, H, B, 4hd] from `state`: (hs [S, H, B,
    hd] fp32, the final state). `keep`, buffers [S, ...] one per state
    tensor, receive each step's input state."""
    hs = torch.empty(gx.shape[:1] + state[0].shape, dtype=torch.float32,
                     device=gx.device)
    for t in uniform_range(gx.shape[0]):
        if keep is not None:
            for buf, v in zip(keep, state):
                buf[t] = v
        hnew, *state = _slstm_cell(gx[t], wr, *state,
                                   None if valid is None else valid[t])
        hs[t] = hnew
    return hs, tuple(state)


class _SLSTMLoop(torch.autograd.Function):
    """`_slstm_scan` under autograd, as one node: the forward keeps every
    step's state, the backward runs the steps in reverse, each through
    autograd on that step's cell, and sums wr's gradient in that order
    (the order autograd's engine sums it in the unrolled loop). Every
    step of both loops runs the same operations, so the loops are
    `uniform_range`s, and gx's gradient lands in its step's rows with no
    full-size zeros a step."""

    @staticmethod
    def forward(ctx, gx, wr, c, n, h, m):
        bufs = [torch.empty(gx.shape[:1] + t.shape, dtype=t.dtype,
                            device=t.device) for t in (c, n, h, m)]
        hs, state = _slstm_scan(gx, wr, (c, n, h, m), keep=bufs)
        ctx.save_for_backward(gx, wr, *bufs)
        return (hs, *state)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, ghs, *gstate):
        gx, wr, *bufs = ctx.saved_tensors
        s = gx.shape[0]
        ghs = torch.zeros((s,) + bufs[0].shape[1:], dtype=torch.float32,
                          device=gx.device) if ghs is None else ghs
        carry = [torch.zeros_like(b[0]) if g is None else g
                 for g, b in zip(gstate, bufs)]
        dgx = torch.empty_like(gx)
        dwr = torch.zeros_like(wr)
        for t in uniform_range(s):
            t = s - 1 - t
            with torch.enable_grad():
                ins = [gx[t].detach().requires_grad_(),
                       wr.detach().requires_grad_()] + \
                    [b[t].detach().requires_grad_() for b in bufs]
                grads = torch.autograd.grad(_slstm_cell(*ins), ins,
                                            [ghs[t]] + carry)
            dgx[t] = grads[0]
            dwr += grads[1]
            carry = list(grads[2:])
        return (dgx, dwr, *carry)


def slstm_train(p, x, cfg: ModelConfig, state0=None, valid=None, ctx=None):
    """x [B,S,D] -> (y [B,S,D], state (c, n, h, m) each [B,H,hd]).

    valid: optional [S] bool — False positions write nothing (i=0) and
    keep state (f=1); used by padded-prefill serving. The serving paths
    call it for prefill and, with S = 1 and the cached state, decode;
    training without `valid`, through `_SLSTMLoop` where autograd
    records. On a mesh the recurrence runs on each rank's heads."""
    dp, hp = _parts(ctx, cfg.n_heads)
    flat, st_part = (dp, None, hp), (dp, hp, None)

    def body(gx, wr, *state):
        # the loop runs head-major ([H, B, ...]), so the recurrent product
        # is one bmm a step, with no permutes around it
        b, s = gx.shape[:2]
        gx = gx.reshape(b, s, -1, cfg.hd * 4).permute(1, 2, 0, 3)
        state = tuple(t.transpose(0, 1) for t in (state or slstm_init_state(
            cfg, b, h_dtype=gx.dtype, device=gx.device,
            n_heads=gx.shape[1])))
        if valid is None and torch.is_grad_enabled() and (
                gx.requires_grad or wr.requires_grad):
            hs, *state = _SLSTMLoop.apply(gx, wr, *state)
        else:
            hs, state = _slstm_scan(gx, wr, state, valid)
        y = hs.permute(2, 0, 1, 3).reshape(b, s, -1).to(gx.dtype)
        return (y, *(t.transpose(0, 1) for t in state))

    # wr is replicated over the data axes, whose ranks hold other rows:
    # its gradient sums over them (`vary`)
    ins = [x @ p["wx"], p["wr"]] + list(state0 or ())
    y, *state = local_call(ctx, body, ins, [flat, (hp, None, None)]
                           + [st_part] * len(ins[2:]), [flat] + [st_part] * 4,
                           vary=batch_axes(ctx))
    return y @ p["wo"], tuple(state)


def slstm_decode(p, x, state, cfg: ModelConfig, ctx=None):
    return slstm_train(p, x, cfg, state0=state, ctx=ctx)


def slstm_init_state(cfg: ModelConfig, batch: int, h_dtype=torch.float32,
                     device=None, n_heads: int | None = None):
    """(c, n, h, m) each [B, H, hd]: H is `n_heads` where given (a rank's
    heads on a mesh), else the config's."""
    z = torch.zeros((batch, n_heads or cfg.n_heads, cfg.hd),
                    dtype=torch.float32, device=device)
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


def _mamba_proj(p, x) -> list:
    """The values [B, S, H*hd], keys and queries [B, S, H*n], the step
    sizes' fp32 logits [B, S, H] and the decay bases [H]."""
    return [x @ p["w_in"], x @ p["w_b"], x @ p["w_c"],
            (x @ p["w_dt"]).float(), p["a_log"]]


def _mamba_gates(v, kk, q, dtl, a_log, cfg: ModelConfig):
    """The projections of `_mamba_proj` (a rank's heads on a mesh) as (q,
    k [B, S, heads, n], v [B, S, heads, hd], log_f [B, S, heads])."""
    b, s = v.shape[:2]
    v = v.reshape(b, s, -1, cfg.hd)
    kk = kk.reshape(b, s, -1, cfg.ssm_state)
    q = q.reshape(b, s, -1, cfg.ssm_state)
    # jax.nn.softplus is logaddexp(x, 0)
    dt = torch.logaddexp(dtl, torch.zeros((), device=dtl.device))  # [B,S,H]
    a = -torch.exp(a_log.float())                                    # [H] < 0
    log_f = dt * a[None, None, :]
    v = v * dt[..., None].to(v.dtype)          # Euler-step input scaling
    return q, kk, v, log_f


def _mamba_qkv(p, x, cfg: ModelConfig):
    return _mamba_gates(*_mamba_proj(p, x), cfg)


def _mamba(p, x, cfg: ModelConfig, ctx, state=None, *, chunk: int = 256,
           valid=None, decode: bool = False):
    """The Mamba heads: (y [B, S, D], the final state), the gates and the
    scan (or the decode step) on each rank's heads."""
    dp, hp = _parts(ctx, cfg.n_heads)
    flat, st_part = (dp, None, hp), (dp, hp, None, None)

    def body(v, kk, q, dtl, a_log, *st):
        b, s = v.shape[:2]
        q, kk, v, log_f = _mamba_gates(v, kk, q, dtl, a_log, cfg)
        if decode:
            y, st = gla_decode_step(q, kk, v, log_f, st[0], normalize=False)
        else:
            kk, log_f = _mask_writes(kk, log_f, valid)
            y, st = gla_chunk_scan(q, kk, v, log_f, chunk=chunk,
                                   normalize=False)
        return y.reshape(b, s, -1), st

    # a_log is replicated over the data axes: its gradient sums over them
    ins = _mamba_proj(p, x) + ([] if state is None else [state])
    y, st = local_call(ctx, body, ins, [flat] * 4 + [(hp,)]
                       + [st_part] * (state is not None), [flat, st_part],
                       vary=batch_axes(ctx))
    return y @ p["w_out"], st


def mamba_train(p, x, cfg: ModelConfig, *, chunk: int = 256, ctx=None):
    return _mamba(p, x, cfg, ctx, chunk=chunk)[0]


def mamba_prefill(p, x, cfg: ModelConfig, *, chunk: int = 256, valid=None,
                  ctx=None):
    """(y, the state after the prompt); `valid` as `_mask_writes`'s."""
    return _mamba(p, x, cfg, ctx, chunk=chunk, valid=valid)


def mamba_decode(p, x, state, cfg: ModelConfig, ctx=None):
    return _mamba(p, x, cfg, ctx, state, decode=True)


def mamba_state_shape(cfg: ModelConfig, batch: int):
    return (batch, cfg.n_heads, cfg.ssm_state, cfg.hd)
