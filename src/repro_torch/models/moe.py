"""Dense MLPs and the Mixture-of-Experts layer.

The gated SiLU MLP of the dense decoders, the ungated GELU MLP of the
encoder-decoder family, and the MoE layer of grok-1 and deepseek-v2.

The MoE layer runs the JAX package's per-shard body (`_moe_local`). On
one device the whole expert set is local. On a mesh (`ctx.mesh`) the body
runs on each rank (`common.local_call`, the JAX package's `shard_map`):
tokens are data-sharded and replicated across the tensor-parallel
("model") axis, and the expert weights split over "model" —
expert-parallel ([E, ...] split: each rank takes its slice of the slot
table and fills its rows of the [E, C, D] buffer) where E divides the
axis, else tensor-parallel inside every expert ([.., F, ..] split).
Either way each rank computes a partial output and one sum over "model"
combines them (the JAX package's `psum`); the aux loss is averaged over
the data ranks (its `pmean`). Capacity counts each rank's own tokens.

Dispatch is gather-based, as in the JAX package: top-k assignment ->
position-in-expert by cumsum (token-major, slot-minor) -> an int [E, C]
slot table -> row gather into dense [E, C, D] expert batches.
Capacity C = max(4, ceil(T·k/E·capacity_factor) rounded down to a
multiple of 4); an assignment past C drops (contributes zero).

The JAX package writes the slot table with a scatter whose indices
repeat: every overflowing assignment writes -1 at slot C - 1, the slot
of that expert's last in-capacity token, and on XLA's CPU the -1 wins.
That token still counts as valid in the combine but reads a zeroed
slot, so it gets nothing from that expert. The port keeps that result
and builds the table without a repeated write (a scatter with repeated
indices is nondeterministic on CUDA): the valid assignments first, then
-1 at slot C - 1 of each expert whose load passed C.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import (ParamDesc, batch_axes, constrain,
                                       dp_part, local_call, on_mesh,
                                       shard_act)


def gelu(x):
    """The JAX package's `jax.nn.gelu`, whose default is the tanh form."""
    return F.gelu(x, approximate="tanh")


# ---------------------------- dense MLP ----------------------------

def mlp_desc(cfg: ModelConfig, d_ff: int | None = None,
             gated: bool = True) -> dict:
    d = cfg.d_model
    f = d_ff if d_ff is not None else cfg.d_ff
    p = {"w_up": ParamDesc((d, f), tp=1, fsdp=0),
         "w_down": ParamDesc((f, d), tp=0, fsdp=1)}
    if gated:
        p["w_gate"] = ParamDesc((d, f), tp=1, fsdp=0)
    return p


def mlp_apply(p, x, *, gated: bool = True, act=F.silu, ctx=None):
    up = x @ p["w_up"]
    h = act(x @ p["w_gate"]) * up if gated else act(up)
    return shard_act(h, ctx, tp_last=True) @ p["w_down"]


# ---------------------------- MoE ----------------------------

def moe_desc(cfg: ModelConfig) -> dict:
    d, e, f = cfg.d_model, cfg.n_experts, cfg.moe_d_ff or cfg.d_ff
    ep = e % 16 == 0  # the JAX package's layout hint: experts split over TP
    p = {
        "wg": ParamDesc((d, e)),                               # router gate
        "w_gate": ParamDesc((e, d, f), tp=0 if ep else 2, fsdp=1),
        "w_up": ParamDesc((e, d, f), tp=0 if ep else 2, fsdp=1),
        "w_down": ParamDesc((e, f, d), tp=0 if ep else 1, fsdp=2),
    }
    if cfg.n_shared_experts:
        p["shared"] = mlp_desc(cfg, d_ff=cfg.n_shared_experts * f)
    return p


def capacity(t: int, cfg: ModelConfig) -> int:
    """Slots an expert holds for `t` tokens (the JAX package's formula)."""
    e, k = cfg.n_experts, cfg.experts_per_token
    return max(4, int(t * k / e * cfg.capacity_factor + 0.999) // 4 * 4)


def dispatch(x, wg, cfg: ModelConfig) -> dict:
    """The gate and the slot table for tokens x [T, D].

    Returns {"logits" [T, E] fp32, "gidx" [T, k] (the top-k experts,
    ties to the lowest index as `jax.lax.top_k`), "weights" [T, k] fp32
    (softmax of the top-k logits), "flat_e" [T·k], "slot_pos" [T·k] (the
    assignment's place in its expert, token-major and slot-minor),
    "valid" [T·k] (slot_pos < cap), "table" [E, cap] int64 (the source
    token of each slot, -1 empty; -1 at cap - 1 of an expert that
    overflowed), "onehot" [T·k, E], "cap"}."""
    t = x.shape[0]
    e, k = cfg.n_experts, cfg.experts_per_token
    cap = capacity(t, cfg)
    logits = x.float() @ wg.float()                                # [T, E]
    gval, gidx = torch.sort(logits, dim=-1, descending=True, stable=True)
    gval, gidx = gval[:, :k], gidx[:, :k]
    weights = torch.softmax(gval, dim=-1)                          # [T, k]

    flat_e = gidx.reshape(-1)                                      # [T*k]
    onehot = F.one_hot(flat_e, e)                                  # [T*k, E]
    pos = torch.cumsum(onehot, dim=0) - onehot                     # before
    slot_pos = pos.gather(1, flat_e[:, None])[:, 0]
    valid = slot_pos < cap

    tok_ids = torch.arange(t, device=x.device).repeat_interleave(k)
    # each assignment's slot in the flat table, an overflowing one a
    # place of its own past the table: every index written once, and no
    # shape that depends on the values
    dest = torch.where(valid, flat_e * cap + slot_pos,
                       e * cap + torch.arange(t * k, device=x.device))
    table = torch.full((e * cap + t * k,), -1, dtype=torch.int64,
                       device=x.device).scatter_(0, dest, tok_ids)
    table = table[:e * cap].view(e, cap)
    table[:, cap - 1] = torch.where(onehot.sum(0) > cap, -1,
                                    table[:, cap - 1])
    return {"logits": logits, "gidx": gidx, "weights": weights,
            "flat_e": flat_e, "slot_pos": slot_pos, "valid": valid,
            "table": table, "onehot": onehot, "cap": cap}


def _moe_local(x, wg, w_gate, w_up, w_down, *, cfg: ModelConfig,
               expert_parallel: bool = False, tp_index: int = 0):
    """The MoE body on one rank: x [T, D] -> (y [T, D], aux loss).

    The expert weights are the rank's: expert-parallel [E_loc, D, F]
    (experts tp_index·E_loc onwards), else [E, D, F_loc]; on one device
    all of them. y is the rank's part of the output (the whole output on
    one device)."""
    t, d = x.shape
    e, k = cfg.n_experts, cfg.experts_per_token
    g = dispatch(x, wg, cfg)
    table, cap = g["table"], g["cap"]

    e_loc = w_gate.shape[0]
    if expert_parallel:
        table = table[tp_index * e_loc:(tp_index + 1) * e_loc]
    occupied = table >= 0
    xin = x[table.clamp(min=0)]                                    # [E, C, D]
    xin = xin * occupied[..., None].to(x.dtype)
    h = F.silu(torch.einsum("ecd,edf->ecf", xin, w_gate)) * \
        torch.einsum("ecd,edf->ecf", xin, w_up)
    out = torch.einsum("ecf,efd->ecd", h, w_down)                  # [E, C, D]
    if expert_parallel:     # the rank's experts in the full [E, C, D]
        out = torch.cat([out.new_zeros((tp_index * e_loc, cap, d)), out,
                         out.new_zeros((e - (tp_index + 1) * e_loc, cap,
                                        d))])

    # combine: route each slot's output back to its token, weighted
    slot_out = out[g["flat_e"], g["slot_pos"].clamp(max=cap - 1)]  # [T*k, D]
    slot_out = slot_out * g["valid"][:, None].to(out.dtype)
    y = torch.einsum("tkd,tk->td", slot_out.reshape(t, k, d),
                     g["weights"].to(out.dtype))

    # load-balance auxiliary loss (Switch-style), for training metrics
    me = torch.mean(torch.softmax(g["logits"], -1), dim=0)
    ce = torch.mean(g["onehot"].reshape(t, k, e).sum(1).float(), dim=0)
    aux = e * torch.sum(me * ce)
    return y, aux


def moe_apply(p, x, cfg: ModelConfig, ctx=None):
    """x [B, S, D] -> (y, aux_loss): every one of the B·S rows dispatches
    (padded prompt positions too, as in the JAX package), then the
    shared experts' MLP is added. On a mesh (`ctx.mesh`) each rank
    dispatches its own rows (see the module docstring)."""
    b, s, d = x.shape
    if on_mesh(ctx):
        y, aux = _moe_mesh(p, x, cfg, ctx)
    else:
        y, aux = _moe_local(x.reshape(b * s, d), p["wg"], p["w_gate"],
                            p["w_up"], p["w_down"], cfg=cfg)
        y = y.reshape(b, s, d)
    if cfg.n_shared_experts:
        y = y + mlp_apply(p["shared"], x)
    return y, aux


def _moe_mesh(p, x, cfg: ModelConfig, ctx):
    """The MoE layer over `ctx.mesh`: (y [B, S, D], aux)."""
    b, s, d = x.shape
    tp, mesh = ctx.tp_axis, ctx.mesh
    ep = cfg.n_experts % ctx.tp_size == 0 and ctx.tp_size > 1
    dp = dp_part(ctx)
    every = batch_axes(ctx) + (tp,)
    xf = constrain(x, ctx, dp, None, None).reshape(b * s, d)
    if ep:
        w13 = w2 = (tp, None, None)
    else:
        w13, w2 = (None, None, tp), (None, tp, None)

    def body(xl, wg, w_gate, w_up, w_down):
        y, aux = _moe_local(xl, wg, w_gate, w_up, w_down, cfg=cfg,
                            expert_parallel=ep,
                            tp_index=mesh.get_local_rank(tp))
        return y[None], aux.reshape(1)

    # each rank's partial y stacked over "model", summed; the aux loss
    # stacked over every rank (the same on the "model" ranks), averaged
    y, aux = local_call(
        ctx, body, [xf, p["wg"], p["w_gate"], p["w_up"], p["w_down"]],
        [(dp, None), (None, None), w13, w13, w2],
        [(tp, dp, None), (every,)], vary=every)
    y = constrain(y.sum(0), ctx, dp, None)
    return y.reshape(b, s, d), aux.mean(0)
