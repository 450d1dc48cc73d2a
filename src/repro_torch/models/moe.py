"""Dense MLPs and the Mixture-of-Experts layer.

The gated SiLU MLP of the dense decoders, the ungated GELU MLP of the
encoder-decoder family, and the MoE layer of grok-1 and deepseek-v2 on
one device: the JAX package's per-shard body (`_moe_local`) with the
whole expert set local, so its `shard_map` and its `psum` over the
tensor-parallel axis fall away (ROADMAP.md queue 1 item 3 brings the
expert-parallel layout back).

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
from repro_torch.models.common import ParamDesc


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


def mlp_apply(p, x, *, gated: bool = True, act=F.silu):
    up = x @ p["w_up"]
    h = act(x @ p["w_gate"]) * up if gated else act(up)
    return h @ p["w_down"]


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
    table = torch.full((e, cap), -1, dtype=torch.int64, device=x.device)
    table[flat_e[valid], slot_pos[valid]] = tok_ids[valid]
    table[onehot.sum(0) > cap, cap - 1] = -1
    return {"logits": logits, "gidx": gidx, "weights": weights,
            "flat_e": flat_e, "slot_pos": slot_pos, "valid": valid,
            "table": table, "onehot": onehot, "cap": cap}


def _moe_local(x, wg, w_gate, w_up, w_down, *, cfg: ModelConfig):
    """The MoE body on one device: x [T, D] -> (y [T, D], aux loss)."""
    t, d = x.shape
    e, k = cfg.n_experts, cfg.experts_per_token
    g = dispatch(x, wg, cfg)
    table, cap = g["table"], g["cap"]

    occupied = table >= 0
    xin = x[table.clamp(min=0)]                                    # [E, C, D]
    xin = xin * occupied[..., None].to(x.dtype)
    h = F.silu(torch.einsum("ecd,edf->ecf", xin, w_gate)) * \
        torch.einsum("ecd,edf->ecf", xin, w_up)
    out = torch.einsum("ecf,efd->ecd", h, w_down)                  # [E, C, D]

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
    shared experts' MLP is added. `ctx` is unused on one device."""
    b, s, d = x.shape
    y, aux = _moe_local(x.reshape(b * s, d), p["wg"], p["w_gate"],
                        p["w_up"], p["w_down"], cfg=cfg)
    y = y.reshape(b, s, d)
    if cfg.n_shared_experts:
        y = y + mlp_apply(p["shared"], x)
    return y, aux
