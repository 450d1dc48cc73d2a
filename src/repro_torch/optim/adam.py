"""AdamW on the port's parameter trees (nested dicts and tuples of
tensors), shared by the LM trainer and the router MLPs, with the JAX
package's arithmetic.

`compress=True` stores both moments as int8 in the parameter's own shape,
with one fp32 scale per block of `block` elements along the last axis
(the whole axis where `block` does not tile it): the JAX package's 8-bit
moments, dequantized, updated and requantized inside each step. The
scale is max|x|/127 + 1e-12 and the rounding half to even, as there, so
the int8 moments and their scales equal the JAX package's bit for bit.

The update runs in place, leaf by leaf in `jax.tree.flatten`'s order,
and within a leaf over slices of whole rows of the last axis (at most
SLICE_ELEMS elements; a quantization block never spans two rows), so the
fp32 temporaries of one slice are all that exist at once: deepseek-v2's
expert weights are [160, 5120, 1536], 1.26 B elements, 5.0 GB for each
fp32 temporary of the whole leaf. Elementwise arithmetic and per-row
blocks give the same bits sliced or whole.

The step counter is an int32 0-d tensor on the host, and the bias
corrections are computed on the host in fp32 (`1 - b^t`, as the JAX
package computes them), so a step reads nothing back from the card.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.models.common import ParamDesc, map_descs, tree_leaves

# The most elements of one leaf that a step updates at once (256 MB of
# fp32 a temporary).
SLICE_ELEMS = 1 << 26


@dataclasses.dataclass(frozen=True)
class AdamConfig:
    lr: float = 1e-3
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    compress: bool = False       # 8-bit moment storage
    block: int = 256             # quantization block size (last axis)


def _block_of(n: int, block: int) -> int:
    return block if (n % block == 0 and n >= block) else n


def _quantize(x: torch.Tensor, block: int):
    """x [*, n] fp32 -> (q int8 [*, n], scale fp32 [*, n/blk])."""
    n = x.shape[-1]
    blk = _block_of(n, block)
    xb = x.reshape(x.shape[:-1] + (n // blk, blk))
    scale = torch.amax(torch.abs(xb), dim=-1, keepdim=True) / 127.0 + 1e-12
    q = torch.clamp(torch.round(xb / scale), -127, 127).to(torch.int8)
    return q.reshape(x.shape), scale[..., 0]


def _dequantize(q: torch.Tensor, scale: torch.Tensor, block: int):
    n = q.shape[-1]
    blk = _block_of(n, block)
    qb = q.reshape(q.shape[:-1] + (n // blk, blk)).float()
    return (qb * scale[..., None]).reshape(q.shape)


def _scale_shape(shape: tuple, block: int) -> tuple:
    n = shape[-1]
    return tuple(shape[:-1]) + (n // _block_of(n, block),)


# ---- state ------------------------------------------------------------------

def adam_init(params: Any, cfg: AdamConfig):
    """Zero moments on each parameter's device: fp32 in its shape, or
    int8 zeros with the scales of a zero block (1e-12) under
    `compress`."""
    def zeros_like(p):
        if cfg.compress:
            return {"q": torch.zeros(p.shape, dtype=torch.int8,
                                     device=p.device),
                    "s": torch.full(_scale_shape(p.shape, cfg.block), 1e-12,
                                    dtype=torch.float32, device=p.device)}
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    return {"step": torch.zeros((), dtype=torch.int32),
            "mu": map_descs(zeros_like, params),
            "nu": map_descs(zeros_like, params)}


def adam_state_desc(param_desc: Any, cfg: AdamConfig):
    """ParamDesc tree of the optimizer state (the shapes a checkpoint's
    restore checks against)."""
    def moment(d: ParamDesc):
        if not cfg.compress:
            return ParamDesc(d.shape, torch.float32, tp=d.tp, fsdp=d.fsdp)
        n = d.shape[-1]
        nb = n // _block_of(n, cfg.block)
        last = len(d.shape) - 1

        def keep(ax):
            return None if ax is None or (ax == last and nb != n) else ax
        return {"q": ParamDesc(d.shape, torch.int8, tp=d.tp, fsdp=d.fsdp),
                "s": ParamDesc(_scale_shape(d.shape, cfg.block),
                               torch.float32, tp=keep(d.tp),
                               fsdp=keep(d.fsdp))}

    return {"step": ParamDesc((), torch.int32),
            "mu": map_descs(moment, param_desc),
            "nu": map_descs(moment, param_desc)}


# ---- update -----------------------------------------------------------------

def leaf_rows(t: torch.Tensor) -> torch.Tensor:
    """The contiguous `t` as a [rows, last axis] view: writes into it
    write into `t`."""
    if not t.is_contiguous():
        raise ValueError("the optimizer updates contiguous tensors in place")
    return t.view(-1, t.shape[-1])


def row_ranges(shape: tuple) -> list:
    """Slices of whole rows of the last axis of a leaf of `shape`, each of
    at most SLICE_ELEMS elements (one slice for a small leaf)."""
    n = shape[-1]
    rows = int(np.prod(shape[:-1]))
    step = max(1, SLICE_ELEMS // max(n, 1))
    return [slice(r, r + step) for r in range(0, rows, step)]


def bias_corrections(step: int, cfg: AdamConfig) -> tuple:
    """(1 - b1^t, 1 - b2^t) in fp32, t = step, as Python floats (exactly
    the fp32 values)."""
    t = np.float32(step)
    return (float(np.float32(1.0) - np.float32(cfg.b1) ** t),
            float(np.float32(1.0) - np.float32(cfg.b2) ** t))


def adam_update(grads: Any, state: Any, params: Any, cfg: AdamConfig,
                lr_scale=1.0):
    """One AdamW step, in place: each parameter, moment and scale tensor
    is overwritten, and `state["step"]` replaced by the next count.
    Returns (params, state), the same objects. Leaves are visited in
    `jax.tree.flatten`'s order and each leaf's slices one after another,
    under `torch.no_grad()`."""
    step = int(state["step"]) + 1
    bc1, bc2 = bias_corrections(step, cfg)
    lr = cfg.lr * float(lr_scale)

    def upd(p, g, mu, nu):
        g = g.float()
        if cfg.compress:
            mu_f = _dequantize(mu["q"], mu["s"], cfg.block)
            nu_f = _dequantize(nu["q"], nu["s"], cfg.block)
        else:
            mu_f, nu_f = mu, nu
        mu_f = cfg.b1 * mu_f + (1 - cfg.b1) * g
        nu_f = cfg.b2 * nu_f + (1 - cfg.b2) * (g * g)
        update = (mu_f / bc1) / (torch.sqrt(nu_f / bc2) + cfg.eps)
        p32 = p.float()
        p.copy_(p32 - lr * (update + cfg.weight_decay * p32))
        if cfg.compress:
            for m, new in ((mu, mu_f), (nu, nu_f)):
                q, s = _quantize(new, cfg.block)
                m["q"].copy_(q)
                m["s"].copy_(s)
        else:
            mu.copy_(mu_f)
            nu.copy_(nu_f)

    leaves = zip(tree_leaves(params), flatten_up_to(params, grads),
                 flatten_up_to(params, state["mu"]),
                 flatten_up_to(params, state["nu"]))
    with torch.no_grad():
        for p, g, mu, nu in leaves:
            p2, g2 = leaf_rows(p), leaf_rows(g.contiguous())
            if cfg.compress:
                m2 = [leaf_rows(m[k]) for m in (mu, nu) for k in ("q", "s")]
            else:
                m2 = [leaf_rows(mu), leaf_rows(nu)]
            for r in row_ranges(p.shape):
                mq = [t[r] for t in m2]
                if cfg.compress:
                    upd(p2[r], g2[r], {"q": mq[0], "s": mq[1]},
                        {"q": mq[2], "s": mq[3]})
                else:
                    upd(p2[r], g2[r], mq[0], mq[1])
    state["step"] = torch.tensor(step, dtype=torch.int32)
    return params, state


def flatten_up_to(like, tree) -> list:
    """`tree`'s subtrees at the positions of `like`'s leaves, in
    `tree_leaves` order (`treedef.flatten_up_to`): a moment tree gives
    each parameter's fp32 tensor, or its {"q", "s"} dict."""
    if isinstance(like, dict):
        return [x for k in sorted(like) for x in flatten_up_to(like[k],
                                                                tree[k])]
    if isinstance(like, (tuple, list)):
        return [x for a, b in zip(like, tree) for x in flatten_up_to(a, b)]
    return [tree]
