"""Step builders: the train step (grad-accum microbatching + remat +
clipping + AdamW) and the serve steps (prefill / decode), the JAX
package's `launch/steps.py` on one device.

The train step takes the gradients with `torch.autograd.grad` against
detached aliases of the parameters (the caller's tensors never get
`requires_grad`), then clips and updates the parameters and the optimizer
state in place: a step holds one set of parameters, one set of fp32
gradients (plus one microbatch's under accumulation) and the moments.
The JAX package's `with_sharding_constraint` on the microbatches has no
counterpart on one device.
"""

from __future__ import annotations

import torch

from repro_torch.ann.index import resolve_device
from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.models import common, lm
from repro_torch.optim import (AdamConfig, adam_init, adam_update,
                               clip_by_global_norm)


def default_opt_cfg(cfg: ModelConfig) -> AdamConfig:
    return AdamConfig(lr=3e-4, weight_decay=0.01, compress=cfg.opt_compress)


def accum_steps(cfg: ModelConfig, shape: ShapeSpec, dp_size: int) -> int:
    per_replica = max(1, shape.global_batch // dp_size)
    return max(1, per_replica // max(cfg.microbatch_seqs, 1))


def microbatch(batch: dict, i: int, accum: int) -> dict:
    """Microbatch i of `accum`: rows i, i + accum, ... (the JAX package's
    [B, ...] -> [accum, B/accum, ...] split, row b at (b % accum,
    b // accum))."""
    return {k: v[i::accum] for k, v in batch.items()}


def make_train_step(cfg: ModelConfig, ctx: lm.ModelCtx, *, accum: int,
                    opt_cfg: AdamConfig | None = None,
                    max_grad_norm: float = 1.0):
    """train_step(params, opt_state, batch) -> (params, opt_state,
    {"loss", "grad_norm", "step"}), the parameters and the state updated
    in place. The batch's rows split into `accum` microbatches whose fp32
    gradients are summed in order and divided by `accum`; then clipping
    to `max_grad_norm` and one AdamW step. "loss" is the forward's total
    (the mean over microbatches under accumulation)."""
    opt_cfg = opt_cfg or default_opt_cfg(cfg)

    def grads_of(params, mbatch):
        leaves = common.tree_leaves(params)
        live = [p.detach().requires_grad_() for p in leaves]
        tree = common.tree_unflatten(params, iter(live))
        total, _ = lm.forward_train(tree, mbatch, cfg, ctx)
        return total.detach(), torch.autograd.grad(total, live)

    def train_step(params, opt_state, batch):
        if batch["tokens"].shape[0] % accum:
            raise ValueError(f"batch of {batch['tokens'].shape[0]} rows does "
                             f"not split into {accum} microbatches")
        if accum == 1:
            loss, grads = grads_of(params, batch)
            grads = [g.float() for g in grads]
        else:
            grads = [torch.zeros(p.shape, dtype=torch.float32,
                                 device=p.device)
                     for p in common.tree_leaves(params)]
            loss = torch.zeros((), dtype=torch.float32,
                               device=batch["tokens"].device)
            for i in range(accum):
                mloss, mgrads = grads_of(params, microbatch(batch, i, accum))
                with torch.no_grad():
                    for a, g in zip(grads, mgrads):
                        a.add_(g.float())
                del mgrads
                loss = loss + mloss
            with torch.no_grad():
                for a in grads:
                    a.div_(accum)
            loss = loss / accum
        grads, gnorm = clip_by_global_norm(
            common.tree_unflatten(params, iter(grads)), max_grad_norm)
        params, opt_state = adam_update(grads, opt_state, params, opt_cfg)
        return params, opt_state, {"loss": loss, "grad_norm": gnorm,
                                   "step": opt_state["step"]}

    return train_step


def make_prefill_step(cfg: ModelConfig, ctx: lm.ModelCtx):
    def prefill_step(params, batch):
        return lm.forward_prefill(params, batch, cfg, ctx)
    return prefill_step


def make_decode_step(cfg: ModelConfig, ctx: lm.ModelCtx):
    def decode_step(params, cache, tokens, pos):
        return lm.forward_decode(params, cache, tokens, pos, cfg, ctx)
    return decode_step


def init_train_state(cfg: ModelConfig, seed: int,
                     opt_cfg: AdamConfig | None = None, device="cuda"):
    """Parameters drawn by `init_params(seed=)` in `cfg.param_dtype` on
    `device`, and their optimizer state."""
    opt_cfg = opt_cfg or default_opt_cfg(cfg)
    params = common.init_params(lm.model_desc(cfg), seed=seed,
                                device=resolve_device(device),
                                dtype=cfg.param_dtype)
    return params, adam_init(params, opt_cfg)
