"""Dense MLPs: the gated SiLU MLP of the dense decoders, and the ungated
GELU MLP of the encoder-decoder family.

The Mixture-of-Experts layer (grok-1, deepseek-v2) waits for its family
(ROADMAP.md queue 1 item 2b).
"""

from __future__ import annotations

import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import ParamDesc


def gelu(x):
    """The JAX package's `jax.nn.gelu`, whose default is the tanh form."""
    return F.gelu(x, approximate="tanh")


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

