"""Meta-device input stand-ins and partition specs for every
(architecture × input shape × mesh) cell, the JAX package's
`launch/specs.py`. Nothing is allocated: the stand-ins are tensors on
the `meta` device, and the specs are `models.common.PartitionSpec`s,
which `models.common.placements` turns into DTensor placements.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.launch.mesh import MeshAxes
from repro_torch.models import common, lm
from repro_torch.models.common import PartitionSpec as P
from repro_torch.optim import adam as adam_mod


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def batch_specs(cfg: ModelConfig, shape: ShapeSpec) -> dict:
    """Meta tensors for the step's data inputs."""
    b, s = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        d = {"tokens": _meta((b, s), torch.int32),
             "targets": _meta((b, s), torch.int32)}
    elif shape.kind == "prefill":
        d = {"tokens": _meta((b, s), torch.int32)}
    else:  # decode: one new token against an s-long cache
        d = {"tokens": _meta((b, 1), torch.int32)}
    if cfg.encoder_layers and shape.kind != "decode":
        d["enc_inputs"] = _meta((b, cfg.encoder_seq, cfg.d_model),
                                torch.float32)
    return d


def _dp(axes: MeshAxes):
    return axes.dp_axes if len(axes.dp_axes) > 1 else axes.dp_axes[0]


def batch_partition(cfg: ModelConfig, shape: ShapeSpec, axes: MeshAxes):
    bdim = _dp(axes) if shape.global_batch % axes.dp_size == 0 else None
    out = {"tokens": P(bdim, None)}
    if shape.kind == "train":
        out["targets"] = P(bdim, None)
    if cfg.encoder_layers and shape.kind != "decode":
        out["enc_inputs"] = P(bdim, None, None)
    return out


def param_structs(cfg: ModelConfig):
    desc = lm.model_desc(cfg)
    return common.shape_structs(desc, dtype=cfg.param_dtype), desc


def param_partition(desc, axes: MeshAxes, *, fsdp: bool):
    return common.partition_specs(
        desc, tp_axis=axes.tp_axis, tp_size=axes.tp_size,
        fsdp_axes=axes.dp_axes if fsdp else (),
        fsdp_size=axes.dp_size if fsdp else 1)


def opt_structs(desc, cfg: ModelConfig, opt_cfg):
    """The optimizer state's descriptor tree (`adam_state_desc`): its
    `shape_structs` and `partition_specs` are the state's stand-ins and
    specs."""
    del cfg
    return adam_mod.adam_state_desc(desc, opt_cfg)


def cache_structs(cfg: ModelConfig, shape: ShapeSpec, axes: MeshAxes):
    """Decode cache stand-ins + PartitionSpecs.

    KV caches shard batch over data; the sequence axis shards over `model`
    when kv-heads don't divide the TP axis."""
    desc = lm.cache_desc(cfg, shape.global_batch, shape.seq_len)
    structs = common.shape_structs(desc)
    b_ok = shape.global_batch % axes.dp_size == 0

    def spec(d: common.ParamDesc):
        # cache descs mark the batch dim via `fsdp`; layer stacking shifts
        # every dim index by one, so resolve against the actual shape.
        parts = [None] * len(d.shape)
        if (b_ok and d.fsdp is not None and d.fsdp < len(d.shape)
                and d.shape[d.fsdp] == shape.global_batch):
            parts[d.fsdp] = _dp(axes)
        if d.tp is not None and d.tp < len(d.shape) \
                and d.shape[d.tp] % axes.tp_size == 0 and parts[d.tp] is None:
            parts[d.tp] = axes.tp_axis
        return P(*parts)

    return structs, common.map_descs(spec, desc)
