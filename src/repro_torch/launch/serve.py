"""Batched serving driver: prefill + greedy decode over a prompt batch.

Prompts are padded to the cache length; prefill returns each example's
true-prompt-end logits and a cache whose padded slots decode overwrites
as it advances — no recomputation.

    PYTHONPATH=src python -m repro_torch.launch.serve \\
        [--arch qwen2-0.5b] [--smoke] [--batch 4] [--prompt-len 32] \\
        [--max-new 16] [--device cuda]

runs on the card, at the architecture's full width unless `--smoke`
asks for its reduced config, with random weights from seed 0 (any of
the ten configurations; the encoder-decoder gets 0.05·N(0, 1) frame
embeddings, as the JAX package's launcher gives it).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs.base import ShapeSpec, get_config, \
    get_smoke_config
from repro_torch.models import common, lm


def pad_prompts(prompts: list[list[int]], s_max: int, pad_id: int = 0):
    """([B, s_max] int64 tokens, right-padded with `pad_id`; [B] lengths),
    CPU tensors."""
    b = len(prompts)
    toks = np.full((b, s_max), pad_id, dtype=np.int64)
    lens = np.zeros(b, dtype=np.int64)
    for i, p in enumerate(prompts):
        p = list(p)[:s_max]
        toks[i, :len(p)] = p
        lens[i] = len(p)
    return torch.from_numpy(toks), torch.from_numpy(lens)


def generate(params, cfg, prompts: list[list[int]], *, max_new: int,
             ctx: lm.ModelCtx | None = None, enc_inputs=None,
             greedy: bool = True, seed: int = 0):
    """Greedy/sampled generation on the parameters' device. Returns
    [B, max_new] int32 tokens (numpy). `enc_inputs` [B, S_enc, D] (a
    tensor or an array) are the encoder-decoder's frame embeddings.

    All prompts must share one length (as in the JAX package, whose
    recurrent and ring caches mask against one prompt_len). The cache
    holds max_len + max_new rounded up to a multiple of 64; prefill runs
    over the padded tokens with `prompt_len`, then decode step i writes
    at max_len + i. The parameters are cast to the compute dtype once,
    before prefill (the forwards' own casts are then no-ops); no decode
    runs after the last token, whose logits nothing reads.

    The sampled path (`greedy=False`) draws Gumbel noise from a CPU
    `torch.Generator(seed)`, where the JAX package uses
    `jax.random.categorical`: the same distribution, other draws.

    On a mesh (`ctx.mesh`; every rank calls it alike, the parameters
    DTensors placed by their specs) the prompts are sharded by rows over
    the data axes, the cache after prefill is laid out by
    `launch.specs.cache_structs`'s specs (the sequence over "model" where
    the kv heads do not shard), each step's logits are gathered, and
    every rank returns the same tokens.
    """
    ctx = ctx or lm.ModelCtx(qc_prefill=64, gla_chunk=64)
    mesh = ctx.mesh
    lens_set = {len(p) for p in prompts}
    if len(lens_set) != 1:
        raise ValueError(
            "generate() requires uniform prompt lengths (recurrent state + "
            "ring caches are masked against a single static prompt_len)")
    max_len = max(len(p) for p in prompts)
    s_max = max_len + max_new
    s_max = ((s_max + 63) // 64) * 64       # keep chunked shapes divisible
    dev = params["embed"].device
    tokens, _lens = pad_prompts(prompts, s_max)
    batch = {"tokens": tokens.to(dev)}
    if enc_inputs is not None:
        batch["enc_inputs"] = torch.as_tensor(enc_inputs).to(dev)
    if mesh is not None:
        batch = {k: _rows(v, ctx) for k, v in batch.items()}
    params = common.cast_floats(params, getattr(torch, cfg.compute_dtype))
    logits, cache = lm.forward_prefill(params, batch, cfg, ctx,
                                       prompt_len=max_len)
    if mesh is not None:
        cache = _place_cache(cache, cfg, ctx, len(prompts), s_max)
    gen = None if greedy else torch.Generator().manual_seed(int(seed))
    out = []
    for i in range(max_new):
        if mesh is not None:
            logits = logits.full_tensor()
        last = logits[:, -1]
        if greedy:
            nxt = torch.argmax(last, dim=-1)
        else:
            u = torch.rand(last.shape, generator=gen).clamp_(min=1e-20)
            nxt = torch.argmax(last - torch.log(-torch.log(u)).to(dev), -1)
        out.append(nxt)
        if i + 1 < max_new:
            step = nxt[:, None] if mesh is None else _rows(nxt[:, None], ctx)
            logits, cache = lm.forward_decode(params, cache, step,
                                              max_len + i, cfg, ctx)
    return torch.stack(out, dim=1).to(torch.int32).cpu().numpy()


def _rows(t, ctx):
    """`t` (whole on every rank) sharded by rows over the data axes."""
    return common.distribute(
        t, common.PartitionSpec(common.dp_part(ctx), *[None] * (t.ndim - 1)),
        ctx.mesh)


def _place_cache(cache, cfg, ctx, batch: int, s_max: int):
    """Prefill's cache laid out by `cache_structs`'s specs for a decode of
    `batch` rows against `s_max` positions."""
    from repro_torch.launch import specs
    from repro_torch.launch.mesh import mesh_axes

    _, parts = specs.cache_structs(
        cfg, ShapeSpec("generate", s_max, batch, "decode"),
        mesh_axes(ctx.mesh))
    leaves = [common.constrain(t, ctx, *sp) for t, sp in
              zip(common.tree_leaves(cache), common.tree_leaves(parts))]
    return common.tree_unflatten(cache, iter(leaves))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the weights and the cache")
    args = ap.parse_args()
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    params = common.init_params(lm.model_desc(cfg), seed=0,
                                device=args.device)
    rng = np.random.default_rng(0)
    prompts = [list(rng.integers(1, min(cfg.vocab, 200),
                                 size=args.prompt_len))
               for _ in range(args.batch)]
    enc = None
    if cfg.encoder_layers:                  # stand-in frame embeddings
        enc = torch.from_numpy(0.05 * rng.normal(
            size=(args.batch, cfg.encoder_seq, cfg.d_model))).float()
    toks = generate(params, cfg, prompts, max_new=args.max_new,
                    enc_inputs=enc)
    print("generated:", toks[:, :8], "... shape", toks.shape)


if __name__ == "__main__":
    main()
