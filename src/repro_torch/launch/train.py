"""Fault-tolerant training driver on one device.

Composes the substrate: the token pipeline (step-indexed, bitwise
resumable), the train step (grad accumulation + remat + AdamW), the
checkpoint manager (atomic, rotated), the straggler monitor and the
preemption handler, as the JAX package's `launch/train.py` does. Saves
run in the background (the state copied to the host at the step, a
thread writing it while the next steps run; the loop waits for the last
before it returns), where the JAX package's loop writes in the
foreground: at qwen2-0.5b's width a checkpoint is 7.6 GB.

CLI (the card by default; `--device cpu` runs on the host):
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \\
      --smoke --steps 30 --batch 8 --seq 128 [--accum 2] [--lr 3e-4] \\
      [--ckpt DIR] [--device cuda]

Resume is bitwise, as in the JAX package: the batches are a pure function
of (seed, step), and on CUDA each step runs under
`torch.use_deterministic_algorithms(True)`, since two backward passes
otherwise sum with atomics in an order that varies from run to run (the
embedding gather's and the MoE combine's). That mode needs cuBLAS's
workspace fixed (`CUBLAS_WORKSPACE_CONFIG=:4096:8`) before cuBLAS first
starts in the process; `main` sets it, and a caller that trains on the
card sets it before its first CUDA matmul.

Whisper's encoder inputs are 0.05 · N(0, 1) frame embeddings drawn each
step from numpy, seeded by (seed, step) (`encoder_inputs`), as the port's
serving launcher draws them; the JAX package draws them from
`jax.random.PRNGKey(step)`: the same distribution, other draws.
"""

from __future__ import annotations

import argparse
import contextlib
import os

import numpy as np
import torch

from repro_torch.ann.index import resolve_device
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs.base import get_config, get_smoke_config
from repro_torch.data.tokens import TokenStream
from repro_torch.launch import steps as ST
from repro_torch.models import lm
from repro_torch.models.common import map_descs
from repro_torch.optim import AdamConfig
from repro_torch.optim.adam import adam_state_desc
from repro_torch.runtime import PreemptionHandler, StepMonitor

CUBLAS_WORKSPACE = ":4096:8"


@contextlib.contextmanager
def deterministic(device):
    """`torch.use_deterministic_algorithms(True)` on a CUDA device for the
    block (the previous settings restored after it); nothing on the CPU,
    whose kernels sum in a fixed order. The mode's filling of every new
    tensor's memory is switched off for the block: no operation of the
    step reads memory it has not written, and the fills launch a kernel
    for every allocation (the sLSTM's loop allocates for each of its
    many small operations)."""
    if torch.device(device).type != "cuda":
        yield
        return
    prev = torch.are_deterministic_algorithms_enabled()
    warn = torch.is_deterministic_algorithms_warn_only_enabled()
    fill = torch.utils.deterministic.fill_uninitialized_memory
    torch.use_deterministic_algorithms(True)
    torch.utils.deterministic.fill_uninitialized_memory = False
    try:
        yield
    finally:
        torch.utils.deterministic.fill_uninitialized_memory = fill
        torch.use_deterministic_algorithms(prev, warn_only=warn)


def encoder_inputs(cfg, batch: int, seed: int, step: int) -> torch.Tensor:
    """Step `step`'s stand-in frame embeddings [batch, S_enc, D]: fp32
    0.05 · N(0, 1) from `np.random.default_rng((seed, step))`."""
    rng = np.random.default_rng((seed, step))
    return torch.from_numpy((0.05 * rng.normal(
        size=(batch, cfg.encoder_seq, cfg.d_model))).astype(np.float32))


def model_ctx(seq_len: int) -> lm.ModelCtx:
    """The training chunks for `seq_len` tokens (the JAX package's
    `train_loop`'s): query chunks of up to 1,024, GLA chunks of up to
    256."""
    return lm.ModelCtx(qc_train=min(1024, seq_len),
                       gla_chunk=min(256, seq_len))


def step_batch(cfg, stream: TokenStream, seed: int, step: int, dev) -> dict:
    """Step `step`'s batch on `dev`: the stream's tokens and targets, and
    the encoder-decoder's frame embeddings."""
    batch = {k: torch.from_numpy(v).to(dev)
             for k, v in stream.batch(step).items()}
    if cfg.encoder_layers:
        batch["enc_inputs"] = encoder_inputs(
            cfg, stream.global_batch, seed, step).to(dev)
    return batch


def _restore(manager, cfg, opt_cfg, dev):
    """The latest checkpoint's parameters and optimizer state (shapes
    checked against the descriptors, so nothing is drawn first): the
    tensors on `dev`, the step counter on the host. Returns (params,
    state, its step)."""
    desc = lm.model_desc(cfg)
    state, meta = manager.restore(
        {"params": desc, "opt": adam_state_desc(desc, opt_cfg)})
    opt = state["opt"]
    to_dev = lambda tree: map_descs(lambda t: t.to(dev), tree)
    return to_dev(state["params"]), {"step": opt["step"],
                                     "mu": to_dev(opt["mu"]),
                                     "nu": to_dev(opt["nu"])}, \
        int(meta["step"])


def train_loop(cfg, *, steps: int, global_batch: int, seq_len: int,
               ckpt_dir: str | None = None, save_every: int = 50,
               log_every: int = 10, lr: float = 3e-4, seed: int = 0,
               resume: bool = True, accum: int = 1,
               deadline_s: float | None = None, verbose: bool = True,
               device="cuda"):
    """Train `cfg` from `init_params(seed=seed)` (or the latest checkpoint
    in `ckpt_dir`, continuing from its step) to step `steps` on the
    batches of `TokenStream(vocab, seq_len, global_batch, seed + 1)`.
    Checkpoints every `save_every` steps, at the last step, and at the
    step where SIGTERM/SIGUSR1 arrived (then stops). Returns (params,
    optimizer state, history: one dict a step with its loss and the
    monitor's stats)."""
    dev = resolve_device(device)
    ctx = model_ctx(seq_len)
    opt_cfg = AdamConfig(lr=lr, weight_decay=0.01, compress=cfg.opt_compress)
    stream = TokenStream(cfg.vocab, seq_len, global_batch, seed=seed + 1)

    if dev.type == "cuda":
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", CUBLAS_WORKSPACE)
    manager = CheckpointManager(ckpt_dir) if ckpt_dir else None
    start_step = 0
    if manager and resume and manager.latest_step() is not None:
        params, opt_state, start_step = _restore(manager, cfg, opt_cfg, dev)
        if verbose:
            print(f"resumed from step {start_step}", flush=True)
    else:
        params, opt_state = ST.init_train_state(cfg, seed, opt_cfg,
                                                device=dev)

    step_fn = ST.make_train_step(cfg, ctx, accum=accum, opt_cfg=opt_cfg)
    monitor = StepMonitor(deadline_s=deadline_s)
    preempt = PreemptionHandler()
    history = []
    try:
        for step in range(start_step, steps):
            monitor.start_step()
            batch = step_batch(cfg, stream, seed, step, dev)
            with deterministic(dev):
                params, opt_state, metrics = step_fn(params, opt_state,
                                                     batch)
            loss = float(metrics["loss"])
            stats = monitor.end_step()
            history.append({"step": step + 1, "loss": loss, **stats})
            if verbose and (step + 1) % log_every == 0:
                print(f"step {step+1:5d} loss {loss:.4f} "
                      f"({stats['step_time_s']:.2f}s"
                      f"{' STRAGGLER' if stats['straggler'] else ''})",
                      flush=True)
            if stats["escalate"] and verbose:
                print("straggler escalation: recommend checkpoint + "
                      "reschedule", flush=True)
            want_save = manager and ((step + 1) % save_every == 0
                                     or step + 1 == steps
                                     or preempt.requested)
            if want_save:
                manager.save(step + 1, {"params": params, "opt": opt_state},
                             background=True)
            if preempt.requested:
                if verbose:
                    print(f"preemption: checkpointed at {step+1}, "
                          "exiting cleanly", flush=True)
                break
    finally:
        preempt.restore()
        if manager:
            manager.wait()
    return params, opt_state, history


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced smoke config")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the parameters and the steps")
    args = ap.parse_args()
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", CUBLAS_WORKSPACE)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    _, _, hist = train_loop(cfg, steps=args.steps, global_batch=args.batch,
                            seq_len=args.seq, ckpt_dir=args.ckpt,
                            accum=args.accum, lr=args.lr,
                            device=args.device)
    if hist:
        print(f"first loss {hist[0]['loss']:.4f} -> last "
              f"{hist[-1]['loss']:.4f}")


if __name__ == "__main__":
    main()
