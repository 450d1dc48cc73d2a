"""Fault-tolerant LM training demo on the PyTorch port (the counterpart
of `examples/train_lm.py`): trains a reduced-config model at random init
on the synthetic bigram stream with checkpointing, straggler monitoring
and clean preemption (send SIGUSR1 to checkpoint and exit).

    PYTHONPATH=src python examples/torch_train_lm.py --arch internlm2-1.8b \\
        --steps 40 [--ckpt DIR] [--device cuda]

Re-running the same command resumes bitwise from the checkpoint. The
default checkpoint directory is `build/torch_lm_ckpt` under the repo
root; `--device cpu` runs on the host.
"""

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.configs.base import get_smoke_config  # noqa: E402
from repro_torch.launch.train import (CUBLAS_WORKSPACE,  # noqa: E402
                                      train_loop)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="internlm2-1.8b")
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--accum", type=int, default=2)
    ap.add_argument("--ckpt", default=os.path.join(ROOT, "build",
                                                   "torch_lm_ckpt"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", CUBLAS_WORKSPACE)

    cfg = get_smoke_config(args.arch)
    _, _, hist = train_loop(
        cfg, steps=args.steps, global_batch=args.batch, seq_len=args.seq,
        ckpt_dir=args.ckpt, save_every=10, accum=args.accum, lr=2e-3,
        log_every=5, device=args.device)
    if hist:
        print(f"\nloss {hist[0]['loss']:.3f} -> {hist[-1]['loss']:.3f} over "
              f"{len(hist)} steps "
              f"(median step "
              f"{sorted(h['step_time_s'] for h in hist)[len(hist)//2]:.2f}s)")


if __name__ == "__main__":
    main()
