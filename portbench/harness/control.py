"""The control of the comparison: the reference put in the program's
place, one precision below the configuration's (TF32 for fp32 with TF32
off), judged as a run is. It has to come out not correct.

    python3 portbench/harness/control.py --workload <cell> \
        --seeds <n,n,...> --batches <window batches> [--device cuda] \
        [--precision tf32|fp64] [--fault half|altered]

For each seed it draws the cell's inputs as a run does
(`cell.inputs`) and prints one JSON line with the numbers that
`--batches` window batches give. What the reference stands in for is
the cell's entry's: its module's `control(ctl)` gets a `Control` with
the reference's exact answers (scored with TF32 products at `tf32`),
and judges them, with whatever else its comparison covers, as its runs
are judged. With `--precision fp64` the reference takes the program's
place at its own precision, and `--fault` plants a fault
(`harness/faults.py`) in its answers: the readings of a fault without
the cost of the program's set-up. The benchmark's own runs never run
it.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
from typing import Callable

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))


@dataclasses.dataclass
class Control:
    """What an entry's `control` gets."""
    cell: object
    seed: int
    n_batches: int
    pool: object                 # the window's `gen.QueryPool`
    ref: object                  # `judge.Reference` over the drawn rows
    precision: str
    # answers(pred, qv, qb) -> (ids in served order, distances with NaN
    # where there is no id, the predicate's exact passing counts)
    answers: Callable


def control_numbers(cell, seed: int, n_batches: int, device, *,
                    precision: str = "tf32", fault: str | None = None
                    ) -> dict:
    """The numbers the control gives on `n_batches` window batches."""
    import torch

    from portbench.harness import cell as cell_mod
    from portbench.harness import faults
    from portbench.harness import judge as judge_mod
    from portbench.reference import exact as ref_exact

    dev = torch.device(device)
    inp = cell_mod.inputs(cell, seed, dev, n_batches)
    ref = judge_mod.Reference(inp.vectors, inp.bitmaps, dev)
    served_of = np.empty(ref.n, dtype=np.int64)
    served_of[ref.groups.order] = np.arange(ref.n)
    k = int(cell.traffic["k"])

    def answers(pred, qv, qb):
        qv_t, qb_t = ref.on_device(qv, qb)
        ids, d, counts = ref_exact.exact_topk(
            ref.vectors, ref.groups, qv_t, qb_t, pred, k,
            precision=precision)
        ids = np.where(ids >= 0, served_of[np.maximum(ids, 0)], -1)
        if fault is not None:
            ids, d = faults.apply(fault, ids, d, ref.n)
        return ids, np.where(ids >= 0, d, np.nan), counts

    entry = cell_mod.load_module("entries", cell.traffic["entry"], cell.root)
    return entry.control(Control(cell, seed, n_batches, inp.pool, ref,
                                 precision, answers))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--batches", type=int, required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--precision", default="tf32", choices=("tf32", "fp64"))
    ap.add_argument("--fault", choices=("half", "altered"))
    args = ap.parse_args(argv)
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    import torch

    from portbench.harness import cell as cell_mod
    from portbench.harness import judge as judge_mod

    if args.device == "cuda" and not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    cell = cell_mod.load_cell(ROOT, args.workload)
    for seed in map(int, args.seeds.split(",")):
        numbers = control_numbers(cell, seed, args.batches, args.device,
                                  precision=args.precision, fault=args.fault)
        correct, checks = judge_mod.verdict(numbers, cell.limits)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "precision": args.precision, "fault": args.fault,
                          "correct": correct, "checks": checks}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
