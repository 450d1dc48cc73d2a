"""Run one cell of the port's benchmark on this machine's card.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The last line on standard output is the
result: {"correct", "attempted", "failed", "metrics", "device",
["breakdown"], "checks"}; the last lines on standard error are each
number compared beside its limit. With `--trace 0` the metrics are the
cell's end-to-end metrics, with `--trace 1` its per-layer metrics from
a traced run. Without a CUDA card, with fewer cards than the cell asks
for, or when JAX or the JAX package was loaded, it prints no result and
exits with a code other than 0.
"""

import time

T_START = time.perf_counter()        # the set-up clock starts here

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    import torch

    from portbench.harness import cell as cell_mod

    cell = cell_mod.load_cell(ROOT, args.workload)
    if not torch.cuda.is_available():
        print("portbench: no CUDA device; the benchmark runs only on a "
              "card", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        print(f"portbench: the program (src/repro_torch) is missing: {e}",
              file=sys.stderr)
        return 2
    result, checks, _ = cell_mod.run(
        cell, args.seed, args.seconds, bool(args.trace), "cuda", T_START,
        log=lambda m: print(m, file=sys.stderr, flush=True))
    found = cell_mod.forbidden_modules()
    if found:
        print(f"portbench: loaded {found}: the port's run may load neither "
              f"JAX nor the JAX package", file=sys.stderr)
        return 3
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    result["checks"] = checks
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
