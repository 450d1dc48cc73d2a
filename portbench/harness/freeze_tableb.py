"""Freeze a configuration's table B: one sweep of the router's candidate
methods, every parameter setting under every predicate, on the card.

    python3 portbench/harness/freeze_tableb.py --config <name> --seed <n> \
        --out <path> [--queries 256] [--device cuda]
    python3 portbench/harness/freeze_tableb.py --config <name> --check-truth

The program's own offline stage (`repro_torch.ann.bench.run_method`)
measures each (method, setting, predicate) on `--queries` queries drawn
by the benchmark's generator at `--seed` from the configuration's
dataset (its `data.seed`, rows in drawn order): the qps column is the
program's, the deployment's own measurement; the recall column is
recall@k against the reference's exact answer
(`reference.exact.exact_topk`), not the program's exact search, so a
fault there cannot be frozen into the table the reference routes by.
The table is written in the program's table format, with the device,
its power limit, the commit and both seeds beside the rows. With a
frozen table the router's decisions no longer depend on one run's
timings.

`--check-truth` draws the committed table's queries again (its seed and
query count) and counts, per predicate, the queries whose exact top-k
set from the program's `prefilter` search differs from the reference's:
where none does, a recall column scored against either is the same.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
PREDS = ("EQUALITY", "AND", "OR")


def _setup(config_name: str, config: dict, seed: int, queries: int,
           device):
    """(the program's handle, the reference, served ids of drawn rows,
    the query pool, k) of one sweep."""
    import torch

    from portbench.harness import gen
    from portbench.harness import judge as judge_mod
    from repro_torch.ann.dataset import ANNDataset
    from repro_torch.ann.index import FilteredIndex

    dev = torch.device(device)
    spec = gen.DataSpec.from_config(config)
    data = gen.make_data(spec, int(config["data"]["seed"]), dev)
    vectors = data.vectors.cpu().numpy()
    bitmaps = data.bitmaps.cpu().numpy().view(np.uint32)
    pool = gen.QueryPool(data, seed, "tableB", queries, PREDS,
                         chunk=len(PREDS))
    pool.prepare(len(PREDS))
    data.vectors = data.bitmaps = None
    ref = judge_mod.Reference(vectors, bitmaps, dev)
    served_of = np.empty(ref.n, dtype=np.int64)
    served_of[ref.groups.order] = np.arange(ref.n)
    ds = ANNDataset.from_packed(config_name, vectors, bitmaps,
                                spec.universe)
    fx = FilteredIndex(ds, device=dev)
    return fx, ref, served_of, pool, int(config["k"])


def _truth(ref, served_of, pred: str, qv, qb, k: int) -> np.ndarray:
    """The reference's exact top-k, as the program's served row ids."""
    from portbench.reference.exact import exact_topk

    qv_t, qb_t = ref.on_device(qv, qb)
    ids, _, _ = exact_topk(ref.vectors, ref.groups, qv_t, qb_t, pred, k)
    return np.where(ids >= 0, served_of[np.maximum(ids, 0)], -1)


def sweep(config_name: str, config: dict, seed: int, queries: int,
          device, log=print) -> dict:
    """The table-file dict of one sweep."""
    from repro_torch.ann import bench
    from repro_torch.ann import methods  # noqa: F401  (registers them)
    from repro_torch.ann.dataset import QuerySet
    from repro_torch.ann.predicates import Predicate
    from repro_torch.ann.registry import candidate_methods
    from repro_torch.core.table import TABLE_FORMAT, TABLE_VERSION

    fx, ref, served_of, pool, k = _setup(config_name, config, seed,
                                         queries, device)
    rows = []
    for i, p in enumerate(PREDS):
        _, qv, qb = pool.get(i)
        pred = Predicate.parse(p)
        qs = QuerySet(dataset=config_name, pred=pred, vectors=qv,
                      bitmaps=qb, ground_truth=_truth(ref, served_of, p, qv,
                                                      qb, k), k=k)
        for name, method in candidate_methods().items():
            for setting in method.param_settings():
                t0 = time.perf_counter()
                r = bench.run_method(fx, method, setting, qs)
                rows.append({"ds": config_name, "pt": int(pred),
                             "method": name, "ps": setting.ps_id,
                             "recall": r.mean_recall, "qps": r.qps})
                log(f"tableB {p} {name}/{setting.ps_id}: recall "
                    f"{r.mean_recall:.4f} qps {r.qps:.1f} "
                    f"({time.perf_counter() - t0:.1f} s with its build)")
    fx.close()
    return {"format": TABLE_FORMAT, "version": TABLE_VERSION, "rows": rows}


def truth_check(config_name: str, config: dict, seed: int, queries: int,
                device) -> dict:
    """Per predicate, the queries whose top-k set from the program's
    `prefilter` differs from the reference's, and the queries drawn."""
    from repro_torch.ann.index import QueryBatch
    from repro_torch.ann.predicates import Predicate

    fx, ref, served_of, pool, k = _setup(config_name, config, seed,
                                         queries, device)
    out = {}
    for i, p in enumerate(PREDS):
        _, qv, qb = pool.get(i)
        got = fx.search(QueryBatch(qv, qb, Predicate.parse(p), k),
                        "prefilter").ids
        want = _truth(ref, served_of, p, qv, qb, k)
        differ = sum(set(g[g >= 0].tolist()) != set(w[w >= 0].tolist())
                     for g, w in zip(np.asarray(got), want))
        out[p] = {"differ": int(differ), "queries": int(qv.shape[0])}
    fx.close()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--seed", type=int)
    ap.add_argument("--out")
    ap.add_argument("--queries", type=int, default=256)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--commit", default="")
    ap.add_argument("--check-truth", action="store_true")
    args = ap.parse_args(argv)
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("freeze_tableb: no CUDA device", file=sys.stderr)
        return 2
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        conf = {c["name"]: c for c in json.load(f)["configs"]}[args.config]
    with open(os.path.join(ROOT, conf["file"])) as f:
        config = json.load(f)
    if args.check_truth:
        with open(os.path.join(ROOT, config["table_b"])) as f:
            frozen = json.load(f)["frozen"]
        print(json.dumps({"config": args.config, "truth": truth_check(
            args.config, config, int(frozen["seed"]),
            int(frozen["queries_per_predicate"]), args.device)}),
            flush=True)
        return 0
    if args.seed is None or args.out is None:
        ap.error("--seed and --out are needed to freeze a table")
    table = sweep(args.config, config, args.seed, args.queries,
                  args.device, log=lambda m: print(m, flush=True))
    from portbench.harness.cell import power_limit
    table["frozen"] = {
        "device": (torch.cuda.get_device_name(0)
                   if args.device == "cuda" else args.device),
        "card": power_limit() if args.device == "cuda" else None,
        "commit": args.commit, "seed": args.seed,
        "data_seed": int(config["data"]["seed"]),
        "queries_per_predicate": args.queries,
        "how": "portbench/harness/freeze_tableb.py"}
    with open(args.out, "w") as f:
        json.dump(table, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
