"""Quickstart on the PyTorch port: build a filtered-ANN dataset, open a
`FilteredIndex` over it on the card, run every method on one query
batch, train the query-aware ML router on the card and serve it through
`RouterService` — including a save→load round-trip of the versioned
router artifact.

    PYTHONPATH=src python examples/torch_quickstart.py               # one card
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu
"""

import argparse
import os
import tempfile
from collections import Counter

import numpy as np

from repro_torch.ann import bench
from repro_torch.ann.dataset import recall_at_k
from repro_torch.ann.index import FilteredIndex, QueryBatch
from repro_torch.ann.predicates import Predicate
from repro_torch.ann.registry import all_methods
from repro_torch.ann.service import RouterService
from repro_torch.core import training as T
from repro_torch.core.router import MLRouter
from repro_torch.data.ann_synth import DatasetSpec, make_queries, synthesize


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device of the handle and the fits")
    args = ap.parse_args()

    # 1. a small labelled vector dataset (Zipf labels over Gaussian clusters)
    spec = DatasetSpec("demo", 4000, 48, 64, 8, 12, 1.3, 2.0, 0.5, 0.3, 42)
    ds = synthesize(spec)
    print(f"dataset: {ds.n} vectors, dim {ds.dim}, |U|={ds.universe}, "
          f"{ds.n_groups} unique label sets")

    # 2. one owned serving handle; run every method per predicate type
    fx = FilteredIndex(ds, device=args.device)
    for pred in (Predicate.EQUALITY, Predicate.AND, Predicate.OR):
        qs = make_queries(ds, pred, 50, seed=1)
        print(f"\n== {pred.name} (mean selectivity "
              f"{np.mean([ds.selectivity(qs.bitmaps[i], pred) for i in range(50)]):.3f}) ==")
        for name, m in all_methods().items():
            st = m.param_settings()[-1]
            r = bench.run_method(fx, m, st, qs)
            print(f"  {name:11s} [{st.ps_id:6s}] recall@10={r.mean_recall:.3f} "
                  f"QPS={r.qps:8.1f}")

    # 3. train the query-aware router on this dataset and serve through it
    coll = T.collect({"demo": fx}, n_queries=60, seed=0, verbose=False)
    router = T.train_router(coll, coll.table, epochs=80, device=args.device)
    svc = RouterService(fx, router, t=0.9)
    qs = make_queries(ds, Predicate.AND, 50, seed=9)
    batch = QueryBatch(qs.vectors, qs.bitmaps, Predicate.AND, k=10)
    res = svc.search(batch)
    rec = recall_at_k(res.ids, qs.ground_truth).mean()
    print(f"\nML router (T=0.9): recall@10={rec:.3f}, decisions="
          f"{Counter(m for m, _ in res.decisions).most_common()}")
    print(f"stage timings: route {res.timings['route_s']*1e3:.1f} ms, "
          f"search {res.timings['search_s']*1e3:.1f} ms")
    exp = svc.explain(batch)[0]
    print(f"explain(q0): chose {exp.method}/{exp.ps_id}, "
          f"r̂={ {m: round(v, 3) for m, v in exp.r_hat.items()} }, "
          f"passing={exp.passing}")

    # 4. versioned artifact round-trip reproduces identical decisions
    art = os.path.join(tempfile.mkdtemp(prefix="repro_router_"), "router")
    router.save(art)
    res2 = RouterService(fx, MLRouter.load(art), t=0.9).search(batch)
    assert res2.decisions == res.decisions, "artifact round-trip diverged"
    print(f"artifact round-trip ({art}): identical routing decisions "
          f"on {batch.q} queries")
    fx.close()


if __name__ == "__main__":
    main()
