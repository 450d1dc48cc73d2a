"""Offline stage end-to-end on the PyTorch port: collect training data
over the six training datasets, sweep every method's parameter space
into the benchmark table B, train the per-method MLP regressors on the
card, and validate on the five unseen datasets against the oracle — the
paper's full §6 pipeline.

    PYTHONPATH=src python examples/torch_train_router.py [--queries 200]
    PYTHONPATH=src python examples/torch_train_router.py --device cpu
"""

import argparse

import numpy as np

from repro_torch.core import training as T
from repro_torch.core.oracle import oracle_recall


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--queries", type=int, default=200)
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the sweep's handles and the fits")
    args = ap.parse_args()

    coll_train, coll_val, router = T.build_all(
        n_queries=args.queries, force=args.force, verbose=True,
        device=args.device)
    print(f"\ntable B entries: {len(router.table.entries)}")

    agg, agg_o = [], []
    print(f"{'dataset':16s} {'pred':9s} {'router':>7s} {'oracle':>7s}")
    for (ds, pt), cell in sorted(coll_val.cells.items()):
        x, _, _ = T.assemble_xy(
            T.Collection(cells={(ds, pt): cell}, table=coll_val.table),
            router.feature_names)
        dec = router.route_from_predictions(
            router.predict_recalls_from_features(x, device=args.device),
            ds, pt, 0.9)
        rec = np.array([cell.recall[m][i] for i, (m, _) in enumerate(dec)])
        orc = oracle_recall(coll_val, ds, pt)
        agg.append(rec)
        agg_o.append(orc)
        print(f"{ds:16s} {pt:<9d} {rec.mean():7.4f} {orc.mean():7.4f}")
    print(f"\nAGGREGATE router={np.concatenate(agg).mean():.4f} "
          f"oracle={np.concatenate(agg_o).mean():.4f} "
          f"(paper: 0.986 with 0.9% oracle gap)")


if __name__ == "__main__":
    main()
