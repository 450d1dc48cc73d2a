"""Offline stage: training-data collection (paper §6.1.2) + router training.

For every (dataset, predicate type, method) we sweep the method's parameter
space (Table 3 analogue), record (mean recall, QPS) per setting into the
benchmark table B, select the best-recall setting (the method's "potential
best performance"), and keep its *per-query* recall@10 vector as the
regression labels. Features are extracted once per query with **all** 21
numeric features so ablations can slice subsets without re-collecting.

The JAX package's module on this package's handles: the sweep runs on
each handle's device (the `selectivity` kernel for the features, the
methods' searches), the MLP fits on `device` ("cuda" by default). A
router artifact written here opens in either package.
"""

from __future__ import annotations

import dataclasses
import os
import pickle

import numpy as np

from repro_torch.ann import bench
from repro_torch.ann.predicates import PREDICATES
from repro_torch.common import artifacts_dir
from repro_torch.core import features as F
from repro_torch.core import mlp
from repro_torch.core.router import MLRouter
from repro_torch.core.table import BenchmarkTable

METHOD_ORDER = ["labelnav", "postfilter", "sieve", "ivf_gamma", "fvamana"]


@dataclasses.dataclass
class CellRecord:
    """One (dataset, predicate) cell of collected data."""
    dataset: str
    pred: int
    numeric: np.ndarray            # [Q, 21] raw numeric features
    recall: dict                   # method -> [Q] per-query recall (best ps)
    best_ps: dict                  # method -> ps_id used for labels
    qvecs: np.ndarray
    qbms: np.ndarray
    gt: np.ndarray
    sweep: list                    # [(method, ps_id, mean_recall, qps)]


@dataclasses.dataclass
class Collection:
    cells: dict                    # (ds, pt) -> CellRecord
    table: BenchmarkTable

    def save(self, path: str) -> None:
        with open(path, "wb") as f:
            pickle.dump(self, f)

    @staticmethod
    def load(path: str) -> "Collection":
        """Unpickle a collection this package saved (never open a file
        another program wrote: unpickling runs the code it names)."""
        with open(path, "rb") as f:
            return pickle.load(f)


def collect(datasets: dict, methods: dict | None = None, *,
            n_queries: int = 200, seed: int = 0, k: int = 10,
            verbose: bool = True, device="cuda") -> Collection:
    """`methods` defaults to the live candidate-registry view; datasets
    may map to `ANNDataset` values or handles. A bare dataset opens the
    shared default pool's handle on `device` ("cuda" by default, which
    raises without a card), so repeat collections reuse its tensors and
    indexes; a handle runs on its own device."""
    from repro_torch.ann.index import as_index
    from repro_torch.ann.registry import candidate_methods
    from repro_torch.data.ann_synth import make_queries

    if methods is None:
        methods = candidate_methods()
    cells = {}
    table = BenchmarkTable.new()
    for ds_name, ds in datasets.items():
        fx = as_index(ds, device)
        ds = fx.ds
        for pred in PREDICATES:
            qs = make_queries(ds, pred, n_queries, k=k, seed=seed)
            numeric = F.feature_matrix(ds, qs.bitmaps, pred,
                                       F.NUMERIC_FEATURES, fx=fx)
            recall, best_ps, sweep = {}, {}, []
            for m_name, m in methods.items():
                best = None
                for setting in m.param_settings():
                    r = bench.run_method(fx, m, setting, qs)
                    table.add(ds_name, int(pred), m_name, setting.ps_id,
                              r.mean_recall, r.qps)
                    sweep.append((m_name, setting.ps_id, r.mean_recall, r.qps))
                    if best is None or (r.mean_recall, r.qps) > \
                            (best.mean_recall, best.qps):
                        best = r
                recall[m_name] = best.recall_per_query
                best_ps[m_name] = best.ps_id
                if verbose:
                    print(f"  {ds_name:14s} {pred.name:8s} {m_name:11s} "
                          f"best={best.ps_id:6s} recall={best.mean_recall:.3f} "
                          f"qps={best.qps:.0f}", flush=True)
            cells[(ds_name, int(pred))] = CellRecord(
                dataset=ds_name, pred=int(pred), numeric=numeric,
                recall=recall, best_ps=best_ps, qvecs=qs.vectors,
                qbms=qs.bitmaps, gt=qs.ground_truth, sweep=sweep)
    return Collection(cells=cells, table=table)


# ---------------------------------------------------------------------------
# assembling model inputs from a Collection
# ---------------------------------------------------------------------------

def assemble_xy(coll: Collection, feature_names: list,
                methods: list = METHOD_ORDER):
    """Returns (X_raw [N, Fexp], y [N, M], meta rows)."""
    xs, ys, meta = [], [], []
    numeric_idx = {n: i for i, n in enumerate(F.NUMERIC_FEATURES)}
    for (ds, pt), cell in sorted(coll.cells.items()):
        q = cell.numeric.shape[0]
        cols = []
        for name in feature_names:
            if name == "pred":
                oh = np.zeros((q, 3), dtype=np.float32)
                oh[:, pt] = 1.0
                cols.append(oh)
            else:
                cols.append(cell.numeric[:, numeric_idx[name]][:, None])
        xs.append(np.concatenate(cols, axis=1))
        ys.append(np.stack([cell.recall[m] for m in methods], axis=1))
        meta.extend([(ds, pt, qi) for qi in range(q)])
    return (np.concatenate(xs).astype(np.float32),
            np.concatenate(ys).astype(np.float32), meta)


def train_models_from_xy(x_raw: np.ndarray, y: np.ndarray,
                         methods: list, *, seed: int = 0,
                         hidden=(64, 32), epochs: int = 200,
                         device="cuda"):
    """Fit the scaler + one MLP-Reg per method on an already-assembled
    (X_raw [N, F], y [N, M]) pair, on `device` ("cuda" by default). This
    is the shared core of offline `train_models` and the online
    adapter's audit-label retrain
    (`repro_torch.ann.telemetry.OnlineRouterAdapter`). Returns
    (models, scaler); the models as numpy layer dicts."""
    scaler = mlp.Scaler.fit(x_raw)
    xs = scaler.transform(x_raw)
    models = {}
    for j, m in enumerate(methods):
        params = mlp.train_mlp(xs, y[:, j], hidden=hidden, epochs=epochs,
                               seed=seed + 131 * j, device=device)
        models[m] = mlp.params_to_numpy(params)
    return models, scaler


def train_models(coll: Collection, feature_names: list, *, seed: int = 0,
                 hidden=(64, 32), epochs: int = 200,
                 methods: list = METHOD_ORDER, device="cuda"):
    """Train one MLP-Reg per candidate method. Returns (models, scaler)."""
    x_raw, y, _ = assemble_xy(coll, feature_names, methods)
    return train_models_from_xy(x_raw, y, methods, seed=seed,
                                hidden=hidden, epochs=epochs, device=device)


def train_router(coll_train: Collection, table: BenchmarkTable,
                 feature_names=None, *, seed: int = 0,
                 hidden=(64, 32), epochs: int = 200,
                 device="cuda") -> MLRouter:
    feature_names = feature_names or F.MINIMAL_FEATURES
    models, scaler = train_models(coll_train, feature_names, seed=seed,
                                  hidden=hidden, epochs=epochs,
                                  device=device)
    return MLRouter(feature_names=feature_names, methods=METHOD_ORDER,
                    models=models, scaler=scaler, table=table)


# ---------------------------------------------------------------------------
# artifact-cached full pipeline
# ---------------------------------------------------------------------------

def default_paths():
    """(train collection, validation collection, router artifact) under
    `artifacts/router/`. The router directory is the JAX package's, in
    the format both packages read; the collections are pickles of this
    package's classes, so they take names of their own."""
    d = artifacts_dir("router")
    return (os.path.join(d, "collect_train_torch.pkl"),
            os.path.join(d, "collect_val_torch.pkl"),
            os.path.join(d, "router"))       # versioned artifact directory


def _router_artifact_path(p: str) -> str | None:
    """Loadable router artifact at `p`: the versioned directory (manifest
    present), else None."""
    if os.path.isdir(p) and os.path.exists(os.path.join(p, "router.json")):
        return p
    return None


def build_all(*, n_queries: int = 200, seed: int = 0, force: bool = False,
              verbose: bool = True, device="cuda"):
    """Collect train+val data, build B, train the router, on `device`
    ("cuda" by default). Artifact-cached."""
    from repro_torch.data.ann_synth import (TRAIN_SPECS, VALIDATION_SPECS,
                                            get_dataset)

    p_train, p_val, p_router = default_paths()
    router_path = _router_artifact_path(p_router)
    if not force and os.path.exists(p_train) and os.path.exists(p_val) \
            and router_path is not None:
        return (Collection.load(p_train), Collection.load(p_val),
                MLRouter.load(router_path))

    train_ds = {n: get_dataset(n) for n in TRAIN_SPECS}
    val_ds = {n: get_dataset(n) for n in VALIDATION_SPECS}
    if verbose:
        print("== collecting training datasets ==", flush=True)
    coll_train = collect(train_ds, n_queries=n_queries, seed=seed,
                         verbose=verbose, device=device)
    if verbose:
        print("== collecting validation datasets ==", flush=True)
    coll_val = collect(val_ds, n_queries=n_queries, seed=seed + 1,
                       verbose=verbose, device=device)
    # B spans both pools (offline benchmarking; §4.1 builds it on the
    # deployment/validation datasets — train entries are free to keep)
    table = BenchmarkTable.new()
    table.entries.update(coll_train.table.entries)
    table.entries.update(coll_val.table.entries)
    router = train_router(coll_train, table, device=device)
    coll_train.save(p_train)
    coll_val.save(p_val)
    router.save(p_router)
    return coll_train, coll_val, router
