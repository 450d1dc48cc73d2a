"""ML Router — paper §4 / Algorithm 2, batched end to end.

Features for the whole query batch come from one vectorised
`features.feature_matrix` pass; the M per-method MLP-Reg models run as
one `mlp.StackedMLP` forward; Algorithm 2 (threshold filter `r̂_m ≥ T` →
max-QPS passing method from the offline benchmark table B → argmax-r̂
fallback) runs as numpy array ops over the per-method tables from
`BenchmarkTable.routing_arrays`.

Persistence is the JAX package's versioned artifact directory
(`router.json` manifest + `weights.npz` + `table.json`), unchanged: an
artifact saved by either package loads in the other.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os

import numpy as np
import torch

from repro_torch.ann.dataset import ANNDataset, sha1_file
from repro_torch.ann.index import resolve_device
from repro_torch.ann.predicates import Predicate
from repro_torch.core import features as F
from repro_torch.core import mlp
from repro_torch.core.table import BenchmarkTable, table_file_version

ARTIFACT_FORMAT = "repro.router"
ARTIFACT_VERSION = 1
_MANIFEST = "router.json"
_WEIGHTS = "weights.npz"
_TABLE = "table.json"


def artifact_versions(path: str) -> dict:
    """Version + content stamps of a router artifact directory, without
    loading it: ``{"router_version": int, "table_version": int,
    "content_sha1": str}`` (sha1 over the manifest, weights and table
    digests). Raises ValueError if `path` is not a router artifact
    directory."""
    manifest_path = os.path.join(path, _MANIFEST)
    if not os.path.isdir(path) or not os.path.exists(manifest_path):
        raise ValueError(
            f"{path!r} is not a router artifact directory (no {_MANIFEST})")
    with open(manifest_path) as f:
        manifest = json.load(f)
    if manifest.get("format") != ARTIFACT_FORMAT:
        raise ValueError(
            f"{path!r} is not a {ARTIFACT_FORMAT} artifact "
            f"(format={manifest.get('format')!r})")
    table_path = os.path.join(path, manifest.get("table", _TABLE))
    if not os.path.exists(table_path):
        raise ValueError(
            f"router artifact {path!r} is missing its benchmark table "
            f"file {os.path.basename(table_path)!r}")
    h = hashlib.sha1()
    for fname in (_MANIFEST, manifest.get("weights", _WEIGHTS),
                  manifest.get("table", _TABLE)):
        fpath = os.path.join(path, fname)
        if os.path.exists(fpath):
            h.update(sha1_file(fpath).encode())
    return {
        "router_version": int(manifest.get("version", -1)),
        "table_version": table_file_version(table_path),
        "content_sha1": h.hexdigest(),
    }


@dataclasses.dataclass
class MLRouter:
    feature_names: list            # e.g. F.MINIMAL_FEATURES
    methods: list                  # candidate method names, fixed order
    models: dict                   # method -> MLP params (numpy layer dicts)
    scaler: mlp.Scaler
    table: BenchmarkTable
    _stacked: dict = dataclasses.field(default_factory=dict, init=False,
                                       repr=False, compare=False)

    # ---- prediction -----------------------------------------------------
    def predict_recalls(self, ds: ANNDataset, qbms: np.ndarray,
                        pred: Predicate, *, fx=None,
                        device="cuda") -> np.ndarray:
        """[Q, M] predicted recall@10 per candidate method (one vectorised
        feature pass + one stacked-MLP forward, on `fx`'s device when a
        handle is given, else on `device`: "cuda" by default, which
        raises without a card; pass "cpu" to run on the CPU)."""
        device = fx.torch_device if fx is not None else resolve_device(device)
        x = F.feature_matrix(ds, qbms, pred, self.feature_names, fx=fx)
        return self.predict_recalls_from_features(x, device=device)

    def retrained(self, models: dict, scaler: "mlp.Scaler",
                  table: BenchmarkTable | None = None) -> "MLRouter":
        """Fresh router with new weights but this router's feature set
        and method order (the online adapter's retrain constructor — a
        new instance, so the serving swap is one reference assignment
        and the stacked-model cache starts cold)."""
        return MLRouter(feature_names=list(self.feature_names),
                        methods=list(self.methods), models=models,
                        scaler=scaler,
                        table=self.table if table is None else table)

    def stacked_model(self, device) -> mlp.StackedMLP:
        """All M per-method models as one `StackedMLP` on `device`
        (cached per device)."""
        device = torch.device(device)
        net = self._stacked.get(device)
        if net is None:
            net = mlp.StackedMLP([self.models[m] for m in self.methods],
                                 device=device)
            self._stacked[device] = net
        return net

    def predict_recalls_from_features(self, x_raw: np.ndarray, *,
                                      device="cuda") -> np.ndarray:
        """[Q, M] predicted recalls from a raw feature matrix, the MLPs on
        `device` ("cuda" by default, which raises without a card)."""
        device = resolve_device(device)
        xs = torch.from_numpy(self.scaler.transform(x_raw)).to(device)
        with torch.no_grad():
            out = self.stacked_model(device)(xs)               # [M, Q, 1]
        return out[:, :, 0].T.cpu().numpy().astype(np.float32)  # [Q, M]

    # ---- Algorithm 2 ------------------------------------------------------
    def route_from_predictions(self, r_hat: np.ndarray, ds_name: str,
                               pred: Predicate, t: float):
        """Vectorised Algorithm 2. Returns list of (method, ps_id) per query:
        argmax of QPS masked to passing methods, argmax-r̂ fallback rows
        where nothing passes (first maximal index on ties)."""
        pt = int(Predicate(pred))
        has_pass, qps, ps_pass, ps_fallback = self.table.routing_arrays(
            ds_name, pt, self.methods, t)
        r = np.asarray(r_hat, dtype=np.float64)
        passing = (r >= t) & has_pass[None, :]                 # [Q, M]
        any_pass = passing.any(axis=1)
        j_pass = np.argmax(np.where(passing, qps[None, :], -np.inf), axis=1)
        j_fb = np.argmax(r, axis=1)
        j_star = np.where(any_pass, j_pass, j_fb)
        ps_sel = np.where(any_pass, ps_pass[j_star], ps_fallback[j_star])
        names = np.array(self.methods, dtype=object)[j_star]
        return list(zip(names.tolist(), ps_sel.tolist()))

    def route_from_predictions_loop(self, r_hat: np.ndarray, ds_name: str,
                                    pred: Predicate, t: float):
        """Scalar per-query Algorithm 2: the parity oracle of
        `route_from_predictions` for the tests and the routing-latency
        comparison. Not a hot path."""
        pt = int(Predicate(pred))
        ps_of, qps_of = {}, {}
        for m in self.methods:
            hit = self.table.best_qps_setting(ds_name, pt, m, t)
            if hit is not None:
                ps_of[m], qps_of[m] = hit[0], hit[1]["qps"]
        decisions = []
        for qi in range(r_hat.shape[0]):
            passing = [m for j, m in enumerate(self.methods)
                       if r_hat[qi, j] >= t and m in ps_of]
            if passing:
                m_star = max(passing, key=lambda m: qps_of[m])
                decisions.append((m_star, ps_of[m_star]))
            else:  # fallback: argmax predicted recall, max-recall setting
                m_star = self.methods[int(np.argmax(r_hat[qi]))]
                hit = self.table.best_qps_setting(ds_name, pt, m_star, t) \
                    or self.table.max_recall_setting(ds_name, pt, m_star)
                decisions.append((m_star, hit[0] if hit else None))
        return decisions

    def route(self, ds: ANNDataset, qbms: np.ndarray, pred: Predicate,
              t: float, *, fx=None, device="cuda"):
        r_hat = self.predict_recalls(ds, qbms, pred, fx=fx, device=device)
        return self.route_from_predictions(r_hat, ds.name, pred, t)

    # ---- persistence ----
    def save(self, path: str) -> None:
        """Write the versioned artifact directory at `path`:

            path/router.json   — manifest (format, version, features,
                                 method order, layer counts)
            path/weights.npz   — per-method MLP layers + scaler
            path/table.json    — offline benchmark table B
        """
        if os.path.isfile(path):
            raise ValueError(
                f"router artifact path {path!r} is an existing file; the "
                f"versioned artifact is a directory")
        os.makedirs(path, exist_ok=True)
        arrays = {"scaler/mean": np.asarray(self.scaler.mean),
                  "scaler/std": np.asarray(self.scaler.std)}
        n_layers = {}
        for m in self.methods:
            layers = self.models[m]
            n_layers[m] = len(layers)
            for i, layer in enumerate(layers):
                arrays[f"model/{m}/{i}/w"] = np.asarray(layer["w"])
                arrays[f"model/{m}/{i}/b"] = np.asarray(layer["b"])
        np.savez(os.path.join(path, _WEIGHTS), **arrays)
        self.table.save(os.path.join(path, _TABLE))
        manifest = {
            "format": ARTIFACT_FORMAT,
            "version": ARTIFACT_VERSION,
            "feature_names": list(self.feature_names),
            "methods": list(self.methods),
            "n_layers": n_layers,
            "weights": _WEIGHTS,
            "table": _TABLE,
        }
        with open(os.path.join(path, _MANIFEST), "w") as f:
            json.dump(manifest, f, indent=1)

    @staticmethod
    def load(path: str) -> "MLRouter":
        """Load a versioned router artifact directory. Raises ValueError
        for anything that is not one (or a newer version)."""
        if not os.path.isdir(path):
            raise ValueError(f"{path!r} is not a router artifact directory")
        with open(os.path.join(path, _MANIFEST)) as f:
            manifest = json.load(f)
        if manifest.get("format") != ARTIFACT_FORMAT:
            raise ValueError(
                f"{path!r} is not a {ARTIFACT_FORMAT} artifact "
                f"(format={manifest.get('format')!r})")
        if int(manifest.get("version", -1)) > ARTIFACT_VERSION:
            raise ValueError(
                f"router artifact version {manifest['version']} is newer "
                f"than supported version {ARTIFACT_VERSION}")
        with np.load(os.path.join(path, manifest["weights"])) as z:
            scaler = mlp.Scaler(z["scaler/mean"].copy(),
                                z["scaler/std"].copy())
            models = {}
            for m in manifest["methods"]:
                models[m] = [
                    {"w": z[f"model/{m}/{i}/w"].copy(),
                     "b": z[f"model/{m}/{i}/b"].copy()}
                    for i in range(int(manifest["n_layers"][m]))]
        table = BenchmarkTable.load(os.path.join(path, manifest["table"]))
        return MLRouter(feature_names=list(manifest["feature_names"]),
                        methods=list(manifest["methods"]),
                        models=models, scaler=scaler, table=table)
