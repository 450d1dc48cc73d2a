"""The router worked out again: features, the per-method MLPs and
Algorithm 2 (paper §4), from the router artifact's files and the frozen
table B, read as plain JSON and NPZ.

* `selectivity`: the fraction of rows passing the query's predicate:
  the sizes of the passing label sets, summed.
* `lid_mean`: the mean maximum-likelihood LID (paper Eq. 3) of 256 rows
  drawn with `np.random.default_rng(0)` from the served row order, over
  their 20 nearest rows, in float32 on the host: the estimate the
  router's training used (sample 256, k 20, seed 0), with its arithmetic,
  so it comes out to the bit.
* `pred`: one-hot of the predicate.
* The MLPs: `h @ w + b`, ReLU between layers, in float64 (the control:
  every product's inputs rounded to TF32, fp32 sums).
* Algorithm 2: per method the best-QPS setting with recall >= T, the
  passing method of highest QPS; where none passes, the method of
  highest predicted recall with its best-QPS-over-T setting or else its
  highest-recall setting. Ties go to the first in file or method order.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from portbench.reference.exact import PRED_CODES, predicate_mask, round_tf32

LID_SAMPLE, LID_K, LID_SEED = 256, 20, 0


def selectivity_counts(groups, qbms: torch.Tensor, pred: str) -> np.ndarray:
    """[Q] int64 passing-row counts of the rows whose label sets are
    `groups` (exact in float64)."""
    ok = predicate_mask(groups.bitmaps, qbms, pred).to(torch.float64)
    sizes = torch.from_numpy(groups.sizes).to(ok.device, torch.float64)
    return (ok @ sizes).cpu().numpy().astype(np.int64)


def lid_mean(served_vectors: np.ndarray) -> float:
    """`lid_mean` of the rows in served order ([N, D] float32, host)."""
    v = np.ascontiguousarray(served_vectors, dtype=np.float32)
    n = v.shape[0]
    rng = np.random.default_rng(LID_SEED)
    idx = rng.choice(n, size=min(LID_SAMPLE, n), replace=False)
    q = v[idx]
    d = (v ** 2).sum(1)[None, :] - 2.0 * q @ v.T + (q ** 2).sum(1)[:, None]
    d = np.maximum(d, 0.0)
    kk = min(LID_K + 1, d.shape[1])
    part = np.sort(np.partition(d, kk - 1, axis=1)[:, :kk], axis=1)
    r = np.where(part[:, :1] < 1e-9, part[:, 1:kk], part[:, :kk - 1]) \
        if kk > 1 else part
    r = np.sqrt(r)
    ratio = np.clip(r / np.maximum(r[:, -1:], 1e-12), 1e-12, 1.0)
    m = np.mean(np.log(ratio), axis=1)
    return float(np.mean(-1.0 / np.minimum(m, -1e-9)))


class Router:
    """The artifact at `artifact_dir` (router.json, weights.npz) with the
    frozen table B at `table_path`."""

    def __init__(self, artifact_dir: str, table_path: str):
        with open(os.path.join(artifact_dir, "router.json")) as f:
            man = json.load(f)
        self.features = list(man["feature_names"])
        if self.features != ["selectivity", "lid_mean", "pred"]:
            raise ValueError(f"the reference knows the features "
                             f"selectivity, lid_mean, pred; the artifact "
                             f"has {self.features}")
        self.methods = list(man["methods"])
        with np.load(os.path.join(artifact_dir, man["weights"])) as z:
            self.mean = z["scaler/mean"].astype(np.float64)
            self.std = z["scaler/std"].astype(np.float64)
            self.layers = {
                m: [(z[f"model/{m}/{i}/w"].astype(np.float64),
                     z[f"model/{m}/{i}/b"].astype(np.float64))
                    for i in range(int(man["n_layers"][m]))]
                for m in self.methods}
        with open(table_path) as f:
            self.rows = json.load(f)["rows"]

    def feature_matrix(self, sel: np.ndarray, lid: float,
                       pred: str) -> np.ndarray:
        x = np.zeros((sel.shape[0], 5), dtype=np.float64)
        x[:, 0] = sel
        x[:, 1] = lid
        x[:, 2 + PRED_CODES[pred]] = 1.0
        return x

    def predict(self, x: np.ndarray, *, precision: str = "fp64"
                ) -> np.ndarray:
        """[Q, M] predicted recalls."""
        xs = (x - self.mean) / self.std
        out = []
        for m in self.methods:
            h = xs
            for i, (w, b) in enumerate(self.layers[m]):
                if precision == "tf32":
                    ht = round_tf32(torch.from_numpy(h.astype(np.float32)))
                    wt = round_tf32(torch.from_numpy(w.astype(np.float32)))
                    h = (ht @ wt).double().numpy() + b
                else:
                    h = h @ w + b
                if i < len(self.layers[m]) - 1:
                    h = np.maximum(h, 0.0)
            out.append(h[:, 0])
        return np.stack(out, axis=1)

    def _settings(self, ds: str, pt: int, method: str):
        return [(r["ps"], r) for r in self.rows
                if (r["ds"], int(r["pt"]), r["method"]) == (ds, pt, method)]

    def table_arrays(self, ds: str, pred: str, t: float):
        """Per method: (has a setting over T, its best QPS, that setting,
        the fallback setting)."""
        pt = PRED_CODES[pred]
        out = []
        for m in self.methods:
            rows = self._settings(ds, pt, m)
            over = [(ps, r) for ps, r in rows if r["recall"] >= t]
            best = max(over, key=lambda kv: kv[1]["qps"]) if over else None
            fb = best or (max(rows, key=lambda kv: (kv[1]["recall"],
                                                     kv[1]["qps"]))
                          if rows else None)
            out.append((best is not None,
                        best[1]["qps"] if best else -np.inf,
                        best[0] if best else None,
                        fb[0] if fb else None))
        return out

    def decide(self, r_hat: np.ndarray, ds: str, pred: str, t: float):
        """Algorithm 2: a (method, setting) per query."""
        arr = self.table_arrays(ds, pred, t)
        has = np.array([a[0] for a in arr])
        qps = np.array([a[1] for a in arr], dtype=np.float64)
        passing = (r_hat >= t) & has[None, :]
        out = []
        for qi in range(r_hat.shape[0]):
            if passing[qi].any():
                j = int(np.argmax(np.where(passing[qi], qps, -np.inf)))
                out.append((self.methods[j], arr[j][2]))
            else:
                j = int(np.argmax(r_hat[qi]))
                out.append((self.methods[j], arr[j][3]))
        return out
