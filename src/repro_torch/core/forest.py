"""CART trees + RandomForest (numpy) — used for (a) the RandomForest
feature-importance ranking driving the paper's nested feature ablation
(§6.2a) and (b) the RF-Reg / RF-classifier rows of Table 6.

Trees are array-encoded (feature/threshold/left/right/value) for fast
vectorised prediction. `y` may be [N] (regression) or [N, C] one-hot
(classification-as-regression, argmax at predict) — the SSE split
criterion covers both.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Tree:
    feature: np.ndarray     # [nodes] int32, -1 = leaf
    threshold: np.ndarray   # [nodes] float32
    left: np.ndarray        # [nodes] int32
    right: np.ndarray       # [nodes] int32
    value: np.ndarray       # [nodes, C] float32 leaf means


def _best_split(x, y, feat_ids, n_thresholds, min_leaf):
    """Vectorised best (feature, threshold) by SSE reduction."""
    n = x.shape[0]
    ysum = y.sum(0)
    ysq = (y * y).sum()
    base = ysq - (ysum * ysum).sum() / n
    best = (None, None, 0.0)
    for f in feat_ids:
        xv = x[:, f]
        qs = np.unique(np.quantile(xv, np.linspace(0.05, 0.95, n_thresholds)))
        if qs.size == 0:
            continue
        m = xv[None, :] <= qs[:, None]                    # [T, N]
        nl = m.sum(1).astype(np.float64)                  # [T]
        ok = (nl >= min_leaf) & (n - nl >= min_leaf)
        if not ok.any():
            continue
        sl = m.astype(np.float64) @ y                     # [T, C]
        sr = ysum[None, :] - sl
        with np.errstate(divide="ignore", invalid="ignore"):
            sse = ysq - (sl * sl).sum(1) / np.maximum(nl, 1) \
                      - (sr * sr).sum(1) / np.maximum(n - nl, 1)
        red = np.where(ok, base - sse, -np.inf)
        j = int(np.argmax(red))
        if red[j] > best[2]:
            best = (f, float(qs[j]), float(red[j]))
    return best


def fit_tree(x: np.ndarray, y: np.ndarray, *, max_depth=8, min_leaf=8,
             n_thresholds=12, rng=None, max_features=None,
             importance=None) -> Tree:
    if y.ndim == 1:
        y = y[:, None]
    n, f = x.shape
    nodes = {"feature": [], "threshold": [], "left": [], "right": [], "value": []}

    def new_node():
        for k in nodes:
            nodes[k].append(0 if k != "value" else np.zeros(y.shape[1]))
        return len(nodes["feature"]) - 1

    def build(idx, depth):
        node = new_node()
        yy = y[idx]
        nodes["value"][node] = yy.mean(0)
        nodes["feature"][node] = -1
        if depth >= max_depth or idx.size < 2 * min_leaf:
            return node
        feat_ids = np.arange(f)
        if max_features and rng is not None:
            feat_ids = rng.choice(f, size=min(max_features, f), replace=False)
        fid, thr, red = _best_split(x[idx], yy, feat_ids, n_thresholds, min_leaf)
        if fid is None or red <= 1e-12:
            return node
        if importance is not None:
            importance[fid] += red
        m = x[idx, fid] <= thr
        nodes["feature"][node] = fid
        nodes["threshold"][node] = thr
        nodes["left"][node] = build(idx[m], depth + 1)
        nodes["right"][node] = build(idx[~m], depth + 1)
        return node

    build(np.arange(n), 0)
    return Tree(
        feature=np.asarray(nodes["feature"], np.int32),
        threshold=np.asarray(nodes["threshold"], np.float32),
        left=np.asarray(nodes["left"], np.int32),
        right=np.asarray(nodes["right"], np.int32),
        value=np.stack(nodes["value"]).astype(np.float32))


def predict_tree(t: Tree, x: np.ndarray) -> np.ndarray:
    idx = np.zeros(x.shape[0], dtype=np.int32)
    active = t.feature[idx] >= 0
    while active.any():
        f = t.feature[idx]
        go_left = x[np.arange(x.shape[0]), np.maximum(f, 0)] <= t.threshold[idx]
        nxt = np.where(go_left, t.left[idx], t.right[idx])
        idx = np.where(active, nxt, idx)
        active = t.feature[idx] >= 0
    return t.value[idx]


class RandomForest:
    """Regression (y [N]) or classification-as-regression (y [N, C])."""

    def __init__(self, n_trees=20, max_depth=8, min_leaf=8, seed=0,
                 max_features=None):
        self.n_trees = n_trees
        self.max_depth = max_depth
        self.min_leaf = min_leaf
        self.seed = seed
        self.max_features = max_features
        self.trees: list[Tree] = []
        self.feature_importances_: np.ndarray | None = None

    def fit(self, x: np.ndarray, y: np.ndarray) -> "RandomForest":
        rng = np.random.default_rng(self.seed)
        n = x.shape[0]
        imp = np.zeros(x.shape[1])
        self.trees = []
        mf = self.max_features or max(1, int(np.sqrt(x.shape[1])))
        for _ in range(self.n_trees):
            boot = rng.integers(0, n, size=n)
            self.trees.append(fit_tree(
                x[boot], y[boot] if y.ndim == 1 else y[boot, :],
                max_depth=self.max_depth, min_leaf=self.min_leaf,
                rng=rng, max_features=mf, importance=imp))
        tot = imp.sum()
        self.feature_importances_ = imp / tot if tot > 0 else imp
        return self

    def predict(self, x: np.ndarray) -> np.ndarray:
        out = sum(predict_tree(t, x) for t in self.trees) / len(self.trees)
        return out[:, 0] if out.shape[1] == 1 else out
