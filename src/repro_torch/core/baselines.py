"""Model-family baselines for the §6.2(b) classification-vs-regression
ablation: {LogisticReg, MLP, RandomForest} classifiers and
{Ridge, MLP-Reg, RF-Reg} regressors, all sharing features and labels.

Ridge and the forests run on the host in numpy, as in the JAX package;
the MLP rows train through `mlp.train_mlp` on `device` ("cuda" by
default)."""

from __future__ import annotations

import numpy as np

from repro_torch.core import mlp
from repro_torch.core.forest import RandomForest


# ---- regressors -------------------------------------------------------------

def ridge_fit(x: np.ndarray, y: np.ndarray, lam: float = 1e-2):
    xb = np.concatenate([x, np.ones((x.shape[0], 1))], axis=1)
    a = xb.T @ xb + lam * np.eye(xb.shape[1])
    w = np.linalg.solve(a, xb.T @ y)
    return w


def ridge_predict(w: np.ndarray, x: np.ndarray) -> np.ndarray:
    xb = np.concatenate([x, np.ones((x.shape[0], 1))], axis=1)
    return xb @ w


class PerMethodRegressor:
    """Wraps any per-method scalar regressor into a [Q, M] recall predictor."""

    def __init__(self, kind: str, seed: int = 0, device="cuda"):
        self.kind = kind
        self.seed = seed
        self.device = device
        self.models = []

    def fit(self, x: np.ndarray, y: np.ndarray) -> "PerMethodRegressor":
        m = y.shape[1]
        self.models = []
        for j in range(m):
            if self.kind == "ridge":
                self.models.append(ridge_fit(x, y[:, j]))
            elif self.kind == "mlp":
                self.models.append(mlp.train_mlp(
                    x, y[:, j], hidden=(64, 32), seed=self.seed + j,
                    device=self.device))
            elif self.kind == "rf":
                self.models.append(RandomForest(
                    n_trees=20, max_depth=8, seed=self.seed + j).fit(x, y[:, j]))
            else:
                raise ValueError(self.kind)
        return self

    def predict(self, x: np.ndarray) -> np.ndarray:
        cols = []
        for mdl in self.models:
            if self.kind == "ridge":
                cols.append(ridge_predict(mdl, x))
            elif self.kind == "mlp":
                cols.append(mlp.predict(mdl, x)[:, 0])
            else:
                cols.append(mdl.predict(x))
        return np.stack(cols, axis=1)


# ---- classifiers ------------------------------------------------------------

class BestMethodClassifier:
    """Predicts the argmax-recall method directly (top-1 label)."""

    def __init__(self, kind: str, n_classes: int, seed: int = 0,
                 device="cuda"):
        self.kind = kind
        self.n_classes = n_classes
        self.seed = seed
        self.device = device
        self.model = None

    def fit(self, x: np.ndarray, y_best: np.ndarray) -> "BestMethodClassifier":
        if self.kind == "logistic":
            self.model = mlp.train_mlp(x, y_best, hidden=(),
                                       n_out=self.n_classes,
                                       classification=True, seed=self.seed,
                                       device=self.device)
        elif self.kind == "mlp":
            self.model = mlp.train_mlp(x, y_best, hidden=(64, 32),
                                       n_out=self.n_classes,
                                       classification=True, seed=self.seed,
                                       device=self.device)
        elif self.kind == "rf":
            onehot = np.eye(self.n_classes, dtype=np.float32)[y_best]
            self.model = RandomForest(n_trees=20, max_depth=8,
                                      seed=self.seed).fit(x, onehot)
        else:
            raise ValueError(self.kind)
        return self

    def predict(self, x: np.ndarray) -> np.ndarray:
        if self.kind in ("logistic", "mlp"):
            return mlp.predict(self.model, x).argmax(1)
        return self.model.predict(x).argmax(1)
