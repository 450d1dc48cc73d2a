"""MLP-Reg — the paper's router model (§4.3): one 2-hidden-layer (64, 32)
ReLU MLP regressor per candidate method, evaluated together as one
stacked forward. Inference only; training is still done by the JAX
package, whose parameters load here through `params_from_numpy`."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from repro_torch.ann.index import resolve_device


@dataclasses.dataclass
class Scaler:
    mean: np.ndarray
    std: np.ndarray

    @staticmethod
    def fit(x: np.ndarray) -> "Scaler":
        return Scaler(mean=x.mean(0), std=x.std(0) + 1e-8)

    def transform(self, x: np.ndarray) -> np.ndarray:
        return ((x - self.mean) / self.std).astype(np.float32)


def params_from_numpy(layers: list, device) -> list:
    """The JAX package's parameters (a list of {"w": [din, dout],
    "b": [dout]} numpy layer dicts, as `router.json`/`weights.npz` store
    them) -> the same list of float32 torch tensors on `device`."""
    return [{k: torch.tensor(np.asarray(v, dtype=np.float32),
                             device=device) for k, v in layer.items()}
            for layer in layers]


class StackedMLP(nn.Module):
    """M structurally identical MLPs in one forward: x [Q, F] ->
    [M, Q, n_out], ReLU between layers, `h @ w + b` per layer as in the
    JAX package's `forward`."""

    def __init__(self, models: list, device="cuda"):
        """`models`: M lists of numpy layer dicts (one list per model);
        `device` "cuda" (default, raises without a card) or "cpu"."""
        super().__init__()
        device = resolve_device(device)
        per_model = [params_from_numpy(m, device) for m in models]
        n_layers = len(per_model[0])
        self.weights = nn.ParameterList(
            nn.Parameter(torch.stack([m[i]["w"] for m in per_model]),
                         requires_grad=False) for i in range(n_layers))
        self.biases = nn.ParameterList(
            nn.Parameter(torch.stack([m[i]["b"] for m in per_model]),
                         requires_grad=False) for i in range(n_layers))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x.expand(self.weights[0].shape[0], *x.shape)     # [M, Q, F]
        last = len(self.weights) - 1
        for i, (w, b) in enumerate(zip(self.weights, self.biases)):
            h = torch.bmm(h, w) + b[:, None, :]
            if i < last:
                h = torch.relu(h)
        return h
