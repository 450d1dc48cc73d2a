"""MLP-Reg — the paper's router model (§4.3): one 2-hidden-layer (64, 32)
ReLU MLP regressor per candidate method, trained with MSE + Adam and
evaluated together as one stacked forward, plus the MLP *classifier*
variant of the §6.2(b) ablation.

Training runs on a torch device ("cuda" by default) under autograd, with
the JAX package's recipe: He-normal weights and zero biases, the batch
order of `np.random.default_rng(seed)`, and its Adam
(`repro_torch.optim.adam_update` with `AdamConfig(lr=lr)`). The
initial weights come from a `torch.Generator` on the host, so one seed
starts the same fit on any device; the JAX package draws its own with
`jax.random`, and its parameters carry across through `init=` /
`params_from_numpy`."""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
from torch import nn

from repro_torch.ann.index import resolve_device
from repro_torch.optim import AdamConfig, adam_init, adam_update


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


# ---- training ---------------------------------------------------------------

def init_mlp(sizes: tuple, *, seed: int | None = None,
             generator: torch.Generator | None = None,
             device="cuda") -> list:
    """He-normal `randn · sqrt(2/din)` weights and zero biases for the
    layer widths `sizes`, drawn on the host from `generator` (or a fresh
    one seeded with `seed`) and moved to `device`."""
    if generator is None:
        if seed is None:
            raise ValueError("init_mlp needs seed= or generator=")
        generator = torch.Generator().manual_seed(int(seed))
    device = resolve_device(device)
    params = []
    for din, dout in zip(sizes[:-1], sizes[1:]):
        w = torch.randn((din, dout), generator=generator) * math.sqrt(2.0 / din)
        params.append({"w": w.to(device), "b": torch.zeros(dout, device=device)})
    return params


def forward(params: list, x: torch.Tensor) -> torch.Tensor:
    """`h @ w + b` per layer, ReLU between layers (none with one layer)."""
    h = x
    for layer in params[:-1]:
        h = torch.relu(h @ layer["w"] + layer["b"])
    return h @ params[-1]["w"] + params[-1]["b"]


def _mse_loss(params, x, y):
    pred = forward(params, x)[:, 0]
    return torch.mean((pred - y) ** 2)


def _ce_loss(params, x, y):
    logits = forward(params, x)
    return -torch.mean(torch.gather(
        torch.log_softmax(logits, -1), 1, y[:, None]))


def _adam_init(params: list) -> dict:
    """`optim.adam_init` with the router fits' `AdamConfig` (the JAX
    package's defaults: no weight decay, no moment compression)."""
    return adam_init(params, AdamConfig())


def _adam_update(grads: list, state: dict, params: list, lr: float) -> None:
    """One `optim.adam_update` step at `lr`, in place on `params` and
    `state`, as the JAX package's fits call it."""
    adam_update(grads, state, params, AdamConfig(lr=lr))


def _train_epoch(params: list, state: dict, xb: torch.Tensor,
                 yb: torch.Tensor, lr: float,
                 classification: bool) -> torch.Tensor:
    """One pass over the [steps, batch, ...] batches, updating `params`
    and `state` in place; returns the mean of the steps' losses as a
    0-dim tensor on the device (nothing is read back to the host)."""
    loss_fn = _ce_loss if classification else _mse_loss
    leaves = [v for p in params for v in p.values()]
    for v in leaves:
        v.requires_grad_(True)
    total = torch.zeros((), device=xb.device)
    try:
        for x, y in zip(xb, yb):
            loss = loss_fn(params, x, y)
            it = iter(torch.autograd.grad(loss, leaves))
            _adam_update([{k: next(it) for k in p} for p in params], state,
                         params, lr)
            total += loss.detach()
    finally:
        for v in leaves:
            v.requires_grad_(False)
    return total / xb.shape[0]


def train_mlp(x: np.ndarray, y: np.ndarray, *, hidden=(64, 32),
              n_out: int = 1, classification: bool = False,
              epochs: int = 200, batch: int = 256, lr: float = 1e-3,
              seed: int = 0, device="cuda", init: list | None = None) -> list:
    """Fit one MLP; returns its parameters (a list of {"w", "b"} tensors
    on `device`, "cuda" by default). y: [N] float (regression) or [N]
    int class labels (classification).

    `init`: starting parameters as numpy layer dicts (the JAX package's
    `params_to_numpy(init_mlp(...))`), else `init_mlp(seed=seed)`. The
    data moves to the device once; each epoch's batch order is one
    index tensor from `np.random.default_rng(seed)`, as in the JAX
    package."""
    device = resolve_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(seed)
    sizes = (x.shape[1],) + tuple(hidden) + (n_out,)
    params = (params_from_numpy(init, device) if init is not None
              else init_mlp(sizes, seed=seed, device=device))
    state = _adam_init(params)
    n = x.shape[0]
    batch = min(batch, n)
    steps = n // batch
    xt = torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32)).to(device)
    yt = torch.from_numpy(np.ascontiguousarray(
        y, dtype=np.int64 if classification else np.float32)).to(device)
    for _ in range(epochs):
        perm = torch.from_numpy(rng.permutation(n)[: steps * batch]).to(device)
        _train_epoch(params, state, xt[perm].reshape(steps, batch, -1),
                     yt[perm].reshape(steps, batch, *yt.shape[1:]), lr,
                     classification)
    return params


def predict(params: list, x: np.ndarray) -> np.ndarray:
    """Forward of the host array `x` on the parameters' device; the
    outputs back on the host."""
    dev = params[0]["w"].device
    xt = torch.as_tensor(np.asarray(x, dtype=np.float32)).to(dev)
    with torch.no_grad():
        return forward(params, xt).cpu().numpy()


def params_to_numpy(params: list) -> list:
    """Parameters as the numpy layer dicts that `MLRouter` and its
    artifact (`weights.npz`) store."""
    return [{k: v.detach().cpu().numpy() for k, v in l.items()}
            for l in params]
