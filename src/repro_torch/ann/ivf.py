"""IVF coarse quantizer: k-means build (numpy, offline) + padded list layout.

A copy of the JAX package's numpy build, so one dataset gives identical
index arrays in both packages. Lists are a dense padded
`[nlist, max_list]` int32 matrix (−1 padding): a probe is a row gather.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.ann import engine, topk


@dataclasses.dataclass
class IVFIndex:
    centroids: np.ndarray       # [nlist, d] float32
    centroid_norms: np.ndarray  # [nlist] float32
    lists: np.ndarray           # [nlist, max_list] int32, −1 pad
    list_len: np.ndarray        # [nlist] int32


def kmeans(x: np.ndarray, k: int, iters: int = 8, seed: int = 0,
           sample: int = 20000) -> np.ndarray:
    rng = np.random.default_rng(seed)
    n = x.shape[0]
    if n > sample:
        x_fit = x[rng.choice(n, sample, replace=False)]
    else:
        x_fit = x
    k = min(k, x_fit.shape[0])
    cent = x_fit[rng.choice(x_fit.shape[0], k, replace=False)].copy()
    for _ in range(iters):
        d = (cent ** 2).sum(1)[None, :] - 2.0 * x_fit @ cent.T
        assign = d.argmin(1)
        for j in range(k):
            m = assign == j
            if m.any():
                cent[j] = x_fit[m].mean(0)
    return cent.astype(np.float32)


def assign_to_centroids(x: np.ndarray, cent: np.ndarray, block: int = 8192) -> np.ndarray:
    out = np.empty(x.shape[0], dtype=np.int64)
    cn = (cent ** 2).sum(1)
    for s in range(0, x.shape[0], block):
        xb = x[s:s + block]
        d = cn[None, :] - 2.0 * xb @ cent.T
        out[s:s + block] = d.argmin(1)
    return out


def pack_lists(assign: np.ndarray, nlist: int,
               max_list_cap: int | None = None) -> tuple[np.ndarray, np.ndarray]:
    """Cluster assignments -> (`[nlist, max_list]` padded lists, fill counts).

    Each list fills in ascending row-id order and overflowing lists drop
    their highest row ids.
    """
    n = assign.shape[0]
    lens = np.bincount(assign, minlength=nlist)
    max_list = int(lens.max()) if lens.size else 1
    if max_list_cap is not None:
        max_list = min(max_list, max_list_cap)
    lists = np.full((nlist, max_list), -1, dtype=np.int32)
    order = np.argsort(assign, kind="stable")
    starts = np.zeros(nlist + 1, dtype=np.int64)
    np.cumsum(lens, out=starts[1:])
    pos = np.arange(n, dtype=np.int64) - starts[assign[order]]
    ok = pos < max_list
    lists[assign[order][ok], pos[ok]] = order[ok].astype(np.int32)
    return lists, np.minimum(lens, max_list).astype(np.int32)


def build_ivf(vectors: np.ndarray, nlist: int, *, seed: int = 0,
              max_list_cap: int | None = None) -> IVFIndex:
    cent = kmeans(vectors, nlist, seed=seed)
    nlist = cent.shape[0]
    assign = assign_to_centroids(vectors, cent)
    lists, fill = pack_lists(assign, nlist, max_list_cap)
    return IVFIndex(centroids=cent,
                    centroid_norms=(cent ** 2).sum(1).astype(np.float32),
                    lists=lists, list_len=fill)


def graft_ivf(old: IVFIndex, new_vectors: np.ndarray, old_to_new: np.ndarray,
              *, max_list_cap: int | None = None) -> IVFIndex:
    """Splice a compacted dataset into an existing IVF without re-running
    k-means: the centroids stay frozen, surviving rows keep their old
    list through the id remap `old_to_new` (old row -> new row, −1 =
    deleted), and only rows with no carried assignment (compacted delta
    rows, rows a capped layout had dropped) are assigned afresh. Equal to
    re-assigning and re-packing every row of `new_vectors` against the
    frozen centroids."""
    nlist = old.centroids.shape[0]
    assign = np.full(new_vectors.shape[0], -1, dtype=np.int64)
    rows_c, _ = np.nonzero(old.lists >= 0)
    mapped = old_to_new[old.lists[old.lists >= 0].astype(np.int64)]
    keep = mapped >= 0
    assign[mapped[keep]] = rows_c[keep]
    un = np.nonzero(assign < 0)[0]
    if un.size:
        assign[un] = assign_to_centroids(new_vectors[un], old.centroids)
    lists, fill = pack_lists(assign, nlist, max_list_cap)
    return IVFIndex(centroids=old.centroids, centroid_norms=old.centroid_norms,
                    lists=lists, list_len=fill)


class IVFMethod(engine.Method):
    """Build, persistence and compaction graft shared by the IVF-backed
    methods (k-means over the dataset with seed 13; the JAX package's
    array keys)."""

    def build(self, ds, build_params: dict) -> IVFIndex:
        return build_ivf(ds.vectors, int(build_params.get("nlist", 128)),
                         seed=13)

    def index_arrays(self, index: IVFIndex) -> dict:
        return {"centroids": index.centroids,
                "centroid_norms": index.centroid_norms,
                "lists": index.lists, "list_len": index.list_len}

    def index_from_arrays(self, ds, build_params: dict,
                          arrays: dict) -> IVFIndex:
        return IVFIndex(centroids=arrays["centroids"],
                        centroid_norms=arrays["centroid_norms"],
                        lists=arrays["lists"],
                        list_len=arrays["list_len"])

    def graft_index(self, new_ds, old_index: IVFIndex, old_ds, old_to_new,
                    new_rows, build_params) -> IVFIndex | None:
        if old_index.centroids.shape[0] == 0 or new_ds.n == 0:
            return None
        return graft_ivf(old_index, new_ds.vectors, old_to_new)


def probe_candidates(qvecs: torch.Tensor, centroids: torch.Tensor,
                     cnorms: torch.Tensor, lists: torch.Tensor,
                     nprobe: int) -> torch.Tensor:
    """[Q, nprobe · max_list] candidate row ids (−1 pad) of the `nprobe`
    nearest lists, nearest first (ties to the lower list id)."""
    _, probe = topk.smallest(topk.score_all(qvecs, centroids, cnorms),
                             nprobe)
    return lists[probe].reshape(qvecs.shape[0], -1)
