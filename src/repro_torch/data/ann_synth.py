"""Synthetic filtered-ANN dataset pool (host, numpy).

Same specs and the same RNG call sequence as the JAX package's
generator, so one `DatasetSpec` gives byte-identical vectors, bitmaps and
queries in both packages.

Vectors: Gaussian clusters on an `latent_dim`-dimensional manifold
embedded into `dim` ambient dims (controls LID), plus ambient noise.
Labels: a blend of cluster-preferred labels (label–vector coupling) and
global Zipf draws. Queries follow paper §6.1.3: query vector = base
vector + Gaussian noise at 10% of the median base norm; Equality/AND
carry 1–3 labels drawn from an existing vector's label set; OR carries a
broader 2–8 label set.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

from repro_torch.ann import labels as lb
from repro_torch.ann.dataset import ANNDataset, QuerySet, ground_truth_topk
from repro_torch.ann.predicates import Predicate


@dataclasses.dataclass(frozen=True)
class DatasetSpec:
    name: str
    n: int
    dim: int
    universe: int
    latent_dim: int          # manifold dim -> controls LID_mean
    n_clusters: int
    zipf_a: float            # label popularity skew
    avg_labels: float        # mean labels per vector
    coupling: float          # 0..1 share of labels taken from cluster-preferred pool
    noise: float             # ambient noise scale (raises LID)
    seed: int


def _scale() -> float:
    """Global dataset size multiplier (REPRO_ANN_SCALE env, default 1)."""
    return float(os.environ.get("REPRO_ANN_SCALE", "1.0"))


# Mirrors paper Table 2 (training), sizes cut for a CPU.
TRAIN_SPECS = {
    "arxiv":      DatasetSpec("arxiv",      9000, 96,  400, 12, 64, 1.3, 2.2, 0.5, 0.30, 101),
    "yfcc":       DatasetSpec("yfcc",      16000, 48, 2000, 10, 96, 1.2, 3.0, 0.5, 0.25, 102),
    "laion":      DatasetSpec("laion",     16000, 64,   30, 16, 48, 1.4, 1.6, 0.6, 0.35, 103),
    "tripclick":  DatasetSpec("tripclick", 16000, 96,   29, 14, 48, 1.5, 1.5, 0.6, 0.30, 104),
    "ytb_audio":  DatasetSpec("ytb_audio", 20000, 32,  500,  8, 80, 1.3, 2.0, 0.5, 0.20, 105),
    "ytb_video":  DatasetSpec("ytb_video",  8000, 128, 500, 128, 8, 1.3, 2.0, 0.3, 1.00, 106),
}

# Mirrors paper Table 4 (validation, unseen during router training).
VALIDATION_SPECS = {
    "synth_192d":    DatasetSpec("synth_192d",    12000, 48,  200, 10, 64, 1.2, 2.0, 0.5, 0.25, 201),
    "synth_512d":    DatasetSpec("synth_512d",    12000, 64,   30, 14, 48, 1.4, 1.6, 0.6, 0.30, 202),
    "synth_768d_hc": DatasetSpec("synth_768d_hc", 12000, 96, 1000, 20, 96, 1.2, 2.5, 0.4, 0.45, 203),
    "yahoo800k":     DatasetSpec("yahoo800k",     12000, 96,   14, 24, 32, 1.6, 1.3, 0.5, 0.50, 204),
    "dbpedia560k":   DatasetSpec("dbpedia560k",    9000, 96,   14, 22, 32, 1.6, 1.2, 0.5, 0.45, 205),
}

ALL_SPECS = {**TRAIN_SPECS, **VALIDATION_SPECS}


def synthesize(spec: DatasetSpec) -> ANNDataset:
    rng = np.random.default_rng(spec.seed)
    n, d, m, c = spec.n, spec.dim, spec.latent_dim, spec.n_clusters
    n = max(64, int(n * _scale()))

    # --- vectors: latent Gaussian clusters embedded into ambient space ---
    centers = rng.normal(0.0, 1.0, size=(c, m)).astype(np.float32) * 4.0
    assign = rng.integers(0, c, size=n)
    latent = centers[assign] + rng.normal(0.0, 1.0, size=(n, m)).astype(np.float32)
    basis = rng.normal(0.0, 1.0 / np.sqrt(m), size=(m, d)).astype(np.float32)
    vecs = latent @ basis + spec.noise * rng.normal(0.0, 1.0, size=(n, d)).astype(np.float32)

    # --- labels: cluster-preferred pool blended with global Zipf draws ---
    u = spec.universe
    pop = (np.arange(1, u + 1, dtype=np.float64)) ** (-spec.zipf_a)
    pop /= pop.sum()
    perm = rng.permutation(u)            # decouple label id from popularity rank
    pop = pop[np.argsort(perm)]
    pref_size = max(1, min(u, int(np.ceil(u / c)) + 2))
    cluster_pref = [rng.choice(u, size=pref_size, replace=False, p=pop) for _ in range(c)]

    label_sets: list[list[int]] = []
    counts = rng.poisson(max(spec.avg_labels - 1.0, 0.0), size=n) + 1
    for i in range(n):
        k = int(min(counts[i], u))
        ls: set[int] = set()
        pref = cluster_pref[assign[i]]
        while len(ls) < k:
            if rng.random() < spec.coupling:
                ls.add(int(pref[rng.integers(0, len(pref))]))
            else:
                ls.add(int(rng.choice(u, p=pop)))
        label_sets.append(sorted(ls))

    return ANNDataset.build(spec.name, vecs, label_sets, u)


def make_queries(ds: ANNDataset, pred: Predicate, n_queries: int, *,
                 k: int = 10, seed: int = 0,
                 with_ground_truth: bool = True) -> QuerySet:
    """Generate a filtered query workload per paper §6.1.3."""
    pred = Predicate(pred)
    rng = np.random.default_rng(seed + 7 * int(pred))
    n = ds.n
    base_idx = rng.integers(0, n, size=n_queries)
    med_norm = float(np.median(np.sqrt(ds.norms_sq)))
    qvecs = ds.vectors[base_idx] + (0.1 * med_norm / np.sqrt(ds.dim)) * \
        rng.normal(0.0, 1.0, size=(n_queries, ds.dim)).astype(np.float32)
    qvecs = qvecs.astype(np.float32)

    # label frequencies for OR sampling
    label_freq = np.zeros(ds.universe, dtype=np.float64)
    for g in range(ds.n_groups):
        for l in lb.unpack_one(ds.group_bitmaps[g]):
            label_freq[l] += float(ds.group_size[g])
    label_p = label_freq / label_freq.sum() if label_freq.sum() > 0 else None

    qbms = np.zeros((n_queries, ds.bitmaps.shape[1]), dtype=np.uint32)
    for qi in range(n_queries):
        src = lb.unpack_one(ds.bitmaps[rng.integers(0, n)])
        src_sorted = sorted(src)
        if pred == Predicate.EQUALITY:
            ls = src_sorted                      # exact existing label set
        elif pred == Predicate.AND:
            take = int(rng.integers(1, min(3, len(src_sorted)) + 1))
            ls = list(rng.choice(src_sorted, size=take, replace=False))
        else:  # OR: broader 2-8 labels, frequency-weighted
            take = int(rng.integers(2, 9))
            ls = list(np.unique(rng.choice(
                ds.universe, size=take, replace=True, p=label_p)))
        qbms[qi] = lb.pack_one([int(x) for x in ls], ds.universe)

    gt = (ground_truth_topk(ds, qvecs, qbms, pred, k)
          if with_ground_truth else np.full((n_queries, k), -1, np.int32))
    return QuerySet(dataset=ds.name, pred=pred, vectors=qvecs,
                    bitmaps=qbms, ground_truth=gt, k=k)
