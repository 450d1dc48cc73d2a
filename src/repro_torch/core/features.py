"""Router features — the 22 candidate features of paper §4.2.

Groups:
  (1) 6 query-aware     — n_labels, selectivity, min/max/mean per-label
                          frequency, label co-occurrence;
  (2) 15 dataset-level  — size, dim, LID mean/median/std, relative-contrast
                          median / 5–95% trimmed mean / p95, label
                          cardinality, label entropy, #unique label
                          combinations, avg labels per vector, distribution
                          factor (mean sliced Wasserstein), correlation
                          ratio, normalized correlation ratio;
  (3) 1 predicate type  — categorical (one-hot in the model input).

The final minimal set (paper §6.2): ``selectivity, lid_mean, pred``.

Everything is float64 numpy on the host, as in the JAX package, except
the per-query match counts behind `selectivity`: on a CUDA handle they
come from the `selectivity` kernel over the device-resident bitmaps, on
a CPU handle (or without one) from the group-table reduction. Both are
exact integer counts divided by n, so the columns are bit-identical
across devices.

A live handle (`repro_torch.ann.live.LiveFilteredIndex` or
`ShardedLiveIndex`, anything with `live_stats()`) corrects the columns to
its live rows: selectivity
counts lose the tombstoned base rows' matches and gain the live delta
rows', over the live row count; the per-label frequencies and the
`size` feature are the live ones.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.ann.dataset import ANNDataset
from repro_torch.ann.engine import to_device
from repro_torch.ann.predicates import Predicate
from repro_torch.kernels import ops

QUERY_FEATURES = [
    "n_labels", "selectivity", "min_label_freq", "max_label_freq",
    "mean_label_freq", "label_cooccurrence",
]
DATASET_FEATURES = [
    "size", "dim", "lid_mean", "lid_median", "lid_std",
    "rc_median", "rc_trimmed_mean", "rc_p95",
    "label_cardinality", "label_entropy", "n_label_combinations",
    "avg_labels_per_vector", "distribution_factor",
    "correlation_ratio", "normalized_correlation_ratio",
]
NUMERIC_FEATURES = QUERY_FEATURES + DATASET_FEATURES   # 21 numeric
ALL_FEATURES = NUMERIC_FEATURES + ["pred"]             # + categorical = 22

MINIMAL_FEATURES = ["selectivity", "lid_mean", "pred"]  # paper's final set


# ---------------------------------------------------------------------------
# dataset-level features
# ---------------------------------------------------------------------------

def _knn_dists(vectors: np.ndarray, queries: np.ndarray, k: int) -> np.ndarray:
    """[Q, k] ascending Euclidean distances (self-matches removed)."""
    n2 = (vectors ** 2).sum(1)
    d = n2[None, :] - 2.0 * queries @ vectors.T + (queries ** 2).sum(1)[:, None]
    d = np.maximum(d, 0.0)
    kk = min(k + 1, d.shape[1])
    part = np.partition(d, kk - 1, axis=1)[:, :kk]
    part = np.sort(part, axis=1)
    # drop a zero self-distance column if present
    out = np.where(part[:, :1] < 1e-9, part[:, 1:kk], part[:, :kk - 1]) \
        if kk > 1 else part
    return np.sqrt(out)


def lid_mle(r: np.ndarray) -> np.ndarray:
    """Maximum-likelihood LID per query from ascending kNN distances r [Q,k]
    (paper Eq. 3)."""
    rk = r[:, -1:]
    ratio = np.clip(r / np.maximum(rk, 1e-12), 1e-12, 1.0)
    m = np.mean(np.log(ratio), axis=1)
    return -1.0 / np.minimum(m, -1e-9)


def _sliced_w1(a: np.ndarray, b: np.ndarray, n_proj: int, rng) -> float:
    """Mean sliced Wasserstein-1 distance between point sets a and b."""
    d = a.shape[1]
    dirs = rng.normal(size=(n_proj, d))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    qs = np.linspace(0.02, 0.98, 25)
    tot = 0.0
    for u in dirs:
        pa = np.quantile(a @ u, qs)
        pb = np.quantile(b @ u, qs)
        tot += np.abs(pa - pb).mean()
    return tot / n_proj


@dataclasses.dataclass
class DatasetFeatures:
    values: dict[str, float]
    label_freq: np.ndarray      # [U] fraction of vectors carrying each label


def _unpack_bits(qbms: np.ndarray, universe: int) -> np.ndarray:
    """[Q, W] uint32 packed bitmaps -> [Q, universe] bool membership."""
    shifts = np.arange(32, dtype=np.uint32)
    bits = (qbms[:, :, None] >> shifts) & np.uint32(1)   # [Q, W, 32]
    return bits.astype(bool).reshape(qbms.shape[0], -1)[:, :universe]


def dataset_features(ds: ANNDataset, *, sample: int = 256, k: int = 20,
                     seed: int = 0, fx=None) -> DatasetFeatures:
    """All 15 dataset-level features (+ the per-label carrier fractions).

    Args:
        ds: the dataset.
        sample/k/seed: LID/RC estimation knobs (deterministic in seed).
        fx: the caller's `FilteredIndex` for `ds`; the features are
            cached on it and freed by its `close()`. Without one they are
            computed afresh.
    """
    feats = getattr(fx, "_features", None)
    if feats is not None:
        return feats
    rng = np.random.default_rng(seed)
    n = ds.n
    idx = rng.choice(n, size=min(sample, n), replace=False)
    r = _knn_dists(ds.vectors, ds.vectors[idx], k)
    lid = lid_mle(r)
    rc = r[:, -1] / np.maximum(r[:, 0], 1e-12)

    # label structure: per-label carrier fraction via one group-table pass
    sizes = ds.group_size.astype(np.float64)
    gbits = _unpack_bits(ds.group_bitmaps, ds.universe)  # [G, U]
    label_freq = (sizes[:, None] * gbits).sum(0) / n
    p = label_freq[label_freq > 0]
    entropy = float(-(p * np.log(p)).sum())
    avg_labels = float(label_freq.sum())

    # distribution factor + correlation ratios over frequent labels
    freq_labels = np.argsort(-label_freq)[:64]
    freq_labels = [int(l) for l in freq_labels if label_freq[l] * n >= 20]
    df_vals, cr_num, cr_norm_num, cr_den = [], 0.0, 0.0, 0.0
    glob_idx = rng.choice(n, size=min(1024, n), replace=False)
    lid_global = float(np.mean(lid))
    for l in freq_labels[:32]:
        word, bit = l >> 5, np.uint32(1) << np.uint32(l & 31)
        mem = np.nonzero((ds.bitmaps[:, word] & bit) != 0)[0]
        if mem.size < 20:
            continue
        sub = ds.vectors[mem[rng.permutation(mem.size)[:256]]]
        df_vals.append(_sliced_w1(sub, ds.vectors[glob_idx], 6, rng))
        r_sub = _knn_dists(sub, sub[: min(64, sub.shape[0])], min(10, sub.shape[0] - 2))
        lid_sub = float(np.mean(lid_mle(r_sub)))
        rnd = ds.vectors[rng.choice(n, size=sub.shape[0], replace=False)]
        r_rnd = _knn_dists(rnd, rnd[: min(64, rnd.shape[0])], min(10, rnd.shape[0] - 2))
        lid_rnd = float(np.mean(lid_mle(r_rnd)))
        w = float(mem.size)
        cr_num += w * lid_sub
        cr_norm_num += w * (lid_sub / max(lid_rnd, 1e-9))
        cr_den += w
    tm_lo, tm_hi = np.quantile(rc, [0.05, 0.95])
    trimmed = rc[(rc >= tm_lo) & (rc <= tm_hi)]
    values = {
        "size": float(n),
        "dim": float(ds.dim),
        "lid_mean": float(np.mean(lid)),
        "lid_median": float(np.median(lid)),
        "lid_std": float(np.std(lid)),
        "rc_median": float(np.median(rc)),
        "rc_trimmed_mean": float(trimmed.mean() if trimmed.size else rc.mean()),
        "rc_p95": float(np.quantile(rc, 0.95)),
        "label_cardinality": float(ds.universe),
        "label_entropy": entropy,
        "n_label_combinations": float(ds.n_groups),
        "avg_labels_per_vector": avg_labels,
        "distribution_factor": float(np.mean(df_vals)) if df_vals else 0.0,
        "correlation_ratio": float(cr_num / cr_den / max(lid_global, 1e-9)) if cr_den else 1.0,
        "normalized_correlation_ratio": float(cr_norm_num / cr_den) if cr_den else 1.0,
    }
    feats = DatasetFeatures(values=values, label_freq=label_freq)
    if fx is not None and not fx.closed:   # never resurrect closed state
        fx._features = feats
    return feats


# ---------------------------------------------------------------------------
# per-query features
# ---------------------------------------------------------------------------

_LIVE_UNKNOWN = object()   # "look it up" sentinel for the live= kwargs


def _live_of(fx):
    """The handle's `LiveStats` when `fx` is a live index (anything with
    `live_stats()`), else None."""
    get = getattr(fx, "live_stats", None)
    return get() if callable(get) else None


def _match_counts(qbms: np.ndarray, bitmaps: np.ndarray,
                  pred: Predicate) -> np.ndarray:
    """[Q] exact predicate match counts of each query against a small row
    set (word-looped, unweighted): the live corrections."""
    pred = Predicate(pred)
    q, w = qbms.shape
    n = bitmaps.shape[0]
    if pred == Predicate.EQUALITY:
        ok = np.ones((q, n), dtype=bool)
        for i in range(w):
            ok &= bitmaps[None, :, i] == qbms[:, i, None]
    elif pred == Predicate.OR:
        ok = np.zeros((q, n), dtype=bool)
        for i in range(w):
            ok |= (bitmaps[None, :, i] & qbms[:, i, None]) != 0
    else:                                       # AND
        ok = np.ones((q, n), dtype=bool)
        for i in range(w):
            qw = qbms[:, i, None]
            ok &= (bitmaps[None, :, i] & qw) == qw
    return ok.sum(1).astype(np.float64)


def batch_selectivity(ds: ANNDataset, qbms: np.ndarray,
                      pred: Predicate, *, fx=None,
                      live=_LIVE_UNKNOWN) -> np.ndarray:
    """[Q] predicate selectivity fractions for a whole query batch.

    On a CUDA handle `fx` the base counts are one `selectivity` kernel
    launch over the handle's device-resident [N, W] bitmaps; otherwise
    one word-looped group-table reduction (G ≪ N rows, weighted by group
    size). Both are exact. When `fx` is a live handle the counts are
    corrected exactly to its live rows (matches on tombstoned base rows
    subtracted, matches on live delta rows added) and the fraction is
    taken over the live row count. Callers that already hold a
    `LiveStats` pass it as `live=` (one snapshot per feature pass);
    `live=None` forces the sealed path.
    """
    if live is _LIVE_UNKNOWN:
        live = _live_of(fx)
    if live is None:
        return _base_selectivity(ds, qbms, pred, fx=fx)
    # count base matches against the snapshot's base (LiveStats.base_ds):
    # the group-table path stays consistent with the corrections under a
    # racing compaction; the kernel path reads the handle's current base
    base_ds = live.base_ds
    if base_ds is None or base_ds.n == 0:
        counts = np.zeros(qbms.shape[0], dtype=np.float64)
    else:
        counts = _base_selectivity(base_ds, qbms, pred, fx=fx) * base_ds.n
    if live.base_tomb_bitmaps.shape[0]:
        counts = counts - _match_counts(qbms, live.base_tomb_bitmaps, pred)
    if live.delta_bitmaps.shape[0]:
        counts = counts + _match_counts(qbms, live.delta_bitmaps, pred)
    return np.maximum(counts, 0.0) / max(live.n_live, 1)


def _base_selectivity(ds: ANNDataset, qbms: np.ndarray,
                      pred: Predicate, *, fx=None) -> np.ndarray:
    """Sealed-base selectivity fractions (over `ds.n`); see
    `batch_selectivity`."""
    pred = Predicate(pred)
    if fx is not None and fx.torch_device.type == "cuda":
        counts = ops.selectivity(to_device(qbms, fx.torch_device),
                                 fx.device.bitmaps, pred=int(pred))
        return counts.cpu().numpy().astype(np.float64) / ds.n
    return _group_table_selectivity(ds, qbms, pred)


def _group_table_selectivity(ds: ANNDataset, qbms: np.ndarray,
                             pred: Predicate) -> np.ndarray:
    """Host selectivity over the group table (the JAX package's off-TPU
    path)."""
    # queries repeat label sets heavily (they are drawn from base vectors):
    # evaluate unique bitmaps once and scatter the results back
    uq, inv = np.unique(qbms, axis=0, return_inverse=True)
    if uq.shape[0] < qbms.shape[0]:
        return _group_table_selectivity(ds, uq, pred)[inv.reshape(-1)]

    gb = ds.group_bitmaps                       # [G, W]
    q, w = qbms.shape
    g = gb.shape[0]
    if pred == Predicate.EQUALITY:
        if g == 0:
            return np.zeros(q, dtype=np.float64)
        # exact-match selectivity: each query matches at most one (unique)
        # group bitmap — a hashed searchsorted probe
        mults = np.random.default_rng(0x9E3779B9).integers(
            1, 2 ** 63, size=w, dtype=np.uint64) * 2 + 1
        gh = (gb.astype(np.uint64) * mults[None, :]).sum(1, dtype=np.uint64)
        order = np.argsort(gh, kind="stable")
        ghs = gh[order]
        if not (ghs[1:] == ghs[:-1]).any():
            qh = (qbms.astype(np.uint64) * mults[None, :]).sum(
                1, dtype=np.uint64)
            cand = order[np.clip(np.searchsorted(ghs, qh), 0, g - 1)]
            hit = (gh[cand] == qh) & (gb[cand] == qbms).all(1)
            counts = np.where(hit, ds.group_size[cand], 0)
            return counts.astype(np.float64) / ds.n
        # hash collision between two distinct groups: full compare
        ok = np.ones((q, g), dtype=bool)
        for i in range(w):
            ok &= gb[None, :, i] == qbms[:, i, None]
    elif pred == Predicate.OR:
        ok = np.zeros((q, g), dtype=bool)
        for i in range(w):
            ok |= (gb[None, :, i] & qbms[:, i, None]) != 0
    else:                                       # AND
        ok = np.ones((q, g), dtype=bool)
        for i in range(w):
            qw = qbms[:, i, None]
            ok &= (gb[None, :, i] & qw) == qw
    return (ok @ ds.group_size.astype(np.float64)) / ds.n


def query_feature_arrays(ds: ANNDataset, dsf: DatasetFeatures,
                         qbms: np.ndarray, pred: Predicate, *,
                         fx=None, live=_LIVE_UNKNOWN) -> dict:
    """All 6 query-aware features for a whole batch: name -> [Q] float64.
    For a live handle the per-label frequencies are the live ones
    (`fx.live_stats()`, or the `LiveStats` passed as `live=`)."""
    bits = _unpack_bits(qbms, ds.universe)                 # [Q, U] bool
    nl = bits.sum(1)
    if live is _LIVE_UNKNOWN:
        live = _live_of(fx)
    lf = (dsf.label_freq if live is None else live.label_freq)[None, :]
    has = nl > 0
    minf = np.where(has, np.min(np.where(bits, lf, np.inf), axis=1), 0.0)
    maxf = np.where(has, np.max(np.where(bits, lf, -np.inf), axis=1), 0.0)
    meanf = np.where(has, (bits * lf).sum(1) / np.maximum(nl, 1), 0.0)
    sel = batch_selectivity(ds, qbms, pred, fx=fx, live=live)
    cooc = sel if Predicate(pred) == Predicate.AND \
        else batch_selectivity(ds, qbms, Predicate.AND, fx=fx, live=live)
    return {
        "n_labels": nl.astype(np.float64),
        "selectivity": sel,
        "min_label_freq": minf,
        "max_label_freq": maxf,
        "mean_label_freq": meanf,
        "label_cooccurrence": cooc,
    }


def feature_matrix(ds: ANNDataset, qbms: np.ndarray, pred: Predicate,
                   feature_names: list[str], *, fx=None) -> np.ndarray:
    """[Q, F(+2 for one-hot pred)] raw feature matrix in `feature_names`
    order; 'pred' expands to a 3-way one-hot. `fx`: the caller's
    `FilteredIndex` (device for the selectivity counts, and the
    dataset-feature cache); a live handle also corrects the
    selectivity, label-frequency and `size` columns to its live rows."""
    dsf = dataset_features(ds, fx=fx)
    nq = qbms.shape[0]
    live = _live_of(fx)        # one consistent snapshot per feature pass
    qf = query_feature_arrays(ds, dsf, qbms, pred, fx=fx, live=live) \
        if any(n in QUERY_FEATURES for n in feature_names) else {}
    cols = []
    for name in feature_names:
        if name == "pred":
            oh = np.zeros((nq, 3))
            oh[:, int(Predicate(pred))] = 1.0
            cols.append(oh)
        elif name in QUERY_FEATURES:
            cols.append(np.asarray(qf[name], dtype=np.float64)[:, None])
        else:
            val = dsf.values[name]
            if live is not None and name == "size":
                val = float(live.n_live)
            cols.append(np.full((nq, 1), val))
    return np.concatenate(cols, axis=1).astype(np.float32)
