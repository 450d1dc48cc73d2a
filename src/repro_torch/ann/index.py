"""`FilteredIndex` — the owned serving handle over one dataset, on one
torch device.

* device tensors (vectors / norms / bitmaps / group tables) are built
  lazily on first use and freed by `close()`;
* per-(method, build-params) indexes are built on demand;
* the host-array upload cache (`as_device`) is per-handle.

Alongside it live the typed request/result objects: `QueryBatch`
(vectors + bitmaps + predicate + k, validated on construction) and
`SearchResult` (ids, exact distances, per-query routing decisions, stage
timings).
"""

from __future__ import annotations

import dataclasses
import time
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.ann import registry as registry_mod
from repro_torch.ann.dataset import ANNDataset
from repro_torch.ann.engine import (DeviceData, Method, ParamSetting,
                                    resolve_setting, to_device)
from repro_torch.ann.predicates import Predicate


class RoutingDecision(NamedTuple):
    """Per-query routing outcome; compares and unpacks like the
    `(method, ps_id)` pairs."""
    method: str
    ps_id: str | None


@dataclasses.dataclass(frozen=True)
class QueryBatch:
    """A validated batch of filtered queries of one predicate type.

    Args:
        vectors: [Q, d] query embeddings (coerced to float32).
        bitmaps: [Q, W] packed query label sets (coerced to uint32).
        pred: the batch's `Predicate` (or its int value).
        k: result width per query (>= 1).
    Raises:
        ValueError: on construction, for non-2-D vectors/bitmaps, a Q
            mismatch between them, an empty batch, or k < 1.
    """
    vectors: np.ndarray       # [Q, d] float32
    bitmaps: np.ndarray       # [Q, W] uint32 packed label sets
    pred: Predicate
    k: int = 10

    def __post_init__(self):
        vectors = np.asarray(self.vectors, dtype=np.float32)
        bitmaps = np.asarray(self.bitmaps, dtype=np.uint32)
        if vectors.ndim != 2:
            raise ValueError(
                f"QueryBatch.vectors must be [Q, d]; got shape "
                f"{vectors.shape}")
        if bitmaps.ndim != 2:
            raise ValueError(
                f"QueryBatch.bitmaps must be [Q, W]; got shape "
                f"{bitmaps.shape}")
        if vectors.shape[0] != bitmaps.shape[0]:
            raise ValueError(
                f"QueryBatch vectors/bitmaps disagree on Q: "
                f"{vectors.shape[0]} vs {bitmaps.shape[0]}")
        if vectors.shape[0] == 0:
            raise ValueError("QueryBatch must contain at least one query")
        if int(self.k) < 1:
            raise ValueError(f"QueryBatch.k must be >= 1; got {self.k}")
        object.__setattr__(self, "vectors", vectors)
        object.__setattr__(self, "bitmaps", bitmaps)
        object.__setattr__(self, "pred", Predicate(self.pred))
        object.__setattr__(self, "k", int(self.k))

    @property
    def q(self) -> int:
        return int(self.vectors.shape[0])

    @property
    def dim(self) -> int:
        return int(self.vectors.shape[1])

    def take(self, idxs) -> "QueryBatch":
        """Sub-batch at the given query indices (for group dispatch)."""
        idxs = np.asarray(idxs)
        return QueryBatch(self.vectors[idxs], self.bitmaps[idxs],
                          self.pred, self.k)

    @staticmethod
    def from_queryset(qs, k: int | None = None) -> "QueryBatch":
        """Adapt a `repro_torch.ann.dataset.QuerySet`."""
        return QueryBatch(qs.vectors, qs.bitmaps, qs.pred,
                          qs.k if k is None else k)


@dataclasses.dataclass
class SearchResult:
    """Typed result batch.

    * `ids` — [Q, k] int32 base ids, −1 padded;
    * `distances` — [Q, k] float32 exact squared-L2 distances for the
      returned ids (NaN where the id is −1);
    * `decisions` — per-query `RoutingDecision` (None for direct
      single-method searches);
    * `timings` — stage wall-clock seconds (`route_s`, `search_s`,
      `total_s`);
    * `keys` — [Q, k] int64 stable external keys (−1 pad); for a sealed
      index they equal the row ids.
    * `cache` — per-query serving provenance when a
      `repro_torch.ann.cache.SemanticResultCache` fronted the request: a
      [Q] list of ``"exact"`` / ``"semantic"`` / ``"transfer"`` / None
      (None for a query that missed and was searched). None (default)
      means no cache was involved.
    """
    ids: np.ndarray
    distances: np.ndarray
    decisions: list[RoutingDecision] | None = None
    timings: dict = dataclasses.field(default_factory=dict)
    keys: np.ndarray | None = None
    cache: list | None = None

    @property
    def q(self) -> int:
        return int(self.ids.shape[0])

    @property
    def k(self) -> int:
        return int(self.ids.shape[1])


def exact_distances(raw_scores: np.ndarray, ids: np.ndarray,
                    qvecs: np.ndarray) -> np.ndarray:
    """Ranking scores (‖v‖² − 2·q·v) -> exact squared-L2, NaN at −1 pad."""
    qn = np.sum(np.asarray(qvecs, dtype=np.float32) ** 2, axis=1)
    d = np.asarray(raw_scores, dtype=np.float32) + qn[:, None]
    d = np.maximum(d, 0.0)          # float round-off can dip below zero
    return np.where(ids >= 0, d, np.float32(np.nan)).astype(np.float32)


def resolve_device(device) -> torch.device:
    """`device` as a `torch.device`; a CUDA device without a card raises
    (the port never moves to the CPU by itself)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "the port's handles default to device='cuda' and no CUDA device "
            "is available; pass device='cpu' to run on the CPU")
    return dev


class FilteredIndex:
    """Owned per-dataset serving handle on one torch device.

    Args:
        ds: the dataset this handle serves.
        registry: optional `MethodRegistry` overriding the default when
            method names are resolved (`search("prefilter")` etc.).
        device: where the tensors live; "cuda" (default) or "cpu". With
            the default and no card, construction raises RuntimeError.

    Scores stay in full fp32: the handle turns TF32 off for matmuls and
    cuDNN (`torch.backends.cuda.matmul.allow_tf32` /
    `torch.backends.cudnn.allow_tf32`), the precision the JAX
    reference's parity holds to.
    """

    def __init__(self, ds: ANNDataset, *, registry=None, device="cuda"):
        self.torch_device = resolve_device(device)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.ds = ds
        self._registry = registry
        self._device: DeviceData | None = None
        self._indexes: dict = {}     # (method_name, build_tuple) -> index
        self._arrays: dict = {}      # id(host_array) -> (host, device)
        self._features = None        # repro_torch.core.features.DatasetFeatures
        self._closed = False

    # ---- lifecycle ------------------------------------------------------
    @property
    def closed(self) -> bool:
        return self._closed

    def close(self) -> None:
        """Drop every owned device tensor, upload, built index, and cached
        feature state. Subsequent use raises RuntimeError."""
        self._device = None
        self._indexes.clear()
        self._arrays.clear()
        self._features = None
        self._closed = True

    def __enter__(self) -> "FilteredIndex":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def _check_open(self) -> None:
        if self._closed:
            raise RuntimeError(
                f"FilteredIndex({self.ds.name!r}) is closed")

    # ---- owned device state ---------------------------------------------
    @property
    def device(self) -> DeviceData:
        """Device-resident dataset tensors (built lazily, owned).
        Raises RuntimeError if the handle is closed."""
        self._check_open()
        if self._device is None:
            self._device = _build_device_data(self.ds, self.torch_device)
        return self._device

    def as_device(self, x: np.ndarray) -> torch.Tensor:
        """Cached host→device upload, keyed by the array's identity."""
        self._check_open()
        key = id(x)
        hit = self._arrays.get(key)
        if hit is None or hit[0] is not x:
            hit = (x, to_device(x, self.torch_device))
            self._arrays[key] = hit
        return hit[1]

    # ---- built indexes ---------------------------------------------------
    def _resolve_method(self, method) -> Method:
        if isinstance(method, str):
            reg = self._registry or registry_mod.default_registry()
            return reg.get(method)
        return method

    def get_index(self, method, build_params: tuple | dict | None = None):
        """Built (offline) index for (method, build-params), cached."""
        self._check_open()
        method = self._resolve_method(method)
        if build_params is None:
            build_params = ()
        if isinstance(build_params, dict):
            build_params = tuple(sorted(build_params.items()))
        key = (method.name, build_params)
        if key not in self._indexes:
            kw = ({"device": self.torch_device} if method.builds_on_device
                  else {})
            self._indexes[key] = method.build(self.ds, dict(build_params),
                                              **kw)
        return self._indexes[key]

    def adopt_index(self, method, build_params, index) -> None:
        """Install an already-built index under (method, build-params),
        keyed as `get_index` keys it (the compaction graft hands its
        spliced indexes over here)."""
        self._check_open()
        method = self._resolve_method(method)
        if build_params is None:
            build_params = ()
        if isinstance(build_params, dict):
            build_params = tuple(sorted(build_params.items()))
        self._indexes[(method.name, tuple(build_params))] = index

    def built_keys(self) -> list[tuple]:
        """Keys of every built index: (method_name, build_params_tuple).
        `LiveFilteredIndex.compact` replays these against the new base."""
        return list(self._indexes.keys())

    @property
    def generation(self) -> int:
        """A sealed index never remaps rows — constant 0, mirroring the
        live handles so telemetry events carry a uniform field."""
        return 0

    def keys_of(self, ids) -> np.ndarray:
        """Stable external keys for result ids (−1 stays −1): a sealed
        index never remaps rows, so keys are the row ids."""
        ids = np.asarray(ids, dtype=np.int64)
        return np.where(ids >= 0, ids, np.int64(-1))

    def label_clock(self, labels=None) -> int:
        """Sealed data never changes — constant 0, mirroring the live
        handles' per-label write clock so the result cache's staleness
        check (`repro_torch.ann.cache`) reads one uniform surface."""
        return 0

    def evict(self, method_name: str | None = None) -> int:
        """Drop built indexes (all of one method, or every method).
        Returns the number of evicted entries."""
        keys = [k for k in self._indexes
                if method_name is None or k[0] == method_name]
        for k in keys:
            del self._indexes[k]
        return len(keys)

    def stats(self) -> dict:
        """Snapshot of the handle's owned state (for logging/debugging)."""
        return {
            "dataset": self.ds.name,
            "n": self.ds.n,
            "device": str(self.torch_device),
            "device_resident": self._device is not None,
            "built_indexes": sorted(k[0] for k in self._indexes),
            "cached_uploads": len(self._arrays),
            "features_cached": self._features is not None,
            "closed": self._closed,
        }

    # ---- search ----------------------------------------------------------
    def run_method(self, method, setting: ParamSetting,
                   batch: QueryBatch) -> tuple[np.ndarray, np.ndarray]:
        """Raw single-method execution: ([Q, k] ids, [Q, k] ranking
        scores ‖v‖²−2·q·v), numpy."""
        if batch.bitmaps.shape[1] != self.ds.bitmaps.shape[1]:
            raise ValueError(
                f"QueryBatch bitmap width {batch.bitmaps.shape[1]} does "
                f"not match dataset width {self.ds.bitmaps.shape[1]}")
        if batch.dim != self.ds.dim:
            raise ValueError(
                f"QueryBatch vector dim {batch.dim} does not match "
                f"dataset dim {self.ds.dim}")
        method = self._resolve_method(method)
        index = self.get_index(method, setting.build)
        return method.search(self, index, batch.vectors, batch.bitmaps,
                             batch.pred, batch.k, setting.search_dict)

    def search(self, batch: QueryBatch, method,
               setting: ParamSetting | str | None = None) -> SearchResult:
        """Direct single-method search (no routing).

        Args:
            batch: the validated query batch.
            method: a `Method` instance or registered method name.
            setting: a `ParamSetting`, a ps_id string, or None (the
                method's max-budget setting).
        Returns: a `SearchResult` with [Q, k] ids + exact squared-L2
            distances (`decisions` is None).
        """
        method = self._resolve_method(method)
        if not isinstance(setting, ParamSetting):
            setting = resolve_setting(method, setting)
        t0 = time.perf_counter()
        ids, raw = self.run_method(method, setting, batch)
        dt = time.perf_counter() - t0
        return SearchResult(
            ids=ids, distances=exact_distances(raw, ids, batch.vectors),
            decisions=None, timings={"search_s": dt, "total_s": dt},
            keys=self.keys_of(ids))


def _build_device_data(ds: ANNDataset, device: torch.device) -> DeviceData:
    g = ds.n_groups
    cent = np.zeros((g, ds.dim), dtype=np.float32)
    for j in range(g):
        s, l = int(ds.group_start[j]), int(ds.group_size[j])
        cent[j] = ds.vectors[s:s + l].mean(0)
    return DeviceData(
        vectors=to_device(ds.vectors, device),
        norms=to_device(ds.norms_sq, device),
        bitmaps=to_device(ds.bitmaps, device),
        group_bitmaps=to_device(ds.group_bitmaps, device),
        group_start=to_device(ds.group_start, device),
        group_size=to_device(ds.group_size, device),
        group_centroids=to_device(cent, device),
        group_cnorms=to_device((cent ** 2).sum(1).astype(np.float32), device),
    )


# ---------------------------------------------------------------------------
# default pool — for callers that pass bare ANNDataset objects (the
# offline stage's `collect`, `bench.run_method`). Each entry is an
# ordinary owned FilteredIndex; `clear_pool` closes them all.
# ---------------------------------------------------------------------------

_POOL: dict[tuple, FilteredIndex] = {}


def default_index(ds: ANNDataset, device="cuda") -> FilteredIndex:
    """Process-wide shared handle for `ds` on `device` (keyed by content
    identity and device; "cuda" by default, which raises without a
    card)."""
    device = resolve_device(device)
    key = (ds.cache_key(), device)
    fx = _POOL.get(key)
    if fx is None or fx.closed:
        fx = FilteredIndex(ds, device=device)
        _POOL[key] = fx
    return fx


def as_index(obj, device="cuda"):
    """Coerce an ANNDataset to its pooled handle on `device`; pass any
    handle through unchanged (whatever its device)."""
    return default_index(obj, device) if isinstance(obj, ANNDataset) else obj


def clear_pool() -> None:
    """Close and drop every pooled handle."""
    for fx in _POOL.values():
        fx.close()
    _POOL.clear()
