"""`ShardedFilteredIndex` — one dataset row-partitioned across devices.

The dataset is split into contiguous row shards (`ANNDataset.row_slice`),
each shard is an ordinary owned `FilteredIndex` on its own device
(round-robin over the host's CUDA devices — `distributed.shard_devices`;
on a one-card host every shard shares the card), and a batched search
runs every shard in parallel before a cross-shard top-k merge
(`ops.merge_topk`, the hand-written CUDA merge kernel on a CUDA handle).

The handle exposes the same `run_method`/`search`/`close` surface as
`FilteredIndex`, so `RouterService` (and its `ShardedRouterService`
subclass) dispatches through it unchanged: a batch is routed **once** —
one fused MLP forward over full-dataset features — and only the chosen
(method, ps) execution fans out per shard. Shard-local ids are globalised
with each shard's row offset (row slices preserve row order), which is
what lets the merge treat per-shard candidates as disjoint.

Under an active trace (`repro_torch.ann.trace`) each fan-out opens one
`shard` span a shard and the cross-shard fold a `merge` span, as the
JAX package's handle does. On a card these spans time the host: the
enqueue of each launch plus the device-to-host copies inside it, not
the device's own time.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from repro_torch.ann import registry as registry_mod
from repro_torch.ann import trace
from repro_torch.ann.dataset import ANNDataset
from repro_torch.ann.distributed import shard_bounds, shard_devices
from repro_torch.ann.engine import (ParamSetting, pop_stage_timings,
                                    resolve_setting, stage_add, to_device)
from repro_torch.ann.index import (FilteredIndex, QueryBatch, SearchResult,
                                   exact_distances)
from repro_torch.kernels import ops


def stack_candidates(parts) -> tuple[np.ndarray, np.ndarray]:
    """Stack per-segment (ids, raw) pairs into [S, Q, K] arrays.

    Segments may disagree on their candidate width K; narrower segments
    are padded with −1 ids / +inf scores, which `ops.merge_topk` treats
    as invalid slots. Ids must already be global (disjoint across parts).
    """
    kmax = max(i.shape[1] for i, _ in parts)
    ids, raws = [], []
    for i, r in parts:
        i = np.asarray(i, dtype=np.int32)
        r = np.asarray(r, dtype=np.float32)
        pad = kmax - i.shape[1]
        if pad:
            i = np.concatenate(
                [i, np.full((i.shape[0], pad), -1, np.int32)], axis=1)
            r = np.concatenate(
                [r, np.full((r.shape[0], pad), np.inf, np.float32)], axis=1)
        ids.append(i)
        raws.append(r)
    return np.stack(ids), np.stack(raws)


def merge_candidates(ids: np.ndarray, raw: np.ndarray, k: int,
                     device) -> tuple[np.ndarray, np.ndarray]:
    """Reduce [S, Q, K] globalised candidates to the global top-k through
    `ops.merge_topk` on `device` (the merge kernel on a CUDA device).
    Returns ([Q, k] i32 ids with −1 pad, [Q, k] f32 scores with +inf at
    −1), numpy."""
    gids, graw = ops.merge_topk(to_device(ids, device),
                                to_device(raw, device), k=k)
    return gids.cpu().numpy(), graw.cpu().numpy()


class ShardedFilteredIndex:
    """Row-sharded serving handle: one `FilteredIndex` per shard plus the
    cross-shard merge. API-compatible with `FilteredIndex` wherever the
    serving layer touches it (`ds`, `run_method`, `search`, lifecycle).

    Args:
        ds: the full dataset. Row-partitioned; the parent is kept for
            routing features and exact distances (shards hold views of
            its host arrays — no vector copy on the host).
        n_shards: number of row shards (ignored when `bounds` is given).
        bounds: optional explicit shard boundaries [S+1] (ragged shards);
            defaults to `distributed.shard_bounds(ds.n, n_shards)`.
        device: "cuda" (default: round-robin over the host's cards, all
            shards on the one card of a one-card host), "cuda:i", or
            "cpu". With a CUDA device and no card, construction raises
            RuntimeError.
        registry: optional `MethodRegistry` forwarded to every shard.
        parallel: fan shard execution out over a thread pool (the
            kernels release the GIL while they are enqueued and the host
            waits on the device without it, so shards overlap). Serial
            when False or with a single shard.

    Raises:
        ValueError: if bounds are not a strictly increasing cover of
            [0, ds.n], or n_shards is out of range.
    """

    def __init__(self, ds: ANNDataset, n_shards: int = 1, *, bounds=None,
                 device="cuda", registry=None, parallel: bool = True):
        if bounds is None:
            bounds = shard_bounds(ds.n, n_shards)
        bounds = np.asarray(bounds, dtype=np.int64)
        if bounds.ndim != 1 or bounds.size < 2 or bounds[0] != 0 \
                or bounds[-1] != ds.n or np.any(np.diff(bounds) <= 0):
            raise ValueError(
                f"shard bounds must strictly increase from 0 to n={ds.n}; "
                f"got {bounds.tolist()}")
        devices = shard_devices(bounds.size - 1, device)
        self.ds = ds
        self.bounds = bounds
        self.shards = [
            FilteredIndex(ds.row_slice(int(s), int(e),
                                       name=f"{ds.name}/shard{i}"),
                          registry=registry, device=devices[i])
            for i, (s, e) in enumerate(zip(bounds[:-1], bounds[1:]))]
        self._registry = registry
        self._parallel = bool(parallel) and len(self.shards) > 1
        self._pool = (ThreadPoolExecutor(
            max_workers=len(self.shards),
            thread_name_prefix=f"shard-{ds.name}") if self._parallel
            else None)
        self._feature_fx: FilteredIndex | None = None
        self._feature_lock = threading.Lock()
        self._features = None        # routing-feature cache (full dataset)
        self._closed = False

    # ---- lifecycle ------------------------------------------------------
    @property
    def n_shards(self) -> int:
        return len(self.shards)

    @property
    def closed(self) -> bool:
        return self._closed

    def close(self) -> None:
        """Close every shard handle (and the feature handle, if built) and
        shut the dispatch pool down. Idempotent."""
        for fx in self.shards:
            fx.close()
        with self._feature_lock:
            if self._feature_fx is not None:
                self._feature_fx.close()
                self._feature_fx = None
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None
        self._features = None
        self._closed = True

    def __enter__(self) -> "ShardedFilteredIndex":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def _check_open(self) -> None:
        if self._closed:
            raise RuntimeError(
                f"ShardedFilteredIndex({self.ds.name!r}) is closed")

    # ---- routing-feature surface (parent dataset, shard-0 device) -------
    @property
    def torch_device(self):
        """Shard 0's device: where the routing features run and where the
        cross-shard merge runs."""
        return self.shards[0].torch_device

    @property
    def feature_index(self) -> FilteredIndex:
        """Owned `FilteredIndex` over the *full* dataset on shard 0's
        device — backs the `selectivity` kernel of the routing features
        (per-shard bitmaps would under-count). Built at first use."""
        self._check_open()
        with self._feature_lock:
            if self._feature_fx is None:
                self._feature_fx = FilteredIndex(
                    self.ds, registry=self._registry,
                    device=self.torch_device)
            return self._feature_fx

    @property
    def device(self):
        """Full-dataset device tensors (routing-feature path only; shard
        execution uses each shard's own tensors)."""
        return self.feature_index.device

    # ---- search ----------------------------------------------------------
    def shard_candidates(self, method, setting: ParamSetting,
                         batch: QueryBatch) -> list:
        """Every shard's `FilteredIndex.run_method` on its own tensors (in
        parallel on the pool), with shard-local ids globalised by the
        shard row offsets: one ([Q, k] ids, [Q, k] raw scores) pair per
        shard, on the host. Per-shard wall seconds accumulate on the
        calling thread's stage slate as `shard{j}_s`, and the straggler
        that bounds the fan-out, which a sum would hide, as
        `shard_max_s`. Under an active trace each shard's run is a
        `shard` child span, attached across the pool's threads."""
        self._check_open()
        parent = trace.current()
        times = [0.0] * len(self.shards)

        def shard_run(jfx):
            j, fx = jfx
            s0 = time.perf_counter()
            with trace.attach(parent):
                with trace.span("shard", shard=j):
                    out = fx.run_method(method, setting, batch)
            times[j] = time.perf_counter() - s0
            return out

        if self._pool is not None:
            per = list(self._pool.map(shard_run, enumerate(self.shards)))
        else:
            per = [shard_run(jfx) for jfx in enumerate(self.shards)]
        for j, s in enumerate(times):
            stage_add(f"shard{j}_s", s)
        stage_add("shard_max_s", max(times))
        return [(np.where(np.asarray(i) >= 0,
                          np.asarray(i) + np.int32(off), -1), r)
                for (i, r), off in zip(per, self.bounds[:-1])]

    def run_method(self, method, setting: ParamSetting,
                   batch: QueryBatch) -> tuple[np.ndarray, np.ndarray]:
        """Raw sharded execution of one (method, setting) over the batch:
        `shard_candidates`, then the [S, Q, k] candidates reduce to the
        global top-k through `ops.merge_topk`. Each shard returns its
        candidates on the host, so the merge sees every shard's finished
        output.

        Returns: ([Q, k] int32 global ids with −1 pad, [Q, k] float32
        ranking scores ‖v‖² − 2·q·v with +inf at −1) — the contract of
        `FilteredIndex.run_method`.

        Stage seconds accumulate on the calling thread's slate
        (`shard{j}_s`, `shard_max_s`, and `merge_s` for the stack and the
        merge), drained by `pop_stage_timings()`. Under an active trace
        the fan-out is one `shard` span a shard and the fold a `merge`
        span.
        Raises: RuntimeError if closed; ValueError on shape mismatch.
        """
        parts = self.shard_candidates(method, setting, batch)
        t_merge = time.perf_counter()
        with trace.span("merge", shards=len(parts)):
            ids, raw = stack_candidates(parts)
            out = merge_candidates(ids, raw, batch.k, self.torch_device)
        stage_add("merge_s", time.perf_counter() - t_merge)
        return out

    def pop_stage_timings(self) -> dict[str, float]:
        """Drain the calling thread's per-stage timings (`shard{j}_s`
        fan-out seconds, `shard_max_s` straggler, `merge_s`)."""
        return pop_stage_timings()

    def search(self, batch: QueryBatch, method,
               setting: ParamSetting | str | None = None) -> SearchResult:
        """Direct single-method sharded search (no routing).

        Args/semantics match `FilteredIndex.search`; `search_s` covers
        the whole fan-out + cross-shard merge.
        """
        self._check_open()
        if isinstance(method, str):
            method = (self._registry
                      or registry_mod.default_registry()).get(method)
        if not isinstance(setting, ParamSetting):
            setting = resolve_setting(method, setting)
        t0 = time.perf_counter()
        ids, raw = self.run_method(method, setting, batch)
        dt = time.perf_counter() - t0
        return SearchResult(
            ids=ids, distances=exact_distances(raw, ids, batch.vectors),
            decisions=None, timings={"search_s": dt, "total_s": dt},
            keys=self.keys_of(ids))

    @property
    def generation(self) -> int:
        """Sealed sharded indexes never remap rows — constant 0,
        mirroring `FilteredIndex` so telemetry events carry a uniform
        generation field across handle types."""
        return 0

    # ---- stable external keys -------------------------------------------
    def keys_of(self, ids) -> np.ndarray:
        """Stable external keys for global result ids: identity on a
        sealed sharded index (rows never remap), −1 stays −1."""
        ids = np.asarray(ids, dtype=np.int64)
        return np.where(ids >= 0, ids, np.int64(-1))

    def label_clock(self, labels=None) -> int:
        """Sealed data never changes — constant 0, the surface the live
        handles' per-label write clock shares (the result cache reads
        it)."""
        return 0

    # ---- maintenance -----------------------------------------------------
    def evict(self, method_name: str | None = None) -> int:
        """Drop built indexes on every shard; returns total evictions."""
        return sum(fx.evict(method_name) for fx in self.shards)

    def stats(self) -> dict:
        """Aggregate + per-shard state snapshot."""
        return {
            "dataset": self.ds.name,
            "n": self.ds.n,
            "n_shards": self.n_shards,
            "shard_rows": np.diff(self.bounds).tolist(),
            "parallel": self._pool is not None,
            "features_cached": self._features is not None,
            "closed": self._closed,
            "shards": [fx.stats() for fx in self.shards],
        }
