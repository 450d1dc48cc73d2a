"""Shared execution machinery for filtered-ANN methods.

* `DeviceData` — per-dataset device-resident tensors (vectors, norms,
  bitmaps, group tables), owned by `repro_torch.ann.index.FilteredIndex`.
* word-looped predicate masks, shared [Q, N] and per-candidate [Q, C],
  that avoid materialising `[Q, N, W]` / `[Q, C, W]` temporaries.
* query chunking: every method runs on fixed-size query chunks, with
  host-side padding of the tail chunk, as the JAX package does.
* per-call stage timings, thread-local, that the sharded handle reports
  and `RouterService.execute` drains into `SearchResult.timings`.
"""

from __future__ import annotations

import dataclasses
import threading
import warnings

import numpy as np
import torch

from repro_torch.ann import labels as lb
from repro_torch.ann.dataset import ANNDataset
from repro_torch.ann.predicates import Predicate, eval_predicate

DEFAULT_QCHUNK = 64


# ---------------------------------------------------------------------------
# per-call stage timing plumbing
# ---------------------------------------------------------------------------

class StageTimings(threading.local):
    """Thread-local per-search stage timing accumulator.

    Search internals call `add(stage, seconds)`; the outermost caller
    drains with `pop()`. Thread-local so concurrent searches (the queue's
    executor, sharded fan-out threads) never cross-contaminate."""

    def __init__(self):
        self.stages: dict[str, float] = {}

    def add(self, stage: str, seconds: float) -> None:
        self.stages[stage] = self.stages.get(stage, 0.0) + seconds

    def pop(self) -> dict[str, float]:
        out = dict(self.stages)
        self.stages.clear()
        return out


STAGE_TIMINGS = StageTimings()


def stage_add(stage: str, seconds: float) -> None:
    STAGE_TIMINGS.add(stage, seconds)


def pop_stage_timings() -> dict[str, float]:
    """Drain the calling thread's accumulated per-stage timings."""
    return STAGE_TIMINGS.pop()


@dataclasses.dataclass(frozen=True)
class DeviceData:
    vectors: torch.Tensor         # [N, d] f32
    norms: torch.Tensor           # [N] f32
    bitmaps: torch.Tensor         # [N, W] int32 view of the uint32 words
    group_bitmaps: torch.Tensor   # [G, W] int32
    group_start: torch.Tensor     # [G] i32
    group_size: torch.Tensor      # [G] i32
    group_centroids: torch.Tensor  # [G, d] f32
    group_cnorms: torch.Tensor     # [G] f32


# ---------------------------------------------------------------------------
# predicate mask (int32 bitmap views)
# ---------------------------------------------------------------------------

def mask_shared(base_bm: torch.Tensor, q_bm: torch.Tensor, pred) -> torch.Tensor:
    """base [N, W] × query [Q, W] -> bool [Q, N], word-looped (no 3-D temp)."""
    return eval_predicate(base_bm[None, :, :], q_bm[:, None, :], pred)


def mask_cand(cand_bm: torch.Tensor, q_bm: torch.Tensor, pred) -> torch.Tensor:
    """candidates [Q, C, W] × query [Q, W] -> bool [Q, C]."""
    return eval_predicate(cand_bm, q_bm[:, None, :], pred)


# ---------------------------------------------------------------------------
# query chunking
# ---------------------------------------------------------------------------

def to_device(x: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host array -> tensor on `device`; uint32 bitmaps become int32
    views of the same bits. A read-only array (a segment's `np.memmap`)
    is copied on the host only for a CPU tensor, which would alias it;
    an upload to the card copies it there and reads it only once."""
    x = np.asarray(x)
    if not x.flags.writeable and torch.device(device).type == "cpu":
        x = np.array(x)
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", "The given NumPy array is not "
                                "writable", UserWarning)
        if x.dtype == np.uint32:
            return lb.bitmap_tensor(x, device)
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def run_chunked(fn, n_queries: int, *arrays, chunk: int = DEFAULT_QCHUNK,
                extra_host=None):
    """Run `fn(chunked_arrays..., extra_host_chunk...)` over fixed-size query
    chunks; pads the tail chunk by repeating its last query; returns the
    outputs concatenated on the host (numpy).

    arrays: per-query numpy arrays, leading axis Q. extra_host: same.
    `fn` may return a single array or tensor, or a tuple of them — tuple
    outputs are concatenated position-wise (e.g. (ids, dists)).
    """
    outs = []
    for s in range(0, n_queries, chunk):
        e = min(s + chunk, n_queries)
        pad = chunk - (e - s)
        parts = []
        for a in list(arrays) + list(extra_host or ()):
            part = a[s:e]
            if pad:
                part = np.concatenate([part, np.repeat(part[-1:], pad, axis=0)], axis=0)
            parts.append(part)
        res = fn(*parts)
        if isinstance(res, tuple):
            outs.append(tuple(_host(r)[: e - s] for r in res))
        else:
            outs.append(_host(res)[: e - s])
    if isinstance(outs[0], tuple):
        return tuple(np.concatenate([o[i] for o in outs], axis=0)
                     for i in range(len(outs[0])))
    return np.concatenate(outs, axis=0)


# ---------------------------------------------------------------------------
# method interface
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ParamSetting:
    ps_id: str
    build: tuple       # sorted (key, value) pairs — hashable
    search: tuple

    @property
    def build_dict(self):
        return dict(self.build)

    @property
    def search_dict(self):
        return dict(self.search)


def ps(ps_id: str, build: dict | None = None, search: dict | None = None) -> ParamSetting:
    return ParamSetting(ps_id,
                        tuple(sorted((build or {}).items())),
                        tuple(sorted((search or {}).items())))


def resolve_setting(method: "Method", ps_id: str | None) -> ParamSetting:
    """The method's setting for `ps_id`, else its max-budget setting (the
    fallback for deployment datasets the offline table hasn't covered)."""
    settings = method.param_settings()
    for s in settings:
        if s.ps_id == ps_id:
            return s
    return settings[-1]


class Method:
    """Interface all filtered-ANN methods implement.

    Methods are stateless: all per-dataset state (device tensors, upload
    cache, built indexes) is owned by the `FilteredIndex` handle passed
    to `search`.
    """

    name: str = "?"
    # True where `build` and `graft_index` take the handle's torch device
    # as `device=` (`FilteredIndex.get_index` and live compaction pass it)
    builds_on_device: bool = False

    def param_settings(self) -> list[ParamSetting]:
        raise NotImplementedError

    def build(self, ds: ANNDataset, build_params: dict):
        """Offline index build; returns opaque index object."""
        return None

    def index_arrays(self, index) -> dict | None:
        """Persistable form of a built index (a dict of numpy arrays, the
        same keys as the JAX package's), or None."""
        return None

    def index_from_arrays(self, ds: ANNDataset, build_params: dict,
                          arrays: dict):
        """Inverse of `index_arrays`."""
        raise NotImplementedError(
            f"method {self.name!r} does not persist its index")

    def search(self, fx, index, qvecs: np.ndarray, qbms: np.ndarray,
               pred: Predicate, k: int, search_params: dict):
        """Batched filtered search on the handle `fx`. Returns
        ([Q, k] int32 ids with −1 pad, [Q, k] float32 ranking scores
        ‖v‖² − 2·q·v, +inf where the id is −1), both numpy."""
        raise NotImplementedError

    def graft_index(self, new_ds: ANNDataset, old_index, old_ds: ANNDataset,
                    old_to_new: np.ndarray, new_rows: np.ndarray,
                    build_params: dict):
        """Incremental rebuild for compaction: splice the rows of `new_ds`
        into `old_index` through the id remap `old_to_new` (old row -> new
        row, −1 = deleted); `new_rows` are the new ids that were not in
        `old_ds` (compacted delta rows). Returns the grafted index, or
        None (the default) for the caller to build from scratch."""
        return None
