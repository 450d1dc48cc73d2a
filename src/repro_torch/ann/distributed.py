"""Distributed filtered-ANN search: the corpus sharded over a mesh.

The base vectors (and their norms and label bitmaps) are sharded by rows
along the mesh's `data` axis (composed with `pod` on multi-pod meshes),
the queries are replicated, each rank computes a *local* masked top-k
with the fused mask + distance + top-k kernel (`ops.masked_topk`), and
an `all_gather` of the small [Q, k] per-shard lists is folded into the
global top-k by the merge kernel (`ops.merge_topk`). Collective volume
per query is `shards × k × 8` bytes, independent of corpus size.

Two layers share this row-partition scheme:

* `make_sharded_search` (here) — one function over a `launch.mesh`
  mesh, run by every rank; exact brute force only.
* `repro_torch.ann.sharded.ShardedFilteredIndex` — host-orchestrated:
  one owned `FilteredIndex` per shard (any registered method) with the
  cross-shard `ops.merge_topk` reduction. `shard_bounds` cuts its rows
  and `shard_devices` places them.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed._functional_collectives as funcol

from repro_torch.ann import engine
from repro_torch.ann.index import resolve_device
from repro_torch.kernels import ops


def shard_bounds(n: int, n_shards: int) -> np.ndarray:
    """Balanced contiguous row partition: [S+1] boundaries with every
    shard size n//S or n//S + 1 (the first `n % S` shards take the extra
    row). Raises ValueError unless 1 <= n_shards <= n."""
    if not 1 <= n_shards <= n:
        raise ValueError(f"need 1 <= n_shards <= n; got {n_shards}, n={n}")
    base, extra = divmod(n, n_shards)
    sizes = np.full(n_shards, base, dtype=np.int64)
    sizes[:extra] += 1
    return np.concatenate([[0], np.cumsum(sizes)])


def shard_devices(n_shards: int, device="cuda") -> list[torch.device]:
    """One torch device per shard. "cuda" (the default) round-robins over
    every CUDA device of the host, so on a one-card host all shards share
    it; "cuda:i" or "cpu" puts every shard there. Raises RuntimeError for
    a CUDA device when there is no card."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        count = torch.cuda.device_count()
        return [torch.device("cuda", i % count) for i in range(n_shards)]
    return [dev] * n_shards


def shard_rows(x, mesh, data_axes=("data",)):
    """This rank's rows of `x` (a host array or tensor every rank holds
    whole) as a DTensor on `mesh`, sharded by rows over `data_axes` (the
    first outermost) and replicated over the other axes: each rank
    copies only its own rows to its device. uint32 bitmaps become int32
    views of the same bits. The rows must divide evenly over the axes."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.launch.mesh import on_device

    names = mesh.mesh_dim_names
    n = x.shape[0]
    size, index = 1, 0
    for ax in data_axes:
        d = names.index(ax)
        size *= mesh.size(d)
        index = index * mesh.size(d) + mesh.get_local_rank(ax)
    if n % size:
        raise ValueError(f"{n} rows do not divide over {size} shards of "
                         f"{data_axes}")
    rows = n // size
    local = x[index * rows:(index + 1) * rows]
    dev = on_device(mesh)
    local = (engine.to_device(np.asarray(local), dev)
             if isinstance(local, np.ndarray)
             else local.to(dev).contiguous())
    place = [Shard(0) if a in data_axes else Replicate() for a in names]
    return DTensor.from_local(local, mesh, place, run_check=False)


def make_sharded_search(mesh, *, k: int, data_axes=("data",)):
    """Sharded brute-force filtered search over `mesh`.

    Returns fn(qvecs, qbms, pred, vectors, norms, bitmaps) -> [Q, k]
    int32 global ids (−1 pads), the same on every rank, as the JAX
    package's replicated output. Every rank calls it at once. The base
    arrays are DTensors sharded by rows over `data_axes` (`shard_rows`
    places them); the queries are this rank's copies (host arrays or
    tensors). Each rank scans its rows with `ops.masked_topk`, offsets
    its ids by its shard's first row (the shard index composed over
    `data_axes`, the first outermost, as the JAX package composes it),
    gathers every shard's [Q, k] ids and distances over those axes, and
    folds the [S, Q, k] lists with `ops.merge_topk`: ties go to the
    lowest shard, then the lowest slot, the order of the JAX package's
    top-k over the shard-major flatten."""
    names = mesh.mesh_dim_names
    dims = [names.index(ax) for ax in data_axes]

    def search(qvecs, qbms, pred, vectors, norms, bitmaps):
        base, nrm, bms = (t.to_local() for t in (vectors, norms, bitmaps))
        dev = base.device
        size = base.shape[0]
        offset = 0
        for ax in data_axes:
            offset = offset * mesh.size(names.index(ax)) + \
                mesh.get_local_rank(ax)
        ids, dists = ops.masked_topk(
            engine.to_device(qvecs, dev) if isinstance(qvecs, np.ndarray)
            else qvecs.to(dev),
            engine.to_device(qbms, dev) if isinstance(qbms, np.ndarray)
            else qbms.to(dev),
            base, nrm, bms, pred=int(pred), k=k)
        gids = torch.where(ids < 0, ids, ids + offset * size)
        # gather [Q, k] -> [S, Q, k], the innermost axis first, so the
        # shard index is outer-axis-major
        all_ids, all_d = gids[None], dists[None]
        for d in reversed(dims):
            all_ids = _gather(all_ids, (mesh, d))
            all_d = _gather(all_d, (mesh, d))
        out, _ = ops.merge_topk(all_ids, all_d, k=k)
        return out

    return search


def _gather(t, group):
    # `all_gather_single` is newer than torch 2.11, whose name is
    # `all_gather_tensor`
    gather = getattr(funcol, "all_gather_single", funcol.all_gather_tensor)
    out = gather(t.contiguous(), 0, group)
    return out.wait() if isinstance(out, funcol.AsyncCollectiveTensor) \
        else out
