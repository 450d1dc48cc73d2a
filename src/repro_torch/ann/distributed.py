"""Row partition and placement of a sharded dataset.

`shard_bounds` cuts the rows into contiguous shards and `shard_devices`
places one shard per device; `repro_torch.ann.sharded.
ShardedFilteredIndex` is built on both. The JAX package's
`make_sharded_search`, a `shard_map` over a device mesh, has no
counterpart here yet.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.ann.index import resolve_device


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
