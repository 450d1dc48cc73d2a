"""LabelNav — the UNG analogue (filter-then-search).

UNG builds per-label-set sub-graphs linked by a label navigating graph.
Here the rows are stored **group-sorted** (one contiguous extent per
unique label set), and a search is

* Equality — a host hash lookup of the query's group, then one distance
  scan over that extent (recall = 1, exactly UNG's sweet spot);
* AND/OR — the predicate over the [G, W] *group* bitmaps picks the
  qualifying groups, a group-centroid distance ranks them ("navigation"),
  and the nearest `group_cap` groups are scanned up to `per_group_cap`
  members each. Recall degrades when many groups qualify (OR) — UNG's
  documented weakness.

The candidate gather and scoring are plain PyTorch, as in the JAX
package, where they are plain XLA.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.ann import engine, topk
from repro_torch.ann.dataset import ANNDataset
from repro_torch.ann.predicates import Predicate


def _search_eq(qvecs, qgroup, group_start, group_size, vectors, norms, *,
               maxg: int, k: int):
    """Exact-match: scan the query's own group extent."""
    g = qgroup.clamp(min=0).long()
    start = group_start[g]                                          # [Q]
    size = torch.where(qgroup < 0, 0, group_size[g])
    offs = torch.arange(maxg, dtype=torch.int32,
                        device=qvecs.device)[None, :]               # [1, maxg]
    valid = offs < size[:, None]
    cand = torch.where(valid, start[:, None] + offs, -1)            # [Q, maxg]
    safe = cand.clamp(min=0).long()
    d = topk.score_candidates(qvecs, vectors[safe], norms[safe])
    return topk.topk_ids(d, cand, k)


def _search_sub(qvecs, qbms, pred, group_bitmaps, group_start, group_size,
                gcent, gcnorms, vectors, norms, *, group_cap: int,
                per_group_cap: int, k: int):
    """AND/OR: navigate to the nearest qualifying groups, scan their
    extents."""
    nq = qvecs.shape[0]
    ok = engine.mask_shared(group_bitmaps, qbms, pred)              # [Q, G]
    gscore = topk.score_all(qvecs, gcent, gcnorms)                  # [Q, G]
    gscore = gscore.masked_fill(~ok, topk.INF)
    # `jax.lax.top_k(-gscore)`: the lowest group index among ties
    gd, gsel = topk.smallest(gscore, group_cap)                     # [Q, GC]
    gvalid = torch.isfinite(gd)
    start = group_start[gsel]                                       # [Q, GC]
    size = torch.where(gvalid, group_size[gsel], 0)
    offs = torch.arange(per_group_cap, dtype=torch.int32,
                        device=qvecs.device)[None, None, :]
    valid = offs < size[:, :, None]
    cand = torch.where(valid, start[:, :, None] + offs, -1).reshape(nq, -1)
    safe = cand.clamp(min=0).long()
    d = topk.score_candidates(qvecs, vectors[safe], norms[safe])
    return topk.topk_ids(d, cand, k)


class LabelNav(engine.Method):
    name = "labelnav"

    def param_settings(self):
        # UNG Table 3: L_search ∈ {100,300,500} -> (group_cap, per_group_cap)
        return [
            engine.ps("L100", {}, {"group_cap": 4, "per_group_cap": 128}),
            engine.ps("L300", {}, {"group_cap": 16, "per_group_cap": 256}),
            engine.ps("L500", {}, {"group_cap": 64, "per_group_cap": 512}),
        ]

    def build(self, ds: ANNDataset, build_params: dict):
        return {"maxg": int(ds.group_size.max())}

    def index_arrays(self, index) -> dict:
        return {"maxg": np.asarray(index["maxg"], dtype=np.int64)}

    def index_from_arrays(self, ds: ANNDataset, build_params: dict,
                          arrays: dict):
        return {"maxg": int(arrays["maxg"])}

    def search(self, fx, index, qvecs, qbms, pred: Predicate, k: int,
               search_params: dict):
        ds = fx.ds
        dev = fx.device
        tdev = fx.torch_device
        pred = Predicate(pred)
        nq = qvecs.shape[0]
        if pred == Predicate.EQUALITY:
            qgroup = np.asarray(
                [ds.group_id_of_bitmap(qbms[i]) for i in range(nq)],
                dtype=np.int32)
            maxg = max(8, index["maxg"])

            def fn_eq(qv, qg):
                return _search_eq(
                    engine.to_device(qv, tdev), engine.to_device(qg, tdev),
                    dev.group_start, dev.group_size, dev.vectors, dev.norms,
                    maxg=maxg, k=k)

            chunk = max(8, min(engine.DEFAULT_QCHUNK, (1 << 24) // maxg))
            return engine.run_chunked(fn_eq, nq, qvecs, qgroup, chunk=chunk)

        gc = min(int(search_params["group_cap"]), ds.n_groups)
        pgc = int(search_params["per_group_cap"])

        def fn(qv, qb):
            return _search_sub(
                engine.to_device(qv, tdev), engine.to_device(qb, tdev), pred,
                dev.group_bitmaps, dev.group_start, dev.group_size,
                dev.group_centroids, dev.group_cnorms, dev.vectors,
                dev.norms, group_cap=gc, per_group_cap=pgc, k=k)

        chunk = max(8, min(engine.DEFAULT_QCHUNK, (1 << 24) // (gc * pgc)))
        return engine.run_chunked(fn, nq, qvecs, qbms, chunk=chunk)
