"""Post-filter: search-then-filter on an IVF index.

Retrieve the top-k′ (k′ ≫ k) unfiltered candidates from `nprobe` IVF
lists, then verify the predicate on those k′ and keep the best k valid
ones. Cheap, but recall collapses when selectivity ≪ k/k′ (the k′ cap).
`kprime`≈ef is the quality knob the router tunes.
"""

from __future__ import annotations

import torch

from repro_torch.ann import engine, topk
from repro_torch.ann.ivf import IVFIndex, IVFMethod, probe_candidates
from repro_torch.ann.predicates import Predicate


def _search(qvecs, qbms, pred, centroids, cnorms, lists, vectors, norms,
            bitmaps, *, nprobe: int, kprime: int, k: int):
    cand = probe_candidates(qvecs, centroids, cnorms, lists, nprobe)  # [Q, C]
    safe = cand.clamp(min=0).long()
    d = topk.score_candidates(qvecs, vectors[safe], norms[safe])
    d = d.masked_fill(cand < 0, topk.INF)
    # stage 1: unfiltered top-k' (ivf lists are disjoint, no dups)
    kp = min(kprime, d.shape[1])
    dk, idx = topk.smallest(d, kp)                                  # [Q, k']
    cid = torch.gather(cand, 1, idx)
    cid = torch.where(torch.isinf(dk), -1, cid)
    # stage 2: verify predicate on the k' survivors only
    cbm = bitmaps[cid.clamp(min=0).long()]                          # [Q, k', W]
    ok = engine.mask_cand(cbm, qbms, pred) & (cid >= 0)
    return topk.topk_ids(dk, cid, k, valid=ok)


class PostFilter(IVFMethod):
    name = "postfilter"

    def param_settings(self):
        # paper Table 3: M/efc (build), ef (search). Our knobs: nlist
        # (build), nprobe + kprime≈ef (search).
        return [
            engine.ps("ef200", {"nlist": 128}, {"nprobe": 8, "kprime": 200}),
            engine.ps("ef800", {"nlist": 128}, {"nprobe": 16, "kprime": 800}),
            engine.ps("ef2000", {"nlist": 128}, {"nprobe": 32, "kprime": 2000}),
        ]

    def search(self, fx, index: IVFIndex, qvecs, qbms, pred: Predicate,
               k: int, search_params: dict):
        dev = fx.device
        nprobe = min(int(search_params["nprobe"]), index.centroids.shape[0])
        kprime = int(search_params["kprime"])
        cent = fx.as_device(index.centroids)
        cn = fx.as_device(index.centroid_norms)
        lists = fx.as_device(index.lists)

        def fn(qv, qb):
            return _search(
                engine.to_device(qv, fx.torch_device),
                engine.to_device(qb, fx.torch_device), pred, cent, cn,
                lists, dev.vectors, dev.norms, dev.bitmaps, nprobe=nprobe,
                kprime=kprime, k=k)

        # the JAX package's chunk rule: at most 2^24 gathered candidates
        chunk = max(8, min(engine.DEFAULT_QCHUNK,
                           (1 << 24) // max(1, nprobe * index.lists.shape[1])))
        return engine.run_chunked(fn, qvecs.shape[0], qvecs, qbms, chunk=chunk)
