"""IVFGamma — the ACORN-γ analogue (hybrid search, predicate-agnostic).

ACORN-γ widens HNSW neighbourhoods γ-fold so that predicate-passing
reachability survives filtering. The counterpart here: probe 4γ IVF
lists and apply the predicate mask in-scan, so every candidate that
reaches top-k already satisfies the filter.
"""

from __future__ import annotations

from repro_torch.ann import engine, topk
from repro_torch.ann.ivf import IVFIndex, IVFMethod, probe_candidates
from repro_torch.ann.predicates import Predicate


def _search(qvecs, qbms, pred, centroids, cnorms, lists, vectors, norms,
            bitmaps, *, nprobe: int, k: int):
    cand = probe_candidates(qvecs, centroids, cnorms, lists, nprobe)  # [Q, C]
    safe = cand.clamp(min=0).long()
    d = topk.score_candidates(qvecs, vectors[safe], norms[safe])
    ok = engine.mask_cand(bitmaps[safe], qbms, pred) & (cand >= 0)
    return topk.topk_ids(d, cand, k, valid=ok)


class IVFGamma(IVFMethod):
    name = "ivf_gamma"

    def param_settings(self):
        # ACORN-γ Table 3: γ ∈ {1,4,8,...} — base nprobe 4, probe 4γ lists.
        return [
            engine.ps("g1", {"nlist": 128}, {"gamma": 1}),
            engine.ps("g4", {"nlist": 128}, {"gamma": 4}),
            engine.ps("g8", {"nlist": 128}, {"gamma": 8}),
        ]

    def search(self, fx, index: IVFIndex, qvecs, qbms, pred: Predicate,
               k: int, search_params: dict):
        dev = fx.device
        nprobe = min(4 * int(search_params["gamma"]), index.centroids.shape[0])
        cent = fx.as_device(index.centroids)
        cn = fx.as_device(index.centroid_norms)
        lists = fx.as_device(index.lists)

        def fn(qv, qb):
            return _search(
                engine.to_device(qv, fx.torch_device),
                engine.to_device(qb, fx.torch_device), pred, cent, cn,
                lists, dev.vectors, dev.norms, dev.bitmaps, nprobe=nprobe,
                k=k)

        # the JAX package's chunk rule: at most 2^23 gathered candidates
        chunk = max(8, min(engine.DEFAULT_QCHUNK,
                           (1 << 23) // max(1, nprobe * index.lists.shape[1])))
        return engine.run_chunked(fn, qvecs.shape[0], qvecs, qbms, chunk=chunk)
