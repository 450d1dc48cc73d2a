"""FVamana — the FilteredVamana analogue (hybrid graph search).

Offline: α-pruned Vamana-style graph + per-label entry points (the
label-aware part of FilteredVamana's build), built by numpy on a CPU
handle and on the card on a CUDA handle (`graph.build_graph_torch`).
Online: fixed-iteration batched best-first search seeded at the medoid
plus the query labels' entry points; traversal routes through
predicate-failing nodes (they keep the graph navigable) but only
predicate-passing pool entries are eligible for the final top-k —
label-aware pruning at result granularity. `L_search` is the paper's
quality knob.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.ann import engine, graph, topk
from repro_torch.ann.dataset import ANNDataset
from repro_torch.ann.labels import unpack_one
from repro_torch.ann.predicates import Predicate


class FVamana(engine.Method):
    name = "fvamana"
    builds_on_device = True

    MAX_SEEDS = 5

    def param_settings(self):
        # FilteredVamana Table 3: R ∈ {32,64}, L_search ∈ {16..128}
        return [
            engine.ps("L16", {"r": 32}, {"l_search": 16}),
            engine.ps("L32", {"r": 32}, {"l_search": 32}),
            engine.ps("L64", {"r": 32}, {"l_search": 64}),
            engine.ps("L128", {"r": 32}, {"l_search": 128}),
        ]

    def build(self, ds: ANNDataset, build_params: dict,
              device="cuda") -> graph.VamanaGraph:
        r = int(build_params.get("r", 32))
        if torch.device(device).type == "cpu":
            return graph.build_graph(ds.vectors, ds.bitmaps, ds.universe,
                                     r=r, seed=17)
        return graph.build_graph_torch(ds.vectors, ds.bitmaps, ds.universe,
                                       device=device, r=r, seed=17)

    def index_arrays(self, index: graph.VamanaGraph) -> dict:
        return {"neighbors": index.neighbors,
                "medoid": np.asarray(index.medoid, dtype=np.int64),
                "label_entry": index.label_entry}

    def index_from_arrays(self, ds: ANNDataset, build_params: dict,
                          arrays: dict) -> graph.VamanaGraph:
        return graph.VamanaGraph(neighbors=arrays["neighbors"],
                                 medoid=int(arrays["medoid"]),
                                 label_entry=arrays["label_entry"])

    def graft_index(self, new_ds: ANNDataset, old_index: graph.VamanaGraph,
                    old_ds: ANNDataset, old_to_new, new_rows, build_params,
                    device="cuda"):
        n_surv = int((old_to_new >= 0).sum())
        # grafting pays off only while the surviving graph dominates; a
        # mostly-new dataset searches better on a fresh build
        if n_surv == 0 or new_ds.n == 0 or len(new_rows) > n_surv:
            return None
        return graph.graft_graph(old_index, new_ds.vectors, new_ds.bitmaps,
                                 new_ds.universe, old_to_new, new_rows,
                                 r=int(build_params.get("r", 32)), seed=17,
                                 device=device)

    def search(self, fx, index: graph.VamanaGraph, qvecs, qbms,
               pred: Predicate, k: int, search_params: dict):
        dev = fx.device
        tdev = fx.torch_device
        pred = Predicate(pred)
        l_search = int(search_params["l_search"])
        nq = qvecs.shape[0]

        # host-side seed assembly: medoid + query-label entry points
        seeds = np.full((nq, self.MAX_SEEDS), -1, dtype=np.int32)
        seeds[:, 0] = index.medoid
        for qi in range(nq):
            labs = sorted(unpack_one(qbms[qi]))[: self.MAX_SEEDS - 1]
            for j, l in enumerate(labs):
                seeds[qi, 1 + j] = index.label_entry[l]

        nbrs = fx.as_device(index.neighbors)

        def fn(qv, qb, sd):
            qv, qb = engine.to_device(qv, tdev), engine.to_device(qb, tdev)
            pool_ids, pool_d = graph.beam_search(
                qv, engine.to_device(sd, tdev), nbrs, dev.vectors,
                dev.norms, l_search=l_search, iters=l_search)
            cbm = dev.bitmaps[pool_ids.clamp(min=0).long()]
            ok = engine.mask_cand(cbm, qb, pred) & (pool_ids >= 0)
            return topk.topk_ids(pool_d, pool_ids, k, valid=ok)

        return engine.run_chunked(fn, nq, qvecs, qbms, seeds)
