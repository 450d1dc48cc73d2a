"""Sieve — the SIEVE analogue (workload-specialised collection of indexes).

SIEVE pre-builds sub-indexes for the filter patterns a historical workload
hits most. Here the collection is a set of **materialised posting lists**
for the `n_lists` most frequent labels (dense padded rows):

* OR      — if every query label is materialised, the candidate set is the
            concatenation of its posting rows (recall 1 unless a row was
            truncated by `list_cap`);
* AND/EQ  — scan the *shortest* materialised posting row among the query's
            labels, verifying the full predicate per candidate (classic
            inverted-index intersection);
* miss    — fall back to Post-filter on a shared global IVF.

`index_budget`/`hist_pct` (paper Table 3) map to the materialised-label
fraction and `list_cap`; `ef_search` maps to the fallback k′. The build
is numpy on the host, a copy of the JAX package's, so one dataset gives
identical index arrays in both packages.
"""

from __future__ import annotations

import numpy as np

from repro_torch.ann import engine, topk
from repro_torch.ann.dataset import ANNDataset
from repro_torch.ann.ivf import IVFIndex, build_ivf
from repro_torch.ann.labels import unpack_one
from repro_torch.ann.methods.postfilter import _search as _post_search
from repro_torch.ann.predicates import Predicate


def _scan_rows(qvecs, qbms, pred, rows, vectors, norms, bitmaps, *, k: int,
               verify: bool):
    """rows: [Q, C] candidate ids (−1 pad); optionally verify predicate."""
    safe = rows.clamp(min=0).long()
    d = topk.score_candidates(qvecs, vectors[safe], norms[safe])
    valid = rows >= 0
    if verify:
        valid &= engine.mask_cand(bitmaps[safe], qbms, pred)
    return topk.topk_ids(d, rows, k, valid=valid, dedup=True)


class Sieve(engine.Method):
    name = "sieve"

    def param_settings(self):
        return [
            engine.ps("b1", {"hist_pct": 0.25, "list_cap": 1024},
                      {"ef_search": 50}),
            engine.ps("b2", {"hist_pct": 0.5, "list_cap": 4096},
                      {"ef_search": 200}),
            engine.ps("b3", {"hist_pct": 1.0, "list_cap": 16384},
                      {"ef_search": 800}),
        ]

    def build(self, ds: ANNDataset, build_params: dict):
        hist_pct = float(build_params.get("hist_pct", 0.5))
        list_cap = int(build_params.get("list_cap", 4096))
        # label frequency from group table (the "historical workload" proxy:
        # query labels follow base-label popularity)
        freq = np.zeros(ds.universe, dtype=np.int64)
        members: dict[int, list[int]] = {}
        for g in range(ds.n_groups):
            s, l = int(ds.group_start[g]), int(ds.group_size[g])
            for lab in unpack_one(ds.group_bitmaps[g]):
                freq[lab] += l
                members.setdefault(lab, []).extend(range(s, s + l))
        n_mat = max(1, int(np.ceil(hist_pct * ds.universe)))
        mat_labels = np.argsort(-freq, kind="stable")[:n_mat]
        mat_labels = [int(l) for l in mat_labels if freq[l] > 0]
        cap = min(list_cap, max((len(members[l]) for l in mat_labels),
                                default=1))
        rows = np.full((max(len(mat_labels), 1), cap), -1, dtype=np.int32)
        row_of = {}
        for r, l in enumerate(mat_labels):
            ids = members[l][:cap]
            rows[r, :len(ids)] = ids
            row_of[l] = r
        ivf = build_ivf(ds.vectors, 128, seed=29)
        return {"rows": rows, "row_of": row_of, "row_len":
                np.array([len(members[l]) for l in mat_labels] or [0]),
                "ivf": ivf, "cap": cap}

    def index_arrays(self, index) -> dict:
        labels = np.array(sorted(index["row_of"]), dtype=np.int64)
        ivf = index["ivf"]
        return {"rows": index["rows"], "row_len": index["row_len"],
                "cap": np.asarray(index["cap"], dtype=np.int64),
                "row_of_labels": labels,
                "row_of_rows": np.array(
                    [index["row_of"][int(l)] for l in labels],
                    dtype=np.int64),
                "ivf_centroids": ivf.centroids,
                "ivf_centroid_norms": ivf.centroid_norms,
                "ivf_lists": ivf.lists, "ivf_list_len": ivf.list_len}

    def index_from_arrays(self, ds, build_params: dict, arrays: dict):
        row_of = {int(l): int(r) for l, r in zip(arrays["row_of_labels"],
                                                 arrays["row_of_rows"])}
        ivf = IVFIndex(centroids=arrays["ivf_centroids"],
                       centroid_norms=arrays["ivf_centroid_norms"],
                       lists=arrays["ivf_lists"],
                       list_len=arrays["ivf_list_len"])
        return {"rows": arrays["rows"], "row_of": row_of,
                "row_len": arrays["row_len"], "ivf": ivf,
                "cap": int(arrays["cap"])}

    def search(self, fx, index, qvecs, qbms, pred: Predicate, k: int,
               search_params: dict):
        dev = fx.device
        tdev = fx.torch_device
        pred = Predicate(pred)
        nq = qvecs.shape[0]
        row_of = index["row_of"]
        rows_np = index["rows"]

        # ---- host-side pattern resolution (the paper's sub-index pick) ----
        max_or = 8
        hit = np.zeros(nq, dtype=bool)
        sel_rows = np.full((nq, max_or), -1, dtype=np.int32)
        for qi in range(nq):
            labs = sorted(unpack_one(qbms[qi]))
            mat = [row_of[l] for l in labs if l in row_of]
            if pred == Predicate.OR:
                if len(mat) == len(labs) and 0 < len(labs) <= max_or:
                    hit[qi] = True
                    sel_rows[qi, :len(mat)] = mat
            else:  # AND / EQUALITY: shortest materialised posting row
                if mat:
                    lens = [index["row_len"][r] for r in mat]
                    hit[qi] = True
                    sel_rows[qi, 0] = mat[int(np.argmin(lens))]

        out = np.full((nq, k), -1, dtype=np.int32)
        out_d = np.full((nq, k), np.inf, dtype=np.float32)
        hit_idx = np.nonzero(hit)[0]
        miss_idx = np.nonzero(~hit)[0]

        if hit_idx.size:
            if pred == Predicate.OR:
                cand = rows_np[np.maximum(sel_rows[hit_idx], 0)]  # [H, max_or, cap]
                cand = np.where(sel_rows[hit_idx][:, :, None] >= 0, cand, -1)
                cand = cand.reshape(hit_idx.size, -1)
                verify = False    # union of exact posting rows: all valid
            else:
                cand = rows_np[sel_rows[hit_idx, 0]]              # [H, cap]
                verify = True

            def fn(qv, qb, cd):
                return _scan_rows(
                    engine.to_device(qv, tdev), engine.to_device(qb, tdev),
                    pred, engine.to_device(cd, tdev), dev.vectors, dev.norms,
                    dev.bitmaps, k=k, verify=verify)

            chunk = max(8, min(engine.DEFAULT_QCHUNK,
                               (1 << 24) // max(1, cand.shape[1])))
            out[hit_idx], out_d[hit_idx] = engine.run_chunked(
                fn, hit_idx.size, qvecs[hit_idx], qbms[hit_idx], cand,
                chunk=chunk)

        if miss_idx.size:
            ivf = index["ivf"]
            kprime = int(search_params.get("ef_search", 200))
            nprobe = min(8, ivf.centroids.shape[0])
            cent = fx.as_device(ivf.centroids)
            cn = fx.as_device(ivf.centroid_norms)
            lists = fx.as_device(ivf.lists)

            def fn_miss(qv, qb):
                return _post_search(
                    engine.to_device(qv, tdev), engine.to_device(qb, tdev),
                    pred, cent, cn, lists, dev.vectors, dev.norms,
                    dev.bitmaps, nprobe=nprobe, kprime=kprime, k=k)

            out[miss_idx], out_d[miss_idx] = engine.run_chunked(
                fn_miss, miss_idx.size, qvecs[miss_idx], qbms[miss_idx])
        return out, out_d
