"""The comparison that decides `correct`, and the numbers it compares.

Every number is a reading where higher is worse; a run is correct when
each is at or under its limit (`portbench/limits/<cell>.json`). The
program's answers come as row ids of its served (group-sorted) order;
the reference maps them to the rows it drew through the order it works
out again (`reference.groups`).

Numbers:

* `bad_ids` (exact, limit 0): returned ids out of range, failing their
  query's predicate or repeated in a query's answer; in an exact cell
  also each query whose count of ids is not min(k, passing rows).
* `dist_gap`: the widest gap between a returned distance and the
  float64 distance of its row, and in an exact cell also between the
  i-th returned distance and the reference's i-th, as a share of the
  rows' mean squared norm.
* `sel_mismatch` (exact, limit 0): selectivity counts that differ from
  the reference's.
* `rhat_gap`: the widest gap between a predicted recall and the
  reference's.
* `decision_mismatch` (exact, limit 0): routing decisions that differ
  from the reference's Algorithm 2, leaving out the queries whose
  reference prediction lies within `rhat_gap`'s limit of a tie (the
  threshold, or the best prediction where none passes).
* `recall_loss`: 1 − the mean recall@k of every served query against
  the reference's exact answer.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import exact as ref_exact
from portbench.reference import router as ref_router
from portbench.reference.groups import group_rows


class Reference:
    """The drawn rows on `device`, with what every comparison needs."""

    def __init__(self, vectors: np.ndarray, bitmaps: np.ndarray, device):
        self.device = torch.device(device)
        self.host_vectors = vectors
        self.vectors = torch.from_numpy(vectors).to(self.device)
        self.bitmaps = torch.from_numpy(bitmaps.view(np.int32)).to(
            self.device)
        self.groups = group_rows(self.bitmaps)
        self.n = vectors.shape[0]
        self.mean_sq_norm = float((self.vectors.double() ** 2).sum(1).mean())

    def to_drawn(self, ids: np.ndarray) -> np.ndarray:
        """Served row ids -> drawn row ids (−1 and out-of-range ids
        stay out of range)."""
        ids = np.asarray(ids, dtype=np.int64)
        ok = (ids >= 0) & (ids < self.n)
        return np.where(ok, self.groups.order[np.where(ok, ids, 0)],
                        np.where(ids < 0, -1, self.n))

    def on_device(self, qv: np.ndarray, qb: np.ndarray):
        return (torch.from_numpy(np.ascontiguousarray(qv)).to(self.device),
                torch.from_numpy(np.ascontiguousarray(qb).view(np.int32))
                .to(self.device))


def _bad_rows(ref: Reference, qb_t: torch.Tensor, pred: str,
              drawn: np.ndarray, dists: np.ndarray) -> np.ndarray:
    """[Q] count of ids a query got that are out of range, fail its
    predicate, repeat, or come without a finite distance."""
    q, k = drawn.shape
    valid = drawn >= 0
    out_of_range = valid & (drawn >= ref.n)
    rows = torch.from_numpy(np.where(valid & ~out_of_range, drawn, 0)).to(
        ref.device)
    bm = ref.bitmaps[rows.reshape(-1)].reshape(q, k, -1)
    passes = ref_exact.pair_predicate(bm, qb_t, pred).cpu().numpy()
    fails = valid & ~out_of_range & ~passes
    no_dist = valid & ~np.isfinite(np.asarray(dists, dtype=np.float64))
    srt = np.sort(np.where(valid, drawn, -1 - np.arange(k)[None, :]), 1)
    repeats = (srt[:, 1:] == srt[:, :-1]).sum(1)
    return out_of_range.sum(1) + fails.sum(1) + no_dist.sum(1) + repeats


def judge_exact(ref: Reference, batches: list, k: int
                ) -> tuple[dict, dict]:
    """batches: (pred, qv, qb, ids, dists) of the compared batches, the
    program's ids in served order. Returns (numbers, {"failed": queries
    with a wrong answer})."""
    bad, gap, failed = 0, 0.0, 0
    for pred, qv, qb, ids, dists in batches:
        qv_t, qb_t = ref.on_device(qv, qb)
        drawn = ref.to_drawn(ids)
        t_ids, t_d, counts = ref_exact.exact_topk(
            ref.vectors, ref.groups, qv_t, qb_t, pred, k)
        per_q = _bad_rows(ref, qb_t, pred, drawn, dists)
        per_q += ((drawn >= 0).sum(1) != np.minimum(k, counts))
        bad += int(per_q.sum())
        failed += int((per_q > 0).sum())
        own = ref_exact.row_distances(ref.vectors, qv_t,
                                      np.where(drawn < ref.n, drawn, -1))
        d = np.asarray(dists, dtype=np.float64)
        gaps = [np.abs(d - own), np.abs(np.sort(d, 1) - t_d)]
        gap = max(gap, max(float(np.nanmax(g, initial=0.0)) for g in gaps))
    return ({"bad_ids": bad, "dist_gap": gap / ref.mean_sq_norm},
            {"failed": failed})


def judge_routed(ref: Reference, router: ref_router.Router, ds_name: str,
                 t: float, batches: list, sel_calls: list, k: int,
                 rhat_tol: float) -> tuple[dict, dict]:
    """batches: (pred, qv, qb, ids, dists, decisions, r_hat) of every
    served batch; sel_calls: (batch index, predicate, counts) of every
    selectivity count the program made. Returns (numbers, {"recall":
    mean recall@k, "failed": queries with a wrong id, "decisions": the
    program's decisions counted by (method, setting)})."""
    calls_of: dict = {}
    for bi, pred, counts in sel_calls:
        calls_of.setdefault(bi, []).append((pred, counts))
    lid = ref_router.lid_mean(ref.host_vectors[ref.groups.order])
    sel_mis, bad, gap, rgap, dec_mis, recalls = 0, 0, 0.0, 0.0, 0, []
    failed = 0
    for bi, (pred, qv, qb, ids, dists, decisions, r_hat) in enumerate(
            batches):
        qv_t, qb_t = ref.on_device(qv, qb)
        t_ids, _, counts = ref_exact.exact_topk(
            ref.vectors, ref.groups, qv_t, qb_t, pred, k)
        for call_pred, got in calls_of.get(bi, ()):
            want = counts if call_pred == pred else \
                ref_router.selectivity_counts(ref.groups, qb_t, call_pred)
            sel_mis += int((np.asarray(got, dtype=np.int64) != want).sum())
        x = router.feature_matrix(counts / ref.n, lid, pred)
        r_ref = router.predict(x)
        rgap = max(rgap, float(np.abs(np.asarray(r_hat) - r_ref).max()))
        want = router.decide(r_ref, ds_name, pred, t)
        near_t = (np.abs(r_ref - t) <= rhat_tol).any(1)
        top2 = np.sort(r_ref, 1)[:, -2:]
        near_top = (top2[:, 1] - top2[:, 0]) <= rhat_tol
        passing = (r_ref >= t).any(1)
        ambiguous = near_t | (~passing & near_top)
        dec_mis += sum(1 for qi, (got, w) in enumerate(zip(decisions, want))
                       if tuple(got) != tuple(w) and not ambiguous[qi])
        drawn = ref.to_drawn(ids)
        per_q = _bad_rows(ref, qb_t, pred, drawn, dists)
        bad += int(per_q.sum())
        failed += int((per_q > 0).sum())
        own = ref_exact.row_distances(ref.vectors, qv_t,
                                      np.where(drawn < ref.n, drawn, -1))
        gap = max(gap, float(np.nanmax(
            np.abs(np.asarray(dists, dtype=np.float64) - own),
            initial=0.0)))
        recalls.append(ref_exact.recall(drawn, t_ids))
    mean_recall = float(np.concatenate(recalls).mean())
    chosen: dict = {}
    for b in batches:
        for m, ps in b[5]:
            chosen[f"{m}/{ps}"] = chosen.get(f"{m}/{ps}", 0) + 1
    return ({"sel_mismatch": sel_mis, "rhat_gap": rgap,
             "decision_mismatch": dec_mis, "bad_ids": bad,
             "dist_gap": gap / ref.mean_sq_norm,
             "recall_loss": 1.0 - mean_recall},
            {"recall": mean_recall, "failed": failed, "decisions": chosen})


def verdict(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}) in `limits`' order; a
    number without a limit, or a limit without a number, is not
    correct."""
    checks = {name: {"value": numbers.get(name), "limit": lim}
              for name, lim in limits.items()}
    ok = set(numbers) == set(limits) and all(
        c["value"] is not None and np.isfinite(c["value"])
        and c["value"] <= c["limit"] for c in checks.values())
    return ok, checks
