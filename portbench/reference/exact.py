"""Plain exact filtered search, the reference every answer is held to.

Rows are ranked by fp32 scores ‖v‖² − 2·q·v with TF32 off, the best
`k + REFINE` of those passing the predicate are kept, and their squared
distances are worked out again in float64 and sorted: the answer is the
k nearest passing rows in float64, up to fp32 ties deeper than
`REFINE` ranks. The control (`precision="tf32"`) is the same search
with every product's inputs rounded to TF32 and its own fp32 distances
returned, as a program that scored in TF32 would.

Predicates (paper §2.1), on int32 words holding uint32 label bitmaps:
EQUALITY L_i == L_q, AND L_q ⊆ L_i, OR L_q ∩ L_i ≠ ∅.
"""

from __future__ import annotations

import numpy as np
import torch

PRED_CODES = {"EQUALITY": 0, "AND": 1, "OR": 2}
REFINE = 16          # fp32 ranks kept past k before the float64 re-sort


def predicate_mask(bitmaps: torch.Tensor, qbms: torch.Tensor,
                   pred: str) -> torch.Tensor:
    """[Q, N] bool: row n passes query q. bitmaps [N, W], qbms [Q, W]
    int32."""
    q, n = qbms.shape[0], bitmaps.shape[0]
    ok = torch.full((q, n), pred != "OR", dtype=torch.bool,
                    device=bitmaps.device)
    for i in range(bitmaps.shape[1]):
        b, w = bitmaps[None, :, i], qbms[:, i, None]
        if pred == "EQUALITY":
            ok &= b == w
        elif pred == "AND":
            ok &= (b & w) == w
        elif pred == "OR":
            ok |= (b & w) != 0
        else:
            raise ValueError(f"unknown predicate {pred!r}")
    return ok


def pair_predicate(row_bm: torch.Tensor, qbms: torch.Tensor,
                   pred: str) -> torch.Tensor:
    """[Q, K] bool: row j of query q passes it. row_bm [Q, K, W] (each
    query's rows), qbms [Q, W]."""
    w = qbms[:, None, :]
    if pred == "EQUALITY":
        return (row_bm == w).all(-1)
    if pred == "AND":
        return ((row_bm & w) == w).all(-1)
    if pred == "OR":
        return ((row_bm & w) != 0).any(-1)
    raise ValueError(f"unknown predicate {pred!r}")


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 -> the nearest TF32 value (10 explicit mantissa bits, ties to
    even), still stored as fp32."""
    i = x.contiguous().view(torch.int32)
    i = (i + 0x0FFF + ((i >> 13) & 1)) & ~0x1FFF
    return i.view(torch.float32)


def query_block(n_rows: int) -> int:
    """Queries a block so that one [Q, N] fp32 score block is about
    1 GB."""
    return max(1, min(2048, (1 << 28) // max(n_rows, 1)))


def exact_topk(vectors: torch.Tensor, groups, qv: torch.Tensor,
               qb: torch.Tensor, pred: str, k: int, *,
               precision: str = "fp64"):
    """Exact filtered k-NN of queries qv [Q, D] / qb [Q, W] over
    vectors [N, D] whose label sets are `groups` (`reference.groups`),
    all on one device. The predicate is decided over the label sets and
    spread to the rows.

    Returns (ids [Q, k] int64 with −1 pads, squared distances [Q, k]
    float64 with NaN pads, passing-row counts [Q] int64). `precision`
    "fp64": the reference (fp32 ranking, float64 distances); "tf32": the
    control (TF32 products, fp32 distances)."""
    if precision not in ("fp64", "tf32"):
        raise ValueError(precision)
    tf32 = precision == "tf32"
    n = vectors.shape[0]
    norms = (vectors.double() ** 2).sum(1).float()
    vs = round_tf32(vectors) if tf32 else vectors
    q_all = qv.shape[0]
    ids_out = torch.full((q_all, k), -1, dtype=torch.int64)
    d_out = torch.full((q_all, k), float("nan"), dtype=torch.float64)
    counts = torch.zeros(q_all, dtype=torch.int64)
    qblock = query_block(n)
    keep = min(n, k + REFINE)
    allow = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for s in range(0, q_all, qblock):
            q = qv[s:s + qblock]
            mask = predicate_mask(groups.bitmaps, qb[s:s + qblock],
                                  pred)[:, groups.gid]
            counts[s:s + q.shape[0]] = mask.sum(1).cpu()
            qs = round_tf32(q) if tf32 else q
            score = norms[None, :] - 2.0 * (qs @ vs.T)
            score.masked_fill_(~mask, float("inf"))
            top = torch.topk(score, keep, dim=1, largest=False)
            cand, valid = top.indices, torch.isfinite(top.values)
            if tf32:
                d = (top.values + (q * q).sum(1, keepdim=True)).double()
            else:
                diff = vectors[cand].double() - q.double()[:, None, :]
                d = (diff * diff).sum(-1)
            d = torch.where(valid, d, torch.inf)
            d, o = torch.sort(d, dim=1, stable=True)
            cand = torch.gather(cand, 1, o)[:, :k]
            d = d[:, :k]
            fin = torch.isfinite(d)
            ids_out[s:s + q.shape[0]] = torch.where(fin, cand, -1).cpu()
            d_out[s:s + q.shape[0]] = torch.where(
                fin, d, torch.nan).cpu()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = allow
    return ids_out.numpy(), d_out.numpy(), counts.numpy()


def row_distances(vectors: torch.Tensor, qv: torch.Tensor,
                  ids: np.ndarray) -> np.ndarray:
    """[Q, k] float64 squared distances of rows `ids` (−1: NaN) from the
    queries qv [Q, D]."""
    idx = torch.from_numpy(np.where(ids >= 0, ids, 0)).to(vectors.device)
    diff = vectors[idx].double() - qv.double()[:, None, :]
    d = (diff * diff).sum(-1).cpu().numpy()
    return np.where(ids >= 0, d, np.nan)


def recall(got: np.ndarray, truth: np.ndarray) -> np.ndarray:
    """Per-query recall@k (paper Eq. 2): |R ∩ TopK| / min(k, |TopK|),
    1 where no row passes. Both [Q, k] with −1 pads."""
    out = np.ones(got.shape[0], dtype=np.float64)
    for qi in range(got.shape[0]):
        t = set(truth[qi][truth[qi] >= 0].tolist())
        if t:
            g = set(got[qi][got[qi] >= 0].tolist())
            out[qi] = len(g & t) / min(truth.shape[1], len(t))
    return out
