"""Vamana-style proximity graph: the offline build, on the host or on a
torch device, and the fixed-iteration batched beam search.

CPU Vamana is sequential pointer chasing with data-dependent
termination. Here the search is a **fixed-iteration, fixed-pool
best-first search**: a loop over L steps, each step expanding the best
unexpanded pool entry through a row gather of its neighbour list and one
distance block, then a sort-merge (dedup by sort adjacency) back into
the pool. All shapes are fixed; convergence turns further iterations
into masked no-ops.

The build replaces Vamana's greedy RobustPrune (a per-point sequential
loop) with a **one-shot vectorised occlusion prune** over candidate pools
drawn from IVF locality (`occlusion_prune`).

Two builds give the same graph on exact inputs:

* `build_graph` — numpy on the host, a copy of the JAX package's; a CPU
  handle uses it.
* `build_graph_torch` — the same steps with the pool scoring, the
  nearest-candidate selection, the prune and the edges on a torch
  device. At 1M rows the host build cannot finish: each block of 256
  rows gathers three padded IVF lists of up to 3,000 rows × d. On the
  device the rows of one IVF list share their pool, so one matrix
  product scores them all. The k-means, the row assignment, the medoid
  and the label entry points stay the numpy build's own host code (so
  their argmins round as the reference's do), and every random number
  comes from the same numpy `Generator` in the same call order.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.ann import ivf as ivf_mod
from repro_torch.ann import topk

INF = float("inf")
ROW_CHUNK = 2048     # rows scored at once by the device build


@dataclasses.dataclass
class VamanaGraph:
    neighbors: np.ndarray     # [N, R] int32 (−1 pad)
    medoid: int
    label_entry: np.ndarray   # [U] int32 entry point per label (−1 if unused)


def occlusion_prune(cid: np.ndarray, cdist: np.ndarray, vectors: np.ndarray,
                    norms: np.ndarray, alpha: float, keep_n: int) -> np.ndarray:
    """Vectorised α-occlusion prune over candidate pools.

    `cid`/`cdist` are [B, C] pools in *ascending-distance order* (−1/inf
    pad); returns [B, keep_n] selected edge targets (−1 pad). A candidate
    j is dropped iff some candidate u at a later pool position (the
    JAX package's `np.tril(..., k=-1)` over [u, j]) occludes it:
    α·d(u,j) < d(q,j). Shared by the offline build and `graft_graph`.
    """
    b, c = cid.shape
    cv = vectors[np.maximum(cid, 0)]                              # [B, C, d]
    cn = norms[np.maximum(cid, 0)]
    # pairwise distances among candidates
    gram = np.einsum("bud,bjd->buj", cv, cv, optimize=True)
    d2 = cn[:, :, None] + cn[:, None, :] - 2.0 * gram             # [B, C, C]
    tri = np.tril(np.ones((c, c), dtype=bool), k=-1)[None]
    occl = tri & (alpha * d2 < cdist[:, None, :]) \
        & (cid[:, :, None] >= 0) & (cid[:, None, :] >= 0)
    dominated = occl.any(axis=1)                                  # [B, C]
    keep = (~dominated) & (cid >= 0) & np.isfinite(cdist)
    # first keep_n kept per row, in ascending-distance order
    rank = np.where(keep, np.arange(c)[None, :], c + 1)
    order = np.argsort(rank, axis=1, kind="stable")[:, :keep_n]
    sel = np.take_along_axis(cid, order, axis=1)
    selkeep = np.take_along_axis(keep, order, axis=1)
    return np.where(selkeep, sel, -1)


def occlusion_prune_torch(cid: torch.Tensor, cdist: torch.Tensor,
                          vectors: torch.Tensor, norms: torch.Tensor,
                          alpha: float, keep_n: int) -> torch.Tensor:
    """`occlusion_prune` on tensors of one device, in the same float32
    operations and order."""
    c = cid.shape[1]
    safe = cid.clamp(min=0).long()
    cv = vectors[safe]                                            # [B, C, d]
    cn = norms[safe]
    gram = torch.bmm(cv, cv.transpose(1, 2))
    d2 = cn[:, :, None] + cn[:, None, :] - 2.0 * gram             # [B, C, C]
    tri = torch.ones((c, c), dtype=torch.bool,
                     device=cid.device).tril(-1)[None]
    real = cid >= 0
    occl = tri & (alpha * d2 < cdist[:, None, :]) \
        & real[:, :, None] & real[:, None, :]
    dominated = occl.any(dim=1)                                   # [B, C]
    keep = ~dominated & real & torch.isfinite(cdist)
    pos = torch.arange(c, device=cid.device)[None, :]
    rank = torch.where(keep, pos, c + 1)
    order = torch.sort(rank, dim=1, stable=True).indices[:, :keep_n]
    sel = torch.gather(cid, 1, order)
    return torch.where(torch.gather(keep, 1, order), sel, -1)


def _locality(vectors: np.ndarray, seed: int):
    """The build's IVF on the host: the padded lists (capped at three
    times the mean list), each row's list, and each list's three nearest
    lists. The same arrays as the JAX package's `build_ivf` followed by
    `assign_to_centroids`, with the assignment made once."""
    n = vectors.shape[0]
    nlist = max(4, int(np.sqrt(n)))
    avg_list = max(8, n // nlist)
    cent = ivf_mod.kmeans(vectors, nlist, seed=seed)
    nlist = cent.shape[0]
    assign = ivf_mod.assign_to_centroids(vectors, cent)
    lists, _ = ivf_mod.pack_lists(assign, nlist, 3 * avg_list)
    cnorms = (cent ** 2).sum(1).astype(np.float32)
    cd = cnorms[None, :] - 2.0 * cent @ cent.T
    near_clusters = np.argsort(cd, axis=1)[:, :3]                 # [nlist, 3]
    return lists, assign, near_clusters


def _label_entry(vectors, norms, bitmaps, labels, out) -> None:
    """Per-label entry points into `out`: the member vector nearest the
    label-subset mean."""
    for l in labels:
        word, bit = l >> 5, np.uint32(1) << np.uint32(l & 31)
        idx = np.nonzero((bitmaps[:, word] & bit) != 0)[0]
        if idx.size:
            sub_mean = vectors[idx].mean(0)
            out[l] = int(idx[np.argmin(
                norms[idx] - 2.0 * vectors[idx] @ sub_mean)])


def _medoid(vectors, norms) -> int:
    return int(np.argmin(norms - 2.0 * vectors @ vectors.mean(0)))


def build_graph(vectors: np.ndarray, bitmaps: np.ndarray, universe: int,
                r: int = 32, alpha: float = 1.2, seed: int = 0,
                n_cand: int = 64, block: int = 256,
                n_random_edges: int = 2) -> VamanaGraph:
    """The host build, block by block of `block` rows."""
    n, d = vectors.shape
    rng = np.random.default_rng(seed)
    norms = (vectors ** 2).sum(1).astype(np.float32)
    lists, assign, near_clusters = _locality(vectors, seed)

    c = min(n_cand, n - 1)
    neighbors = np.full((n, r), -1, dtype=np.int32)
    for s in range(0, n, block):
        e = min(s + block, n)
        b = e - s
        pool = lists[near_clusters[assign[s:e]]].reshape(b, -1)       # [B, P]
        rand = rng.integers(0, n, size=(b, 8)).astype(np.int32)
        pool = np.concatenate([pool, rand], axis=1)
        self_col = np.arange(s, e)[:, None]
        pool = np.where(pool == self_col, -1, pool)

        pv = vectors[np.maximum(pool, 0)]                             # [B, P, d]
        dq = norms[np.maximum(pool, 0)] - 2.0 * np.einsum(
            "bd,bpd->bp", vectors[s:e], pv, optimize=True)
        dq = np.where(pool < 0, np.inf, dq)

        top = np.argsort(dq, axis=1, kind="stable")[:, :c]            # [B, C]
        cid = np.take_along_axis(pool, top, axis=1)                   # [B, C]
        cdist = np.take_along_axis(dq, top, axis=1)                   # [B, C]
        sel = occlusion_prune(cid, cdist, vectors, norms, alpha,
                              max(r - n_random_edges, 1))
        neighbors[s:e, :sel.shape[1]] = sel
        # random long-range edges for connectivity
        if n_random_edges > 0:
            neighbors[s:e, -n_random_edges:] = rng.integers(
                0, n, size=(b, n_random_edges))

    label_entry = np.full(universe, -1, dtype=np.int32)
    _label_entry(vectors, norms, bitmaps, range(universe), label_entry)
    return VamanaGraph(neighbors=neighbors, medoid=_medoid(vectors, norms),
                       label_entry=label_entry)


def build_graph_torch(vectors: np.ndarray, bitmaps: np.ndarray,
                      universe: int, *, device, r: int = 32,
                      alpha: float = 1.2, seed: int = 0, n_cand: int = 64,
                      block: int = 256,
                      n_random_edges: int = 2) -> VamanaGraph:
    """`build_graph` with the per-row work on `device`.

    Row i's pool is the three lists nearest its own list, then 8 random
    rows, with i itself dropped; its `n_cand` nearest pool entries (ties
    to the earlier pool position, as the host build's stable sort) go
    through `occlusion_prune_torch`. The random pool rows and edges are
    the host build's draws, made first in its order (per block of
    `block` rows: the pool rows, then the edges)."""
    device = torch.device(device)
    n = vectors.shape[0]
    rng = np.random.default_rng(seed)
    norms = (vectors ** 2).sum(1).astype(np.float32)
    lists, assign, near_clusters = _locality(vectors, seed)
    rand = np.empty((n, 8), dtype=np.int32)
    edges = np.empty((n, n_random_edges), dtype=np.int32)
    for s in range(0, n, block):
        e = min(s + block, n)
        rand[s:e] = rng.integers(0, n, size=(e - s, 8))
        if n_random_edges > 0:
            edges[s:e] = rng.integers(0, n, size=(e - s, n_random_edges))

    vec = torch.from_numpy(vectors).to(device)
    nrm = torch.from_numpy(norms).to(device)
    lists_t = torch.from_numpy(lists).to(device)
    rand_t = torch.from_numpy(rand).to(device)
    keep_n = max(r - n_random_edges, 1)
    neighbors = torch.full((n, r), -1, dtype=torch.int32, device=device)
    # the rows of one list share the pool's list part: score them together
    order = np.argsort(assign, kind="stable")
    bounds = np.searchsorted(assign[order], np.arange(lists.shape[0] + 1))
    order_t = torch.from_numpy(order).to(device)
    for j in range(lists.shape[0]):
        shared = lists_t[torch.from_numpy(near_clusters[j]).to(device)
                         ].reshape(-1)                                 # [P]
        ssafe = shared.clamp(min=0).long()
        svec, snrm = vec[ssafe], nrm[ssafe]
        for s in range(int(bounds[j]), int(bounds[j + 1]), ROW_CHUNK):
            rows = order_t[s:min(s + ROW_CHUNK, int(bounds[j + 1]))]
            rv = vec[rows]                                             # [B, d]
            rnd = rand_t[rows]                                         # [B, 8]
            pool = torch.cat([shared[None, :].expand(rows.shape[0], -1),
                              rnd], dim=1)                             # [B, P+8]
            pool = torch.where(pool == rows[:, None], -1, pool)
            rsafe = rnd.long()
            dq = torch.cat([
                snrm[None, :] - 2.0 * (rv @ svec.T),
                nrm[rsafe] - 2.0 * torch.einsum("bd,bpd->bp", rv,
                                                vec[rsafe])], dim=1)
            dq = dq.masked_fill(pool < 0, INF)
            top = _stable_smallest(dq, min(n_cand, n - 1, dq.shape[1]))
            sel = occlusion_prune_torch(
                torch.gather(pool, 1, top), torch.gather(dq, 1, top), vec,
                nrm, alpha, keep_n)
            neighbors[rows, :sel.shape[1]] = sel
    if n_random_edges > 0:
        neighbors[:, -n_random_edges:] = torch.from_numpy(edges).to(device)

    label_entry = np.full(universe, -1, dtype=np.int32)
    _label_entry(vectors, norms, bitmaps, range(universe), label_entry)
    return VamanaGraph(neighbors=neighbors.cpu().numpy(),
                       medoid=_medoid(vectors, norms),
                       label_entry=label_entry)


def beam_search(qvecs: torch.Tensor, seeds: torch.Tensor,
                neighbors: torch.Tensor, vectors: torch.Tensor,
                norms: torch.Tensor, *, l_search: int, iters: int):
    """Batched best-first graph search.

    qvecs [Q, d]; seeds [Q, S] int32 (−1 pad). Returns pool ids/dists
    [Q, L] sorted ascending by distance (−1/inf padding) — the caller
    applies predicate eligibility and takes the final top-k. Both sorts
    are stable, so equal distances keep their pool order, and the first
    of two equal ids is the pool entry with its expanded flag.
    """
    q = qvecs.shape[0]
    s = seeds.shape[1]
    L = l_search
    dev = qvecs.device

    ssafe = seeds.clamp(min=0).long()
    seed_d = norms[ssafe] - 2.0 * torch.einsum("qd,qsd->qs", qvecs,
                                               vectors[ssafe])
    seed_d = seed_d.masked_fill(seeds < 0, INF)

    m = min(s, L)
    pool_ids = torch.full((q, L), -1, dtype=torch.int32, device=dev)
    pool_d = torch.full((q, L), INF, dtype=torch.float32, device=dev)
    pool_ids[:, :m] = seeds[:, :m]
    pool_d[:, :m] = seed_d[:, :m]
    expanded = torch.zeros((q, L), dtype=torch.bool, device=dev)
    rows = torch.arange(q, device=dev)

    def take(order, *xs):
        return [torch.gather(x, 1, order) for x in xs]

    for _ in range(iters):
        sel_d = pool_d.masked_fill(expanded | (pool_ids < 0), INF)
        best = torch.argmin(sel_d, dim=1)                          # [Q]
        best_id = pool_ids[rows, best]
        alive = torch.isfinite(sel_d[rows, best])
        expanded[rows, best] |= alive

        nbrs = neighbors[best_id.clamp(min=0).long()]              # [Q, R]
        nbrs = torch.where(alive[:, None] & (nbrs >= 0), nbrs, -1)
        nsafe = nbrs.clamp(min=0).long()
        nd = norms[nsafe] - 2.0 * torch.einsum("qd,qrd->qr", qvecs,
                                               vectors[nsafe])
        nd = nd.masked_fill(nbrs < 0, INF)

        all_ids = torch.cat([pool_ids, nbrs], dim=1)
        all_d = torch.cat([pool_d, nd], dim=1)
        all_exp = torch.cat([expanded, torch.zeros_like(nbrs,
                                                        dtype=torch.bool)], 1)
        order = torch.sort(all_d, dim=1, stable=True).indices
        all_ids, all_d, all_exp = take(order, all_ids, all_d, all_exp)
        dup = torch.zeros_like(all_exp)
        dup[:, 1:] = (all_ids[:, 1:] == all_ids[:, :-1]) & (all_ids[:, 1:] >= 0)
        all_d = all_d.masked_fill(dup, INF)
        all_ids = torch.where(dup, -1, all_ids)
        order = torch.sort(all_d, dim=1, stable=True).indices
        all_ids, all_d, all_exp = take(order, all_ids, all_d, all_exp)
        pool_ids, pool_d, expanded = (all_ids[:, :L], all_d[:, :L],
                                      all_exp[:, :L])
    return pool_ids, pool_d


def graft_graph(old: VamanaGraph, vectors: np.ndarray, bitmaps: np.ndarray,
                universe: int, old_to_new: np.ndarray, new_rows: np.ndarray,
                r: int = 32, alpha: float = 1.2, seed: int = 0,
                n_cand: int = 64, n_random_edges: int = 2,
                device="cuda") -> VamanaGraph:
    """Graft a compacted dataset onto an existing graph (FreshDiskANN-style
    StreamingMerge) instead of rebuilding it.

    Surviving rows keep their pruned edge lists with targets remapped
    through `old_to_new`; rows that lost a target compact their
    remaining edges leftward in order, while untouched rows keep their
    slot layout bit-for-bit (so an identity remap reproduces the old
    graph exactly). Each new row (`new_rows`, ids in the *new*
    dataset) finds its edge pool by beam-searching the surviving graph
    from the medoid plus its nearest other new rows, then runs the same
    α-occlusion prune as the offline build; its selected edges are
    back-inserted into the targets' free (or farthest, if closer) slots
    so the new rows are reachable. Label entry points recompute only for
    labels whose old entry died. Deterministic for fixed inputs.

    The new rows' pools and prune run on `device` (`_graft_edges_torch`:
    the JAX package's float32 steps, the nearest new rows a block at a
    time instead of its [B, B] matrix). The back-insertion stays a
    sequential host loop: each insertion sees the rows the earlier ones
    changed.
    """
    n = vectors.shape[0]
    rng = np.random.default_rng(seed)
    norms = (vectors ** 2).sum(1).astype(np.float32)
    new_rows = np.asarray(new_rows, dtype=np.int64)
    rr = old.neighbors.shape[1]

    # 1. survivors: remap edge targets, compact dropped slots leftward
    neighbors = np.full((n, rr), -1, dtype=np.int32)
    surv_old = np.nonzero(old_to_new >= 0)[0]
    if surv_old.size:
        dst = old_to_new[surv_old]
        nb = old.neighbors[surv_old].astype(np.int64)
        nb_new = np.where(nb >= 0, old_to_new[np.maximum(nb, 0)],
                          -1).astype(np.int32)
        # compact only rows that actually lost a target: untouched rows
        # keep their slot layout bit-for-bit
        died = (nb >= 0) & (nb_new < 0)
        need = died.any(axis=1)
        if need.any():
            order = np.argsort(nb_new[need] < 0, axis=1, kind="stable")
            nb_new[need] = np.take_along_axis(nb_new[need], order, axis=1)
        neighbors[dst] = nb_new

    # 2. medoid: keep if it survived, else recompute (one matvec)
    if 0 <= old.medoid < old_to_new.shape[0] and old_to_new[old.medoid] >= 0:
        medoid = int(old_to_new[old.medoid])
    else:
        medoid = _medoid(vectors, norms)

    # 3. new rows: pool = beam search over the survivor graph + nearest
    #    other new rows, then the shared occlusion prune
    if new_rows.size:
        b = len(new_rows)
        nv = vectors[new_rows]
        seeds = np.full((b, 4), -1, dtype=np.int32)
        seeds[:, 0] = medoid
        if surv_old.size:
            seeds[:, 1:] = old_to_new[surv_old][
                rng.integers(0, surv_old.size, size=(b, 3))]
        L = max(n_cand, rr + 1)

        def dev(x):
            return torch.from_numpy(np.ascontiguousarray(x)).to(device)

        vec_t, nrm_t = dev(vectors), dev(norms)
        pool_ids, pool_d = beam_search(
            dev(nv), dev(seeds), dev(neighbors), vec_t, nrm_t,
            l_search=L, iters=L // 2)
        keep_n = max(rr - n_random_edges, 1)
        sel = _graft_edges_torch(pool_ids, pool_d, dev(new_rows), vec_t,
                                 nrm_t, n_cand, alpha, keep_n).cpu().numpy()
        neighbors[new_rows, :sel.shape[1]] = sel
        if n_random_edges > 0:
            neighbors[new_rows, rr - n_random_edges:] = rng.integers(
                0, n, size=(b, n_random_edges))

        _back_insert(neighbors, new_rows, sel, vectors, norms)

    # 4. label entries: carry survivors, recompute orphaned labels only
    carried = np.where(old.label_entry >= 0,
                       old_to_new[np.maximum(old.label_entry, 0)], -1)
    label_entry = carried.astype(np.int32).copy()
    _label_entry(vectors, norms, bitmaps,
                 [l for l in range(universe) if carried[l] < 0], label_entry)
    return VamanaGraph(neighbors=neighbors, medoid=medoid,
                       label_entry=label_entry)


def _back_insert(neighbors: np.ndarray, new_rows: np.ndarray,
                 sel: np.ndarray, vectors: np.ndarray,
                 norms: np.ndarray) -> None:
    """Reverse edges, in place: each new row u becomes reachable from
    every target v of its edges `sel`, in v's first free slot, or in
    place of v's farthest neighbour if u is closer. One row after
    another, as the JAX package's loop: each insertion sees the rows the
    earlier ones changed."""
    for i, u in enumerate(new_rows):
        for v in sel[i]:
            if v < 0 or v == u:
                continue
            row = neighbors[v]
            if (row == u).any():
                continue
            free = np.nonzero(row < 0)[0]
            if free.size:
                row[free[0]] = u
            else:
                dv = norms[row] - 2.0 * vectors[v] @ vectors[row].T
                w = int(np.argmax(dv))
                if float(norms[u] - 2.0 * vectors[v] @ vectors[u]) < dv[w]:
                    row[w] = u


def _stable_smallest(d: torch.Tensor, c: int) -> torch.Tensor:
    """[B, c] positions of each row's c smallest entries in ascending
    order, ties to the lower position: a stable argsort's first c."""
    pos = torch.arange(d.shape[1], device=d.device)
    key = (topk.order_key(d).long() << 32) | pos[None, :]
    return torch.topk(key, c, dim=1, largest=False, sorted=True).indices


def _graft_edges_torch(pool_ids: torch.Tensor, pool_d: torch.Tensor,
                       new_rows: torch.Tensor, vectors: torch.Tensor,
                       norms: torch.Tensor, n_cand: int, alpha: float,
                       keep_n: int) -> torch.Tensor:
    """The new rows' [B, keep_n] pruned edges on tensors of one device:
    each row's beam pool [B, L] plus its nearest other new rows, the
    `n_cand` nearest of both (stable), itself dropped, then
    `occlusion_prune_torch`. The JAX package's float32 scores and stable
    orders, ROW_CHUNK new rows at a time instead of its [B, B] matrix
    (65,536 new rows would need 17 GB for it and a host sort of every
    row)."""
    b = new_rows.shape[0]
    rows = new_rows.long()
    nv, nn = vectors[rows], norms[rows]
    t = min(16, b - 1)
    out = []
    for s in range(0, b, ROW_CHUNK):
        e = min(s + ROW_CHUNK, b)
        ids, d = pool_ids[s:e], pool_d[s:e]
        if t > 0:
            dn = nn[None, :] - 2.0 * (nv[s:e] @ nv.T)             # [c, B]
            local = torch.arange(e - s, device=dn.device)
            dn[local, local + s] = INF
            nn_idx = _stable_smallest(dn, t)
            ids = torch.cat([ids, new_rows[nn_idx].to(torch.int32)], dim=1)
            d = torch.cat([d, torch.gather(dn, 1, nn_idx)], dim=1)
        merge = _stable_smallest(d, min(n_cand, d.shape[1]))
        cid = torch.gather(ids, 1, merge)
        cdist = torch.gather(d, 1, merge)
        cid = torch.where(cid == new_rows[s:e, None].to(torch.int32), -1, cid)
        cdist = cdist.masked_fill(cid < 0, INF)
        out.append(occlusion_prune_torch(cid, cdist, vectors, norms, alpha,
                                         keep_n))
    return torch.cat(out)
