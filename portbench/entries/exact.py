"""Exact filtered search, past the router and the approximate methods:
`FilteredIndex.search(QueryBatch, "prefilter")`, the masked scan
(`kernels.ops.masked_topk`) over every row.

Set-up builds the dataset and the handle from the drawn rows; warm-up
serves one batch of each predicate. The comparison takes
`check_batches` of the window's batches, drawn from the seed, and holds
every query's ids and distances to the reference's exact answer. The
control (`control`) judges the reference's answers the same way.
"""

from __future__ import annotations

import numpy as np

from portbench.harness import gen
from portbench.harness import judge as judge_mod


def _judge(ref, pool, seed, check_batches, k, served, answer):
    """Judge `check_batches` of the `served` batch indices, drawn from
    the seed; `answer(i)` gives batch i's (ids, dists)."""
    rng = np.random.default_rng(gen.sub_seed(seed, "check"))
    pick = np.sort(rng.choice(len(served), size=min(
        check_batches, len(served)), replace=False))
    batches = []
    for j in pick:
        i = served[j]
        batches.append(pool.get(i) + tuple(answer(i)))
    return judge_mod.judge_exact(ref, batches, k)


class Exact:
    probes = ()

    def __init__(self, ctx):
        from repro_torch.ann.dataset import ANNDataset
        from repro_torch.ann.index import FilteredIndex, QueryBatch
        from repro_torch.ann.predicates import Predicate

        self.QueryBatch, self.Predicate = QueryBatch, Predicate
        cell = ctx.cell
        self.k = int(cell.traffic["k"])
        self.check_batches = int(cell.traffic["check_batches"])
        ds = ANNDataset.from_packed(cell.config_name, ctx.vectors,
                                    ctx.bitmaps, ctx.spec.universe)
        self.fx = FilteredIndex(ds, device=ctx.device)
        self.out = {}            # i -> (ids, dists)

    def listen(self, probe) -> None:
        pass

    def attach_tracer(self, tracer) -> None:
        pass                     # the exact path opens no span

    def _search(self, pred, qv, qb):
        return self.fx.search(
            self.QueryBatch(qv, qb, self.Predicate.parse(pred), self.k),
            "prefilter")

    def warm(self, pred, qv, qb) -> None:
        self._search(pred, qv, qb)

    def serve(self, i, pred, qv, qb) -> dict:
        res = self._search(pred, qv, qb)
        self.out[i] = (res.ids, res.distances)
        return res.timings

    def close(self) -> None:
        self.fx.close()
        self.fx = None

    def judge(self, ref, pool, seed, limits):
        return _judge(ref, pool, seed, self.check_batches, self.k,
                      sorted(self.out), self.out.__getitem__)


def setup(ctx):
    return Exact(ctx)


def control(ctl):
    """The numbers of the reference's answers in the program's place."""
    tr = ctl.cell.traffic
    return _judge(ctl.ref, ctl.pool, ctl.seed, int(tr["check_batches"]),
                  int(tr["k"]), list(range(ctl.n_batches)),
                  lambda i: ctl.answers(*ctl.pool.get(i))[:2])[0]
