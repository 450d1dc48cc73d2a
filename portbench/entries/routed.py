"""Routed search, the paper's served path:
`RouterService(FilteredIndex(ds), MLRouter.load(router) + the frozen
table B, t=T).search(QueryBatch)`.

Set-up builds the dataset and the handle from the drawn rows, loads the
router artifact and adds the configuration's frozen table B, builds the
index of every (method, setting) that Algorithm 2 can choose for the
traffic's predicates under that table, and fills the handle's dataset
features. Warm-up serves one batch of each predicate and runs every
reachable (method, setting) on a few of its queries.

The comparison covers every layer a batch crosses: the selectivity
counts the features took, the MLPs' predicted recalls, Algorithm 2's
decisions, each returned id and distance, and recall@k of every served
query against the reference's exact answer.
"""

from __future__ import annotations

import os

from portbench.harness import judge as judge_mod
from portbench.reference.router import Router as RefRouter

WARM_QUERIES = 64
NAMES = ("EQUALITY", "AND", "OR")


def _paths(cell):
    root = cell.root
    return (os.path.join(root, cell.config["router"]),
            os.path.join(root, cell.config["table_b"]))


class Routed:
    probes = ("selectivity",)

    def __init__(self, ctx):
        from repro_torch.ann import engine
        from repro_torch.ann import methods  # noqa: F401  (registers them)
        from repro_torch.ann.dataset import ANNDataset
        from repro_torch.ann.index import FilteredIndex, QueryBatch
        from repro_torch.ann.predicates import Predicate
        from repro_torch.ann.registry import get_method
        from repro_torch.ann.service import RouterService
        from repro_torch.core import features
        from repro_torch.core.router import MLRouter
        from repro_torch.core.table import BenchmarkTable

        self.QueryBatch, self.Predicate = QueryBatch, Predicate
        cell = ctx.cell
        self.cell, self.k = cell, int(cell.traffic["k"])
        self.t = float(cell.config["t"])
        self.name = cell.config_name
        router_dir, table_path = _paths(cell)
        ds = ANNDataset.from_packed(self.name, ctx.vectors, ctx.bitmaps,
                                    ctx.spec.universe)
        self.fx = FilteredIndex(ds, device=ctx.device)
        router = MLRouter.load(router_dir)
        frozen = BenchmarkTable.load(table_path)
        for (d, p, m, ps), v in frozen.entries.items():
            router.table.add(d, p, m, ps, v["recall"], v["qps"])
        self.router = router
        self.svc = RouterService(self.fx, router, t=self.t)
        self.reachable = []
        for pred in cell.traffic["predicates"]:
            has, _, ps_pass, ps_fb = router.table.routing_arrays(
                self.name, int(Predicate.parse(pred)), router.methods,
                self.t)
            for j, m in enumerate(router.methods):
                method = get_method(m)
                setting = engine.resolve_setting(
                    method, ps_pass[j] if has[j] else ps_fb[j])
                self.fx.get_index(method, setting.build)
                self.reachable.append((pred, method, setting))
        features.dataset_features(ds, fx=self.fx)

        # what the comparison needs, per window batch
        self.batch = None
        self.out = {}          # i -> [ids, dists, decisions, r_hat]
        self.sel_calls = []    # (i, pred, counts tensor)
        orig = router.predict_recalls_from_features

        def predict(x_raw, **kw):
            r = orig(x_raw, **kw)
            if self.batch is not None:
                self.out.setdefault(self.batch, {})["r_hat"] = r
            return r

        router.predict_recalls_from_features = predict

    def listen(self, probe) -> None:
        def on_call(args, kwargs, out):
            if self.batch is not None:
                self.sel_calls.append((self.batch, int(kwargs["pred"]), out))
        probe.listeners.append(on_call)

    def attach_tracer(self, tracer) -> None:
        self.svc.tracer = tracer

    def _query_batch(self, pred, qv, qb):
        return self.QueryBatch(qv, qb, self.Predicate.parse(pred), self.k)

    def warm(self, pred, qv, qb) -> None:
        self.svc.search(self._query_batch(pred, qv, qb))
        for p, method, setting in self.reachable:
            if p == pred:
                self.fx.run_method(method, setting, self._query_batch(
                    pred, qv[:WARM_QUERIES], qb[:WARM_QUERIES]))

    def serve(self, i, pred, qv, qb) -> dict:
        self.batch = i
        res = self.svc.search(self._query_batch(pred, qv, qb))
        self.batch = None
        o = self.out.setdefault(i, {})
        o["ids"], o["dists"] = res.ids, res.distances
        o["decisions"] = [tuple(d) for d in res.decisions]
        return res.timings

    def close(self) -> None:
        self.sel_calls = [(i, p, c.cpu().numpy()) for i, p, c in
                          self.sel_calls]
        self.fx.close()
        self.svc = self.router = self.fx = None

    def judge(self, ref, pool, seed, limits):
        batches = []
        for i in sorted(self.out):
            pred, qv, qb = pool.get(i)
            o = self.out[i]
            batches.append((pred, qv, qb, o["ids"], o["dists"],
                            o["decisions"], o["r_hat"]))
        calls = [(i, NAMES[p], c) for i, p, c in self.sel_calls]
        return _judge(self.cell, ref, batches, calls, limits)


def _judge(cell, ref, batches, calls, limits):
    return judge_mod.judge_routed(
        ref, RefRouter(*_paths(cell)), cell.config_name,
        float(cell.config["t"]), batches, calls, int(cell.traffic["k"]),
        float(limits["rhat_gap"]))


def setup(ctx):
    return Routed(ctx)


def control(ctl):
    """The numbers of the reference in the program's place: its exact
    answers, its MLPs' predictions at `ctl.precision` and Algorithm 2's
    decisions on them (the selectivity counts are exact integers either
    way)."""
    from portbench.reference import router as ref_router

    cell, ref = ctl.cell, ctl.ref
    router = RefRouter(*_paths(cell))
    lid = ref_router.lid_mean(ref.host_vectors[ref.groups.order])
    t = float(cell.config["t"])
    batches, calls = [], []
    for i in range(ctl.n_batches):
        pred, qv, qb = ctl.pool.get(i)
        ids, d, counts = ctl.answers(pred, qv, qb)
        r_hat = router.predict(router.feature_matrix(counts / ref.n, lid,
                                                     pred),
                               precision=ctl.precision)
        decisions = router.decide(r_hat, cell.config_name, pred, t)
        batches.append((pred, qv, qb, ids, d, decisions, r_hat))
        calls.append((i, pred, counts))
    return _judge(cell, ref, batches, calls, cell.limits)[0]
