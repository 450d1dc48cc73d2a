"""The North star's test on the CPU: quickstart's dataset and a router over
the reference's whole candidate pool (`src/repro_torch/assets/router_all/`,
trained by the JAX package) serve through both packages'
`RouterService.search` with the same decisions and ids; distances agree
to fp32 summation order. The table-B rows for the dataset are measured
once, by the JAX package, and added to both routers, so QPS measured
separately in each package cannot move a decision."""

import os

import numpy as np
import pytest

from repro.ann import bench as jbench
from repro.ann.index import FilteredIndex as JIndex
from repro.ann.index import QueryBatch as JQB
from repro.ann.registry import get_method as j_get
from repro.ann.service import RouterService as JService
from repro.core.router import MLRouter as JRouter
from repro.core.training import METHOD_ORDER
from repro.data import ann_synth as jsynth
from repro_torch.ann.index import FilteredIndex
from repro_torch.ann.index import QueryBatch as TQB
from repro_torch.ann.predicates import PREDICATES
from repro_torch.ann.registry import candidate_methods
from repro_torch.ann.service import RouterService as TService
from repro_torch.core.router import MLRouter as TRouter
from repro_torch.data import ann_synth as tsynth

ASSET = os.path.join(os.path.dirname(__file__), "..", "src", "repro_torch",
                     "assets", "router_all")
# examples/quickstart.py's dataset
DEMO = ("demo", 4000, 48, 64, 8, 12, 1.3, 2.0, 0.5, 0.3, 42)
RTOL = ATOL = 1e-4     # fp32 scores from two matmuls summing in two orders
NEW = {"labelnav", "sieve", "fvamana"}


@pytest.fixture(scope="module")
def services():
    jds = jsynth.synthesize(jsynth.DatasetSpec(*DEMO))
    jfx = JIndex(jds)
    jr, tr = JRouter.load(ASSET), TRouter.load(ASSET)
    for pred in PREDICATES:
        qs = jsynth.make_queries(jds, pred, 40, seed=1)
        for name in METHOD_ORDER:
            m = j_get(name)
            for setting in m.param_settings():
                r = jbench.run_method(jfx, m, setting, qs)
                for router in (jr, tr):
                    router.table.add(jds.name, int(pred), name, r.ps_id,
                                     r.mean_recall, r.qps)
    tfx = FilteredIndex(tsynth.synthesize(tsynth.DatasetSpec(*DEMO)),
                        device="cpu")
    yield JService(jfx, jr, t=0.9), TService(tfx, tr, t=0.9), jds
    tfx.close()
    jfx.close()


def test_asset_routes_among_the_whole_pool():
    router = TRouter.load(ASSET)
    assert router.methods == METHOD_ORDER == list(candidate_methods())


@pytest.mark.parametrize("pred", PREDICATES)
def test_router_all_serves_as_reference(services, pred):
    jsvc, tsvc, jds = services
    qs = jsynth.make_queries(jds, pred, 50, seed=9, with_ground_truth=False)
    jr = jsvc.search(JQB(qs.vectors, qs.bitmaps, int(pred), 10))
    tr = tsvc.search(TQB(qs.vectors, qs.bitmaps, int(pred), 10))
    assert [tuple(d) for d in tr.decisions] == \
        [tuple(d) for d in jr.decisions]
    np.testing.assert_array_equal(tr.ids, jr.ids)
    np.testing.assert_array_equal(tr.keys, jr.keys)
    np.testing.assert_allclose(tr.distances, jr.distances, rtol=RTOL,
                               atol=ATOL, equal_nan=True)


def test_router_all_uses_the_newly_ported_methods(services):
    """The decisions that raised `KeyError` before the pool was ported:
    at least one query of the three batches goes to labelnav, sieve or
    fvamana, and the port answers it."""
    _, tsvc, jds = services
    chosen = set()
    for pred in PREDICATES:
        qs = jsynth.make_queries(jds, pred, 50, seed=9,
                                 with_ground_truth=False)
        res = tsvc.search(TQB(qs.vectors, qs.bitmaps, int(pred), 10))
        chosen |= {m for m, _ in res.decisions}
    assert chosen & NEW, chosen
