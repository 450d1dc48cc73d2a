"""The reference against the port's plain CPU path at a tiny size: the
served row order, exact answers, selectivity counts, `lid_mean`, the
MLPs' predictions and Algorithm 2."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from portbench.harness import gen
from portbench.reference import exact as ref_exact
from portbench.reference import router as ref_router
from portbench.reference.exact import predicate_mask
from portbench.reference.groups import group_rows

from repro_torch.ann.dataset import ANNDataset
from repro_torch.ann.index import FilteredIndex, QueryBatch
from repro_torch.ann.predicates import Predicate
from repro_torch.core import features as F
from repro_torch.core.router import MLRouter
from repro_torch.core.table import BenchmarkTable

PB = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(PB)
ROUTER = os.path.join(ROOT, "src", "repro_torch", "assets", "router_all")
TABLE = os.path.join(PB, "configs", "synth192d-1m.tableB.json")
SPEC = gen.DataSpec(n=3000, dim=48, universe=200, latent_dim=10,
                    n_clusters=64, zipf_a=1.2, avg_labels=2.0,
                    coupling=0.5, noise=0.25)


@pytest.fixture(scope="module")
def drawn():
    d = gen.make_data(SPEC, 99, "cpu")
    vec = d.vectors.numpy().copy()
    bm = d.bitmaps.numpy().view(np.uint32).copy()
    ds = ANNDataset.from_packed("synth192d-1m", vec, bm, SPEC.universe)
    qs = {p: gen.make_queries(d, p, 40, gen.generator("cpu", 99, p))
          for p in gen.PREDICATES}
    return d, vec, bm, ds, qs


def test_groups_give_the_served_order(drawn):
    _, vec, bm, ds, _ = drawn
    _, order = ANNDataset.from_packed("x", vec, bm, SPEC.universe,
                                      return_order=True)
    g = group_rows(torch.from_numpy(bm.view(np.int32)))
    np.testing.assert_array_equal(g.order, order)
    assert g.n_groups == ds.n_groups
    np.testing.assert_array_equal(g.sizes, ds.group_size)


@pytest.mark.parametrize("pred", gen.PREDICATES)
def test_exact_matches_the_port(drawn, pred):
    d, vec, bm, ds, qs = drawn
    qv, qb = qs[pred]
    fx = FilteredIndex(ds, device="cpu")
    res = fx.search(QueryBatch(qv.numpy(), qb.numpy().view(np.uint32),
                               Predicate.parse(pred), 10), "prefilter")
    groups = group_rows(d.bitmaps)
    ids, dist, counts = ref_exact.exact_topk(d.vectors, groups, qv, qb,
                                             pred, 10)
    assert (counts == predicate_mask(d.bitmaps, qb, pred).sum(1).numpy()).all()
    order = groups.order
    port = np.where(res.ids >= 0, order[np.maximum(res.ids, 0)], -1)
    assert ((port >= 0).sum(1) == np.minimum(10, counts)).all()
    scale = float((d.vectors.double() ** 2).sum(1).mean())
    np.testing.assert_allclose(np.nan_to_num(res.distances, nan=-1),
                               np.nan_to_num(dist, nan=-1),
                               atol=1e-5 * scale)
    assert (ref_exact.recall(port, ids) > 0.99).all()


@pytest.mark.parametrize("pred", gen.PREDICATES)
def test_selectivity_counts_match_the_port(drawn, pred):
    d, _, _, ds, qs = drawn
    _, qb = qs[pred]
    want = F.batch_selectivity(ds, qb.numpy().view(np.uint32),
                               Predicate.parse(pred)) * ds.n
    got = ref_router.selectivity_counts(group_rows(d.bitmaps), qb, pred)
    np.testing.assert_array_equal(got, np.rint(want).astype(np.int64))


def test_lid_mean_is_the_ports_to_the_bit(drawn):
    _, vec, bm, ds, _ = drawn
    order = group_rows(torch.from_numpy(bm.view(np.int32))).order
    assert ref_router.lid_mean(vec[order]) == \
        F.dataset_features(ds).values["lid_mean"]


@pytest.mark.parametrize("pred", gen.PREDICATES)
def test_router_matches_the_port(drawn, pred):
    d, vec, bm, ds, qs = drawn
    _, qb = qs[pred]
    qb_np = qb.numpy().view(np.uint32)
    router = MLRouter.load(ROUTER)
    for (dn, p, m, ps), v in BenchmarkTable.load(TABLE).entries.items():
        router.table.add(dn, p, m, ps, v["recall"], v["qps"])
    fx = FilteredIndex(ds, device="cpu")
    r_port = router.predict_recalls(ds, qb_np, Predicate.parse(pred), fx=fx)
    ref = ref_router.Router(ROUTER, TABLE)
    groups = group_rows(d.bitmaps)
    counts = ref_router.selectivity_counts(groups, qb, pred)
    order = groups.order
    r_ref = ref.predict(ref.feature_matrix(counts / ds.n,
                                           ref_router.lid_mean(vec[order]),
                                           pred))
    np.testing.assert_allclose(r_port, r_ref, atol=1e-5)
    want = router.route_from_predictions(r_port.astype(np.float64),
                                         ds.name, Predicate.parse(pred), 0.9)
    assert ref.decide(r_port.astype(np.float64), ds.name, pred, 0.9) == \
        [tuple(w) for w in want]


def test_tf32_rounding():
    g = torch.Generator().manual_seed(1)
    x = torch.randn(1000, generator=g) * 1e3
    r = ref_exact.round_tf32(x)
    assert ((r.view(torch.int32) & 0x1FFF) == 0).all()
    assert ((r - x).abs() <= x.abs() * 2.0 ** -11).all()
    assert not torch.equal(r, x)


def test_recall_definition():
    truth = np.array([[1, 2, -1], [-1, -1, -1], [4, 5, 6]])
    got = np.array([[2, 9, -1], [-1, -1, -1], [6, 5, 4]])
    np.testing.assert_allclose(ref_exact.recall(got, truth), [0.5, 1.0, 1.0])


def test_the_reference_loads_nothing_of_the_program():
    code = ("import sys; sys.path[:0] = [sys.argv[1]]; "
            "import portbench.reference.exact, portbench.reference.router, "
            "portbench.reference.groups; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", code, ROOT], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    top = set(eval(out.stdout.strip().splitlines()[-1]))
    assert "portbench" in top
    assert not top & {"repro_torch", "repro", "jax", "jaxlib", "flax"}
