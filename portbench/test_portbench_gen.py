"""The benchmark's generator: determinism in the seed, the spec's
distributions, §6.1.3 queries, and a pool whose batches do not depend
on how far it was drawn ahead."""

import numpy as np
import pytest
import torch

from portbench.harness import gen
from portbench.reference.exact import predicate_mask

SPEC = gen.DataSpec(n=4000, dim=48, universe=200, latent_dim=10,
                    n_clusters=64, zipf_a=1.2, avg_labels=2.0,
                    coupling=0.5, noise=0.25)
WIDE = gen.DataSpec(n=4000, dim=96, universe=1000, latent_dim=20,
                    n_clusters=96, zipf_a=1.2, avg_labels=2.5,
                    coupling=0.4, noise=0.45)


def _labels_a_row(bitmaps, universe):
    return gen.unpack(bitmaps, universe).sum(1).double()


@pytest.mark.parametrize("spec", [SPEC, WIDE], ids=["w7", "w32"])
def test_same_seed_same_data(spec):
    a = gen.make_data(spec, 12345, "cpu")
    b = gen.make_data(spec, 12345, "cpu")
    assert torch.equal(a.vectors, b.vectors)
    assert torch.equal(a.bitmaps, b.bitmaps)
    assert a.median_norm == b.median_norm


def test_seeds_differ_and_large_seeds_work():
    a = gen.make_data(SPEC, 2 ** 31 + 11, "cpu")
    b = gen.make_data(SPEC, 2 ** 40 + 3, "cpu")
    assert not torch.equal(a.vectors, b.vectors)
    assert a.vectors.shape == (SPEC.n, SPEC.dim)
    assert a.bitmaps.dtype == torch.int32


@pytest.mark.parametrize("spec", [SPEC, WIDE], ids=["w7", "w32"])
def test_labels_follow_the_spec(spec):
    d = gen.make_data(spec, 7, "cpu")
    per_row = _labels_a_row(d.bitmaps, spec.universe)
    assert per_row.min() >= 1
    assert abs(per_row.mean().item() - spec.avg_labels) < 0.1 * spec.avg_labels
    # no bit past the universe
    mem = gen.unpack(d.bitmaps, spec.words * 32)
    assert not mem[:, spec.universe:].any()
    # Zipf skew: the most frequent label is carried far more often than
    # the median label
    freq = gen.unpack(d.bitmaps, spec.universe).sum(0).double()
    assert freq.max() > 10 * freq.median()


def test_pack_unpack_round_trip():
    g = torch.Generator().manual_seed(0)
    mem = torch.rand((50, 70), generator=g) < 0.2
    assert torch.equal(gen.unpack(gen.pack(mem), 70), mem)


@pytest.mark.parametrize("pred", gen.PREDICATES)
def test_queries_follow_section_613(pred):
    d = gen.make_data(SPEC, 3, "cpu")
    qv, qb = gen.make_queries(d, pred, 200, gen.generator("cpu", 3, "q"))
    n_labels = _labels_a_row(qb, SPEC.universe)
    ok = predicate_mask(d.bitmaps, qb, pred)
    if pred == "EQUALITY":
        assert ok.any(1).all()          # another row's whole label set
    elif pred == "AND":
        assert ((n_labels >= 1) & (n_labels <= 3)).all()
        assert ok.any(1).all()          # some of a row's labels
    else:
        assert ((n_labels >= 1) & (n_labels <= 8)).all()
        assert (n_labels >= 2).float().mean() > 0.5
    # a base row plus noise at 10% of the median norm
    dist = torch.cdist(qv, d.vectors).min(1).values
    assert (dist < 0.3 * d.median_norm).all()


def test_pool_batches_do_not_depend_on_how_far_it_was_drawn():
    d = gen.make_data(SPEC, 5, "cpu")
    host = (d.vectors.numpy().copy(), d.bitmaps.numpy().view(np.uint32).copy())
    ahead = gen.QueryPool(d, 5, "window", 16, gen.PREDICATES, chunk=4)
    ahead.prepare(12)
    late = gen.QueryPool(d, 5, "window", 16, gen.PREDICATES, chunk=4)
    late.prepare(4)
    late.keep_host_rows(*host)
    for i in range(12):
        pa, va, ba = ahead.get(i)
        pl, vl, bl = late.get(i)
        assert pa == pl == gen.PREDICATES[i % 3]
        np.testing.assert_array_equal(va, vl)
        np.testing.assert_array_equal(ba, bl)
    assert late.drawn_late == 2 and ahead.drawn_late == 0


def test_streams_are_independent():
    d = gen.make_data(SPEC, 5, "cpu")
    w = gen.QueryPool(d, 5, "window", 8, gen.PREDICATES)
    m = gen.QueryPool(d, 5, "warm", 8, gen.PREDICATES)
    assert not np.array_equal(w.get(0)[1], m.get(0)[1])
    assert gen.sub_seed(5, "a") != gen.sub_seed(5, "b")
    assert 0 <= gen.sub_seed(2 ** 33, "data") < 2 ** 63
