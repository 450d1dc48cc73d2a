"""The roofline counts: the work an op needs, counted over the label
sets from the call's arguments, and the peaks they are divided by."""

import pytest
import torch

from portbench.harness import gen, rooflines
from portbench.harness.peaks import PEAKS, peaks_for
from portbench.reference.exact import predicate_mask
from portbench.reference.groups import group_rows

SPEC = gen.DataSpec(n=5000, dim=32, universe=200, latent_dim=8,
                    n_clusters=16, zipf_a=1.2, avg_labels=2.0,
                    coupling=0.5, noise=0.25)


@pytest.fixture(scope="module")
def data():
    return gen.make_data(SPEC, 21, "cpu")


def test_selectivity_counts_over_label_sets(data):
    g = group_rows(data.bitmaps).n_groups
    assert g == torch.unique(data.bitmaps, dim=0).shape[0]
    assert g < SPEC.n                  # label sets repeat across rows
    ops, nbytes = rooflines.selectivity_counts(256, SPEC.words, g)
    assert ops == 256 * g * SPEC.words
    assert nbytes == g * (SPEC.words + 1) * 4 + 256 * SPEC.words * 4 + 256 * 4


@pytest.mark.parametrize("pred", [0, 1, 2])
def test_masked_topk_counts_against_rows(data, pred):
    qv, qb = gen.make_queries(data, gen.PREDICATES[pred], 64,
                              gen.generator("cpu", 21, pred))
    gbm, sizes = rooflines.GroupTables().of(data.bitmaps)
    flops, nbytes = rooflines.masked_topk_counts(gbm, sizes, qb, pred,
                                                 SPEC.dim, 10)
    mask = predicate_mask(data.bitmaps, qb, gen.PREDICATES[pred])
    pairs, rows = int(mask.sum()), int(mask.any(0).sum())
    assert flops == 2 * SPEC.dim * pairs
    g = gbm.shape[0]
    assert nbytes == (g * (SPEC.words + 1) * 4 + rows * (SPEC.dim + 1) * 4
                      + 64 * (SPEC.dim + SPEC.words) * 4 + 64 * 10 * 8)


def test_group_tables_are_worked_out_once_a_tensor(data):
    t = rooflines.GroupTables()
    a = t.of(data.bitmaps)
    assert t.of(data.bitmaps) is a
    assert int(a[1].sum()) == SPEC.n


def test_least_seconds_is_the_larger_bound():
    assert rooflines.least_seconds(2e12, 1e9, 1e12, 1e12) == 2.0
    assert rooflines.least_seconds(1e9, 3e12, 1e12, 1e12) == 3.0


def test_peaks():
    p = peaks_for("NVIDIA H100 80GB HBM3")
    assert p["fp32_flops"] == 67e12 and p["hbm_bytes_s"] == 3.35e12
    assert abs(p["int32_ops"] - 16.7e12) < 0.05e12
    assert peaks_for("some other card") == {}
    assert all(set(v) == {"fp32_flops", "int32_ops", "hbm_bytes_s"}
               for v in PEAKS.values())


@pytest.mark.parametrize("pred", [0, 2])
def test_roofline_metrics_record_their_op_calls(data, pred):
    """Each roofline reader keeps what it needs of a call's arguments
    and sums the least seconds of the counts over its records."""
    from portbench.harness.cell import load_module

    qv, qb = gen.make_queries(data, gen.PREDICATES[pred], 64,
                              gen.generator("cpu", 22, pred))
    peaks = peaks_for("NVIDIA H100 80GB HBM3")
    g = group_rows(data.bitmaps).n_groups
    gbm, sizes = rooflines.GroupTables().of(data.bitmaps)

    sel = load_module("metrics", "selectivity_roofline")
    assert sel.OP == "selectivity"
    r = sel.record((qb, data.bitmaps), {"pred": pred}, None)
    ops, nbytes = rooflines.selectivity_counts(64, SPEC.words, g)
    one = rooflines.least_seconds(ops, nbytes, peaks["int32_ops"],
                                  peaks["hbm_bytes_s"])
    assert sel.least_seconds([r, r], peaks) == pytest.approx(2 * one)
    assert sel.least_seconds([r], {}) is None

    mt = load_module("metrics", "masked_topk_roofline")
    assert mt.OP == "masked_topk"
    norms = (data.vectors ** 2).sum(1)
    r = mt.record((qv, qb, data.vectors, norms, data.bitmaps),
                  {"pred": pred, "k": 10}, None)
    flops, nbytes = rooflines.masked_topk_counts(gbm, sizes, qb, pred,
                                                 SPEC.dim, 10)
    one = rooflines.least_seconds(flops, nbytes, peaks["fp32_flops"],
                                  peaks["hbm_bytes_s"])
    assert mt.least_seconds([r], peaks) == pytest.approx(one)
    assert mt.least_seconds([r], {}) is None
