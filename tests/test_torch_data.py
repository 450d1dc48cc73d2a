"""The port's data layer against the JAX package's: one `DatasetSpec`
gives byte-identical datasets, queries and ground truth, and the label
and predicate helpers agree bit for bit (uint32 words carried as int32
views on the torch side)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ann import labels as jlb
from repro.ann import predicates as jpr
from repro.ann.dataset import ground_truth_topk as j_gt
from repro.ann.dataset import recall_at_k as j_recall
from repro.data import ann_synth as jsyn
from repro_torch.ann import labels as tlb
from repro_torch.ann import predicates as tpr
from repro_torch.ann.dataset import ground_truth_topk as t_gt
from repro_torch.ann.dataset import recall_at_k as t_recall
from repro_torch.data import ann_synth as tsyn

# (name, n, dim, universe, latent, clusters, zipf, avg labels, coupling,
#  noise, seed): the suite's tiny spec, a one-word universe, and the
#  synth_192d label structure (W = 7) at a CPU size
SPECS = [
    ("tiny", 600, 24, 40, 6, 8, 1.3, 2.0, 0.5, 0.3, 7),
    ("one_word", 400, 16, 30, 4, 6, 1.4, 1.6, 0.6, 0.35, 9),
    ("synth_192d_small", 900, 32, 200, 10, 64, 1.2, 2.0, 0.5, 0.25, 201),
]
FIELDS = ["vectors", "bitmaps", "group_of", "group_bitmaps", "group_start",
          "group_size", "norms_sq"]


@pytest.fixture(scope="module", params=SPECS, ids=[s[0] for s in SPECS])
def pair(request):
    jd = jsyn.synthesize(jsyn.DatasetSpec(*request.param))
    td = tsyn.synthesize(tsyn.DatasetSpec(*request.param))
    return jd, td


def test_spec_tables_match():
    for table in ("TRAIN_SPECS", "VALIDATION_SPECS", "ALL_SPECS"):
        jt, tt = getattr(jsyn, table), getattr(tsyn, table)
        assert list(jt) == list(tt)
        for name in jt:
            assert dataclasses.astuple(jt[name]) == \
                dataclasses.astuple(tt[name])


def test_dataset_byte_identical(pair):
    jd, td = pair
    for f in FIELDS:
        a, b = getattr(jd, f), getattr(td, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        assert a.tobytes() == b.tobytes(), f
    assert jd.group_lookup == td.group_lookup
    assert (jd.name, jd.universe, jd.n, jd.dim, jd.n_groups) == \
        (td.name, td.universe, td.n, td.dim, td.n_groups)


@pytest.mark.parametrize("pred", [0, 1, 2])
def test_queries_and_ground_truth_identical(pair, pred):
    jd, td = pair
    jq = jsyn.make_queries(jd, pred, 20, seed=5)
    tq = tsyn.make_queries(td, pred, 20, seed=5)
    for f in ("vectors", "bitmaps", "ground_truth"):
        assert getattr(jq, f).tobytes() == getattr(tq, f).tobytes(), f
    assert (int(jq.pred), jq.k, jq.dataset) == (int(tq.pred), tq.k,
                                                tq.dataset)
    gt_t = t_gt(td, tq.vectors, tq.bitmaps, pred, 7)
    np.testing.assert_array_equal(gt_t, j_gt(jd, jq.vectors, jq.bitmaps,
                                             pred, 7))
    for qi in range(3):
        assert td.selectivity(tq.bitmaps[qi], pred) == \
            jd.selectivity(jq.bitmaps[qi], pred)
        np.testing.assert_array_equal(td.matching_mask(tq.bitmaps[qi], pred),
                                      jd.matching_mask(jq.bitmaps[qi], pred))


def test_recall_at_k_identical():
    rng = np.random.default_rng(3)
    gt = rng.integers(-1, 30, (12, 10)).astype(np.int32)
    got = rng.integers(-1, 30, (12, 10)).astype(np.int32)
    got[:4] = gt[:4]
    np.testing.assert_array_equal(t_recall(got, gt), j_recall(got, gt))


def _words(rng, shape):
    """Random uint32 words with the top bit often set (the int32 view's
    sign bit)."""
    w = rng.integers(0, 2 ** 32, shape, dtype=np.uint64).astype(np.uint32)
    w[..., 0] |= np.uint32(1 << 31)
    return w


@pytest.mark.parametrize("universe", [1, 31, 32, 33, 200])
def test_labels_identical(universe):
    rng = np.random.default_rng(universe)
    sets = [sorted(set(rng.integers(0, universe, rng.integers(0, 6))
                       .tolist())) for _ in range(25)]
    assert tlb.n_words(universe) == jlb.n_words(universe)
    packed = tlb.pack_label_sets(sets, universe)
    np.testing.assert_array_equal(packed,
                                  jlb.pack_label_sets(sets, universe))
    for s, row in zip(sets, packed):
        np.testing.assert_array_equal(tlb.pack_one(s, universe),
                                      jlb.pack_one(s, universe))
        assert tlb.unpack_one(row) == jlb.unpack_one(row) == frozenset(s)
        assert tlb.bitmap_key(row) == jlb.bitmap_key(row)
    with pytest.raises(ValueError):
        tlb.pack_one([universe], universe)


def test_bitmap_tensor_round_trip_and_popcount():
    bm = _words(np.random.default_rng(1), (50, 7))
    t = tlb.bitmap_tensor(bm, "cpu")
    assert t.dtype == torch.int32
    np.testing.assert_array_equal(tlb.bitmap_numpy(t), bm)
    np.testing.assert_array_equal(tlb.popcount(t).numpy(),
                                  np.asarray(jlb.popcount(jnp.asarray(bm))))


@pytest.mark.parametrize("pred", [0, 1, 2])
def test_eval_predicate_identical(pred):
    rng = np.random.default_rng(pred)
    base = _words(rng, (64, 3)) & _words(rng, (64, 3))
    qb = base[rng.integers(0, 64, 9)] & _words(rng, (9, 3))
    qb[0] = base[5]
    qb[1] = 0
    want = np.asarray(jpr.eval_predicate(jnp.asarray(base)[None],
                                         jnp.asarray(qb)[:, None], pred))
    got = tpr.eval_predicate(tlb.bitmap_tensor(base, "cpu")[None],
                             tlb.bitmap_tensor(qb, "cpu")[:, None], pred)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        tpr.eval_predicate_np(base[None], qb[:, None], pred),
        jpr.eval_predicate_np(base[None], qb[:, None], pred))
    assert tpr.Predicate.parse(["eq", "and", "or"][pred]) == pred


@pytest.mark.parametrize("pred", [0, 1, 2])
def test_candidate_and_block_masks_identical(pred):
    """The port's masks over candidates [Q, C, W] and over the whole base
    [N, W] (both through `eval_predicate`) against the JAX package's
    word-looped `mask_cand` and `mask_shared`, with an empty query."""
    from repro.ann import engine as jeng
    from repro_torch.ann import engine as teng
    from repro_torch.kernels import masked_topk as tmk
    rng = np.random.default_rng(30 + pred)
    base = _words(rng, (80, 3)) & _words(rng, (80, 3))
    qb = base[rng.integers(0, 80, 6)] & _words(rng, (6, 3))
    qb[0] = 0
    cand = base[rng.integers(0, 80, (6, 25))]
    np.testing.assert_array_equal(
        teng.mask_cand(tlb.bitmap_tensor(cand, "cpu"),
                       tlb.bitmap_tensor(qb, "cpu"), pred).numpy(),
        np.asarray(jeng.mask_cand(jnp.asarray(cand), jnp.asarray(qb), pred)))
    np.testing.assert_array_equal(
        tmk._predicate_mask_block(tlb.bitmap_tensor(base, "cpu"),
                                  tlb.bitmap_tensor(qb, "cpu"), pred).numpy(),
        np.asarray(jeng.mask_shared(jnp.asarray(base), jnp.asarray(qb),
                                    pred)))
