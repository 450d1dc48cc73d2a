"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test here needs a CUDA device and skips without one; the
file imports only torch, numpy and `repro_torch`, so it also runs where
JAX is not installed:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda_kernels.py
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import bitmap_filter as bf
from repro_torch.kernels import masked_topk as mk
from repro_torch.kernels import ops

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False   # the plain versions
    return torch.device("cuda")                      # stay in full fp32


def _tie_case(rng, q, n, d=24, w=2):
    """Integer-grid vectors (multiples of 1/4) with duplicated rows: every
    score is exact in fp32 whatever the summation order, and ties are
    frequent."""
    qv = (rng.integers(-6, 7, (q, d)) / 4.0).astype(np.float32)
    base = (rng.integers(-6, 7, (n, d)) / 4.0).astype(np.float32)
    base[n // 2: n // 2 + n // 4] = base[: n // 4]   # exact duplicates
    norms = (base.astype(np.float64) ** 2).sum(1).astype(np.float32)
    qb = (rng.integers(0, 2, (q, w)) * rng.integers(1, 8, (q, w))
          ).astype(np.uint32)
    bm = (rng.integers(0, 2, (n, w)) * rng.integers(1, 8, (n, w))
          ).astype(np.uint32)
    return qv, qb, base, norms, bm


def _on(dev, case):
    qv, qb, base, norms, bm = case
    return (torch.from_numpy(qv).to(dev), torch.from_numpy(qb.view(np.int32)).to(dev),
            torch.from_numpy(base).to(dev), torch.from_numpy(norms).to(dev),
            torch.from_numpy(bm.view(np.int32)).to(dev))


@pytest.mark.parametrize("pred", [0, 1, 2])
@pytest.mark.parametrize("q,n,k", [(1, 64, 5), (7, 256, 41), (25, 1024, 10),
                                   (3, 20011, 128), (5, 3, 10),
                                   (37, 70001, 10)])
def test_masked_topk_kernel_bitwise_on_tie_grid(cuda, pred, q, n, k):
    args = _on(cuda, _tie_case(np.random.default_rng(q * 7 + n), q, n))
    gd, gi = mk.masked_topk_accum(*args, pred=pred, k=k)
    pd, pi = mk.masked_topk_plain(*args, pred=pred, k=k)
    torch.cuda.synchronize()
    assert torch.equal(gi, pi)
    assert torch.equal(gd, pd)


def test_masked_topk_kernel_empty_query_and_no_match(cuda):
    qv, qb, base, norms, bm = _tie_case(np.random.default_rng(1), 4, 3000)
    qb[0] = 0                       # empty label set
    bm[:, :] = 0
    bm[:5] = 3                      # only five rows carry labels
    args = _on(cuda, (qv, qb, base, norms, bm))
    for pred in (0, 1, 2):
        ids, d = ops.masked_topk(*args, pred=pred, k=10)
        pids, pd = ops.masked_topk(*[a.cpu() for a in args], pred=pred,
                                   k=10)
        assert torch.equal(ids.cpu(), pids)
        assert torch.equal(d.cpu(), pd)


def test_masked_topk_kernel_random_fp32_within_sum_order(cuda):
    rng = np.random.default_rng(0)
    q, n, d, w = 16, 50000, 192, 7
    qv = rng.normal(size=(q, d)).astype(np.float32)
    base = rng.normal(size=(n, d)).astype(np.float32)
    norms = (base.astype(np.float64) ** 2).sum(1).astype(np.float32)
    bm = (rng.random((n, w)) < 0.5).astype(np.uint32) * 5
    qb = np.full((q, w), 4, np.uint32)
    args = _on(cuda, (qv, qb, base, norms, bm))
    gd, gi = mk.masked_topk_accum(*args, pred=2, k=10)
    pd, pi = mk.masked_topk_plain(*args, pred=2, k=10)
    # two fp32 summation orders differ by at most 2·D·u·Σ|terms|
    scale = norms.max() + 2 * np.sqrt(norms.max() * (qv ** 2).sum(1).max())
    tol = 2 * d * 2.0 ** -24 * scale
    assert torch.equal(gi >= 0, pi >= 0) and bool((gi >= 0).all())
    assert torch.allclose(gd, pd, rtol=0, atol=tol)
    # each id carries its own plain score, and ids differ only where the
    # plain scores of both lie within tol
    scores = args[3][None] - 2.0 * (args[0] @ args[2].T)
    got_s = scores.gather(1, gi.long())
    assert bool((torch.abs(got_s - gd) <= tol).all())
    differ = gi != pi
    assert bool((torch.abs(got_s - scores.gather(1, pi.long()))[differ]
                 <= tol).all())
    assert bool(mk._predicate_mask_block(args[4], args[1], 2)
                .gather(1, gi.long()).all())
    assert all(len(set(row)) == len(row) for row in gi.tolist())


@pytest.mark.parametrize("d", [5, 400])
def test_masked_topk_kernel_odd_and_wide_dims(cuda, d):
    """An odd D, and a D whose shared-memory tiles pass 48 KB (the
    kernel then opts in to more)."""
    qv, qb, base, norms, bm = _tie_case(np.random.default_rng(d), 20, 5000,
                                        d=d)
    args = _on(cuda, (qv, qb, base, norms, bm))
    for pred in (0, 1, 2):
        gd, gi = mk.masked_topk_accum(*args, pred=pred, k=16)
        pd, pi = mk.masked_topk_plain(*args, pred=pred, k=16)
        torch.cuda.synchronize()
        assert torch.equal(gi, pi)
        assert torch.equal(gd, pd)


def test_masked_topk_kernel_refuses_too_wide_rows(cuda):
    args = _on(cuda, _tie_case(np.random.default_rng(3), 2, 64, d=1300))
    with pytest.raises(ValueError, match="shared memory"):
        mk.masked_topk_accum(*args, pred=0, k=5)


def test_masked_topk_kernel_counts_launches_and_checks(cuda):
    args = _on(cuda, _tie_case(np.random.default_rng(2), 4, 512))
    before = mk.masked_topk_accum.launches
    mk.masked_topk_accum(*args, pred=1, k=5)
    assert mk.masked_topk_accum.launches == before + 1
    with pytest.raises(ValueError, match="128"):
        mk.masked_topk_accum(*args, pred=1, k=129)
    with pytest.raises(TypeError):
        mk.masked_topk_accum(args[0].bfloat16(), *args[1:], pred=1, k=5)
    with pytest.raises(ValueError, match="contiguous"):
        mk.masked_topk_accum(args[0].T.contiguous().T, *args[1:], pred=1,
                             k=5)
    assert mk.masked_topk_accum.launches == before + 1


@pytest.mark.parametrize("pred", [0, 1, 2])
@pytest.mark.parametrize("q,n", [(1, 50), (7, 131), (40, 100003),
                                 (300, 70000)])
def test_selectivity_kernel_exact(cuda, pred, q, n):
    _, qb, _, _, bm = _tie_case(np.random.default_rng(q + n), q, n, w=3)
    qb[0] = 0                       # empty query: all rows for AND
    qbt = torch.from_numpy(qb.view(np.int32)).to(cuda)
    bmt = torch.from_numpy(bm.view(np.int32)).to(cuda)
    before = bf.selectivity_count.launches
    got = bf.selectivity_count(qbt, bmt, pred=pred)
    want = bf.selectivity_plain(qbt, bmt, pred=pred)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert bf.selectivity_count.launches == before + 1
