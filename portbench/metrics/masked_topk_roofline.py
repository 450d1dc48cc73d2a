"""masked_topk_roofline: the `masked_topk` op's share of its roofline,
counted over passing (query, row) pairs and the group table (see
`harness.rooflines`)."""

from portbench.harness import rooflines
from portbench.metrics._roofline import share

UNIT = "%"
OP = "masked_topk"


def record(args, kwargs, out):
    """(query words, the rows' bitmaps, predicate, D, k) of one call
    `masked_topk(qvecs, qbms, base, norms, bitmaps, pred=, k=)`."""
    qvecs, qbms, _, _, bitmaps = args[:5]
    return (qbms, bitmaps, int(kwargs["pred"]), qvecs.shape[1],
            int(kwargs["k"]))


def least_seconds(records, peaks):
    if not peaks:
        return None
    tables = rooflines.GroupTables()
    s = 0.0
    for qbms, bitmaps, pred, d, k in records:
        gbm, sizes = tables.of(bitmaps)
        flops, nbytes = rooflines.masked_topk_counts(gbm, sizes, qbms, pred,
                                                     d, k)
        s += rooflines.least_seconds(flops, nbytes, peaks["fp32_flops"],
                                     peaks["hbm_bytes_s"])
    return s


def read(run):
    return share(run, "masked_topk_roofline", OP)
