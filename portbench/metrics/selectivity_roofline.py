"""selectivity_roofline: the `selectivity` op's share of its roofline,
counted over the dataset's distinct label sets (see
`harness.rooflines`)."""

from portbench.harness import rooflines
from portbench.metrics._roofline import share

UNIT = "%"
OP = "selectivity"


def record(args, kwargs, out):
    """(Q, W, the rows' bitmaps) of one call
    `selectivity(qbms, bitmaps, ...)`."""
    qbms, bitmaps = args[0], args[1]
    return qbms.shape[0], qbms.shape[1], bitmaps


def least_seconds(records, peaks):
    if not peaks:
        return None
    tables = rooflines.GroupTables()
    s = 0.0
    for q, w, bitmaps in records:
        g = tables.of(bitmaps)[0].shape[0]
        ops, nbytes = rooflines.selectivity_counts(q, w, g)
        s += rooflines.least_seconds(ops, nbytes, peaks["int32_ops"],
                                     peaks["hbm_bytes_s"])
    return s


def read(run):
    return share(run, "selectivity_roofline", OP)
