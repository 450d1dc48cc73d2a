"""qps: queries completed in the window over the window's seconds (the
host clock; every batch's ids are on the host when it completes)."""

UNIT = "queries/s"


def read(run):
    return sum(run.batch_queries) / run.window_s if run.batch_queries \
        else None
