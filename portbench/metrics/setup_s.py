"""setup_s: from the start of the process to the first timed batch:
drawing the data and queries, building the program's dataset, handle
and indexes, the kernels' build where it has not run yet in this
checkout, and the warm-up."""

UNIT = "s"


def read(run):
    return run.setup_s
