"""search_ms: the mean per batch of the program's own `search_s` timing
(the methods' execution, ending when their ids are on the host), over
the window's unprofiled batches."""

UNIT = "ms"


def read(run):
    vals = [t["search_s"] for t in run.timings if "search_s" in t]
    return sum(vals) / len(vals) * 1e3 if vals else None
