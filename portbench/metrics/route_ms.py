"""route_ms: the mean per batch of the service's `route` span (the
features with their selectivity counts, the MLPs, Algorithm 2). Read
from the program's tracer over the window's unprofiled batches."""

UNIT = "ms"


def read(run):
    spans = [s for r in (run.spans or ()) for s in r.walk()
             if s.name == "route"]
    if not spans:
        return None
    return sum(s.duration_s for s in spans) / len(spans) * 1e3
