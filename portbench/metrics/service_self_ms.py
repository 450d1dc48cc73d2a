"""service_self_ms: the mean per batch of the service's own time, the
`search` span less its `route` span and its `group` spans (the
`execute` span's bookkeeping, key resolution and result assembly).
Read from the program's tracer over the window's unprofiled batches."""

UNIT = "ms"


def read(run):
    roots = [r for r in (run.spans or ()) if r.name == "search"]
    if not roots:
        return None
    total = 0.0
    for r in roots:
        inner = sum(s.duration_s for s in r.walk()
                    if s.name in ("route", "group"))
        total += r.duration_s - inner
    return total / len(roots) * 1e3
