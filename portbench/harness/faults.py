"""Faults planted under the timed path, for the checks that the
comparison catches them: half of each batch left out (its queries get
no answer), and an answer altered where it is produced (each query's
first id moved to the next row). Planted in the program's
`FilteredIndex.run_method`, which every method's search of both
entries goes through, or applied to answers the reference gives in the
program's place."""

from __future__ import annotations

import numpy as np

FAULTS = ("half", "altered")


def apply(fault: str, ids: np.ndarray, dists: np.ndarray, n_rows: int):
    """The answers (ids, distances or scores) with `fault` applied."""
    ids, dists = ids.copy(), dists.copy()
    if fault == "half":
        h = ids.shape[0] // 2
        ids[h:] = -1
        dists[h:] = np.inf
    elif fault == "altered":
        ok = ids[:, 0] >= 0
        ids[ok, 0] = (ids[ok, 0] + 1) % n_rows
    else:
        raise ValueError(f"unknown fault {fault!r}")
    return ids, dists


def plant(fault: str):
    """Plant `fault` in the program; returns a function that takes it
    out again."""
    from repro_torch.ann.index import FilteredIndex

    orig = FilteredIndex.run_method

    def run_method(self, method, setting, batch, **kw):
        ids, raw = orig(self, method, setting, batch, **kw)
        return apply(fault, ids, raw, self.ds.n)

    FilteredIndex.run_method = run_method

    def remove():
        FilteredIndex.run_method = orig

    return remove
