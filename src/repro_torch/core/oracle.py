"""Oracle router (paper §6.3): per query, the method achieving the highest
actual recall — the theoretical upper bound the ML router chases."""

from __future__ import annotations

import numpy as np

from repro_torch.core.training import Collection, METHOD_ORDER


def oracle_recall(coll: Collection, ds: str, pt: int,
                  methods=METHOD_ORDER) -> np.ndarray:
    cell = coll.cells[(ds, int(pt))]
    stacked = np.stack([cell.recall[m] for m in methods], axis=1)   # [Q, M]
    return stacked.max(axis=1)


def oracle_choice(coll: Collection, ds: str, pt: int,
                  methods=METHOD_ORDER) -> np.ndarray:
    cell = coll.cells[(ds, int(pt))]
    stacked = np.stack([cell.recall[m] for m in methods], axis=1)
    return stacked.argmax(axis=1)
