"""Shared utilities of the port: artifact paths and a timer.

`artifacts_dir` resolves as the JAX package's does — under
``$REPRO_ARTIFACTS`` when it is set, else `artifacts/` at the root of
the checkout — so both packages write their serving post-mortems to one
place.

The JAX package's `enable_compilation_cache` configures XLA's persistent
compilation cache and has no counterpart here: the port compiles its
CUDA kernels with nvcc once per checkout, and `kernels/_build.py` keeps
the built library under `build/repro_torch/` and reuses it while the
sources are unchanged, which is the role XLA's cache plays there.
"""

from __future__ import annotations

import contextlib
import os
import time

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def artifacts_dir(*sub: str) -> str:
    """`artifacts/<sub...>` (or ``$REPRO_ARTIFACTS/<sub...>``), created
    if missing."""
    d = os.path.join(os.environ.get("REPRO_ARTIFACTS",
                                    os.path.join(_REPO_ROOT, "artifacts")),
                     *sub)
    os.makedirs(d, exist_ok=True)
    return d


@contextlib.contextmanager
def timer():
    """`with timer() as t: ...; t()` -> elapsed seconds (0.0 inside the
    block, the block's wall time after it). Host clock only: around work
    on the card, synchronise before the block ends."""
    t0 = time.perf_counter()
    elapsed = [0.0]
    yield lambda: elapsed[0]
    elapsed[0] = time.perf_counter() - t0
