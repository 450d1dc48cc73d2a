"""Shared utilities of the port: artifact paths.

`artifacts_dir` resolves as the JAX package's does — under
``$REPRO_ARTIFACTS`` when it is set, else `artifacts/` at the root of
the checkout — so both packages write their serving post-mortems to one
place."""

from __future__ import annotations

import os

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
