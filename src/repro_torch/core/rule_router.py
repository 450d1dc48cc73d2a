"""RuleRouter — paper Algorithm 1, verbatim decision tree over
(predicate type, LID_mean, card(V)).

The paper's thresholds (LID_mean > 100, card(V) < 100) were calibrated on
full-scale embeddings; our scaled synthetic pool spans a smaller LID range,
so the thresholds are constructor parameters with defaults chosen to
separate the same datasets the paper's thresholds separate (ytb_video is
the high-LID outlier; LAION/tripclick are the low-cardinality ones). The
*structure* of the tree is unchanged.
"""

from __future__ import annotations

import dataclasses

from repro_torch.ann.predicates import Predicate


@dataclasses.dataclass(frozen=True)
class RuleRouter:
    lid_hi: float = 40.0      # paper: 100 (full-scale embeddings)
    card_lo: float = 100.0    # paper: 100

    def route(self, pred: Predicate, lid_mean: float, card: float) -> str:
        pred = Predicate(pred)
        if pred == Predicate.EQUALITY:
            return "labelnav"                      # UNG
        if pred == Predicate.AND:
            if lid_mean > self.lid_hi or card < self.card_lo:
                return "labelnav"                  # UNG
            return "sieve"                         # SIEVE
        # OR
        if lid_mean > self.lid_hi:
            return "labelnav"                      # UNG
        return "postfilter"                        # Post-filter
