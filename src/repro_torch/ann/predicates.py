"""Predicate evaluation over packed label bitmaps.

Three predicate types (paper §2.1):
  * Equality   : L_i == L_q
  * AND        : L_q ⊆ L_i   (containment)
  * OR         : L_q ∩ L_i ≠ ∅ (overlap)

Torch bitmaps are `torch.int32` views of the packed uint32 words (the
same bits): the predicates only use `&`, `==` and `!= 0`, which agree
on both interpretations.
"""

from __future__ import annotations

import enum

import numpy as np
import torch


class Predicate(enum.IntEnum):
    EQUALITY = 0
    AND = 1
    OR = 2

    @classmethod
    def parse(cls, s: "str | Predicate") -> "Predicate":
        if isinstance(s, Predicate):
            return s
        return {
            "equality": cls.EQUALITY, "eq": cls.EQUALITY,
            "and": cls.AND, "containment": cls.AND,
            "or": cls.OR, "overlap": cls.OR,
        }[str(s).lower()]


PREDICATES = (Predicate.EQUALITY, Predicate.AND, Predicate.OR)


def eval_predicate(base_bm: torch.Tensor, query_bm: torch.Tensor,
                   pred: Predicate) -> torch.Tensor:
    """Evaluate `pred` between every base bitmap and the query bitmap(s).

    base_bm : int32 [..., W]
    query_bm: int32 broadcastable to base_bm (e.g. [W] or [Q, 1, W])
    returns : bool  [...] (word axis reduced)

    Word by word, so no broadcast [..., W] temporary is made: with base
    [N, W] and queries [Q, 1, W] the largest temporary is the [Q, N]
    result.
    """
    pred = Predicate(pred)
    shape = torch.broadcast_shapes(base_bm.shape[:-1], query_bm.shape[:-1])
    acc = torch.full(shape, pred != Predicate.OR, dtype=torch.bool,
                     device=base_bm.device)
    for i in range(base_bm.shape[-1]):
        b, q = base_bm[..., i], query_bm[..., i]
        if pred == Predicate.EQUALITY:
            acc &= b == q
        elif pred == Predicate.AND:
            acc &= (b & q) == q
        else:
            acc |= (b & q) != 0
    return acc


def eval_predicate_np(base_bm, query_bm, pred: Predicate):
    """Host (numpy) twin of `eval_predicate` for offline index builds."""
    pred = Predicate(pred)
    if pred == Predicate.EQUALITY:
        return np.all(base_bm == query_bm, axis=-1)
    if pred == Predicate.AND:
        return np.all((base_bm & query_bm) == query_bm, axis=-1)
    if pred == Predicate.OR:
        return np.any((base_bm & query_bm) != 0, axis=-1)
    raise ValueError(pred)
