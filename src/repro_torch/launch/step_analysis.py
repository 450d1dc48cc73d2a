"""One rank's program of a step, counted as it runs: the port's
counterpart of the JAX package's `launch/hlo_analysis.py`, which reads
the same three roofline ingredients from compiled, partitioned HLO.

  * dot FLOPs — 2·K·|out| for every matmul-type op (`mm`, `bmm`,
    `addmm`, `baddbmm`, `mv`, `dot`; `matmul`, `einsum` and `linear`
    reach these) on the rank's *local* shapes;
  * bytes — the output bytes of every op that is neither a view nor
    bookkeeping (allocations, autograd wrappers, waits, scalar reads).
    Eager PyTorch fuses nothing, so every intermediate counts: an upper
    bound on the traffic XLA counts at its fusion boundaries;
  * collective bytes — the output bytes of each collective
    (`_c10d_functional` and friends), by kind: all-reduce, all-gather,
    reduce-scatter, all-to-all, collective-permute.

How. `StepCounter` is a `TorchDispatchMode` that steps aside for DTensor
arguments, so DTensor's dispatch runs and the mode sees the local ops it
runs on this rank's shards and the collectives it issues; the step runs
on whatever tensors it is given (the dry run gives it `meta` stand-ins,
so nothing is computed and nothing is allocated). DTensor's sharding
propagation also runs each new op once on fake tensors of the *global*
shapes to learn its output's metadata; that is not the rank's work and
is not counted.

Repeats. A loop written with `models.common.uniform_range` (every
iteration the same operations on the same shapes: the sLSTM's time
steps, forward and backward) asks the active `StepCounter` for its
iterations; with `repeats` on it runs its first iteration only, and what
that iteration does counts trip-count times, as the HLO analyser
multiplies a `while` body by its trip count. Loops
that autograd records through (layers, microbatches) cannot be cut that
way; `fit_counts` instead extrapolates whole counts taken at two or
three trip counts, exactly where the count is affine (or bilinear) in
them. `tests/test_torch_step_analysis.py` holds both against full traces.

`StepSummary.dot_by_op` splits the dot FLOPs by op and local operand
shapes, to find which product moves a count (between torch versions, or
against the reference's HLO).
"""

from __future__ import annotations

import contextlib
import dataclasses
from collections import defaultdict
from fractions import Fraction

import torch
from torch.utils._python_dispatch import TorchDispatchMode

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")

# name fragments of the collective ops, by kind
_COLL_NAMES = (("all_reduce", "all-reduce"), ("allreduce", "all-reduce"),
               ("all_gather", "all-gather"), ("allgather", "all-gather"),
               ("reduce_scatter", "reduce-scatter"),
               ("all_to_all", "all-to-all"), ("alltoall", "all-to-all"),
               ("send", "collective-permute"), ("recv", "collective-permute"),
               ("permute", "collective-permute"))
_COLL_NAMESPACES = ("_c10d_functional", "_c10d_functional_autograd", "c10d")

# ops with no traffic of their own
_NO_TRAFFIC = {
    "empty", "empty_strided", "empty_like", "new_empty",
    "new_empty_strided", "_unsafe_view", "detach", "alias", "lift_fresh",
    "_local_scalar_dense", "wait_tensor", "_wrap_tensor_autograd",
    "set_", "resize_", "sym_size", "sym_stride", "sym_numel",
    "sym_storage_offset", "is_same_size", "_has_same_storage_numel",
    "record_stream", "_reshape_alias"}


def _numel(shape) -> int:
    n = 1
    for d in shape:
        n *= int(d)
    return n


def _operands(name: str, args) -> tuple:
    """The two operands of a matmul-type op (after addmm's bias)."""
    return args[1:3] if name in ("addmm", "baddbmm") else args[:2]


def _mm(a, b, *_, **__) -> int:
    """mm [m, k] x [k, n] and bmm [B, m, k] x [B, k, n]: 2·|a|·n."""
    return 2 * _numel(a.shape) * b.shape[-1]


def _addmm(_c, a, b, *_, **__) -> int:
    return _mm(a, b)


def _mv(a, _v, *_, **__) -> int:
    """mv [m, k] x [k] and dot [k] x [k]: 2·|a|."""
    return 2 * _numel(a.shape)


# 2·K·|out| of each matmul-type op, from its arguments
_FLOPS = {"mm": _mm, "bmm": _mm, "addmm": _addmm, "baddbmm": _addmm,
          "mv": _mv, "dot": _mv}


@dataclasses.dataclass
class StepSummary:
    """The reference `HLOSummary`'s fields, per rank; `n_ops`, the local
    ops counted (repeats multiplied); `dot_by_op`, the dot FLOPs by
    "op [a's shape] [b's shape]"."""
    dot_flops: int = 0
    hbm_bytes: int = 0
    coll_bytes: int = 0
    coll_by_kind: dict = dataclasses.field(
        default_factory=lambda: defaultdict(int))
    n_ops: int = 0
    dot_by_op: dict = dataclasses.field(
        default_factory=lambda: defaultdict(int))

    def as_dict(self) -> dict:
        return {"dot_flops": self.dot_flops, "hbm_bytes": self.hbm_bytes,
                "coll_bytes": self.coll_bytes,
                "coll_by_kind": {k: self.coll_by_kind.get(k, 0)
                                 for k in COLLECTIVES},
                "n_ops": self.n_ops,
                "dot_by_op": dict(sorted(self.dot_by_op.items()))}


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for y in x:
            yield from _tensors(y)


def _is_view(func) -> bool:
    if getattr(func, "is_view", False):
        return True
    return any(r.alias_info is not None and not r.alias_info.is_write
               for r in func._schema.returns)


def _coll_kind(func) -> str | None:
    if func.namespace not in _COLL_NAMESPACES:
        return None
    name = func._schema.name.split("::")[-1]
    for frag, kind in _COLL_NAMES:
        if frag in name:
            return kind
    return None


class StepCounter(TorchDispatchMode):
    """Counts the local ops run under it (see the module docstring) into
    `self.summary`; with `repeats`, a `uniform_range` loop run under it
    runs one iteration, counted trip-count times (`self.mult`)."""

    def __init__(self, repeats: bool = True):
        super().__init__()
        self.summary = StepSummary()
        self.repeats = repeats
        self.mult = 1

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        name = func._schema.name.split("::")[-1]
        if name in _NO_TRAFFIC or _is_view(func):
            return out
        s, m = self.summary, self.mult
        nbytes = sum(t.numel() * t.element_size() for t in _tensors(out))
        s.n_ops += m
        s.hbm_bytes += m * nbytes
        kind = _coll_kind(func)
        if kind is not None:
            s.coll_bytes += m * nbytes
            s.coll_by_kind[kind] += m * nbytes
        flops = _FLOPS.get(name) if func.namespace == "aten" else None
        if flops is not None:
            n = m * flops(*args, **kwargs)
            s.dot_flops += n
            a, b = _operands(name, args)
            s.dot_by_op[f"{name} {list(a.shape)} {list(b.shape)}"] += n
        return out

    def uniform_range(self, n: int):
        """The iterations of `models.common.uniform_range(n)` under this
        counter: with `repeats`, the first, counted n times."""
        if not self.repeats:
            yield from range(n)
            return
        if n <= 0:
            return
        self.mult *= n
        try:
            yield 0
        finally:
            self.mult //= n


@contextlib.contextmanager
def counting(*, repeats: bool = True):
    """A `StepCounter` over the block. DTensor's sharding propagation
    runs outside the counter: it is rerouted around it by wrapping
    `ShardingPropagator._propagate_tensor_meta_non_cached` (a private
    method of torch's DTensor, restored on exit)."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    from torch.utils._python_dispatch import _disable_current_modes

    counter = StepCounter(repeats)
    orig = ShardingPropagator._propagate_tensor_meta_non_cached

    def quiet(self, op_schema):
        with _disable_current_modes():
            return orig(self, op_schema)

    ShardingPropagator._propagate_tensor_meta_non_cached = quiet
    try:
        with counter:
            yield counter
    finally:
        ShardingPropagator._propagate_tensor_meta_non_cached = orig


def analyze(fn, *args, repeats: bool = True, **kwargs):
    """(fn(*args, **kwargs), the `StepSummary` of what it ran)."""
    with counting(repeats=repeats) as counter:
        out = fn(*args, **kwargs)
    return out, counter.summary


def fit_counts(counts: dict, target: tuple) -> StepSummary:
    """The count at trip counts `target` from counts taken at other trip
    counts, for a program whose count is affine in each trip count and
    at most bilinear in two of them (a loop of microbatches, each over
    the layers). `counts` maps trip-count tuples to `StepSummary`s: two
    points along one variable ((a,), (b,)), or the four corners of two
    ((a, c), (a, d), (b, c), (b, d)). Exact: the fit is done in
    integers."""
    keys = sorted(counts)
    if len(target) == 1:
        (a,), (b,) = keys
        t = target[0]
        w_b = Fraction(t - a, b - a)
        return _combine({keys[0]: 1 - w_b, keys[1]: w_b}, counts)
    (a, c), (a2, d), (b, c2), (b2, d2) = keys
    assert a == a2 and b == b2 and c == c2 and d == d2, keys
    u = Fraction(target[0] - a, b - a)
    v = Fraction(target[1] - c, d - c)
    return _combine({(a, c): (1 - u) * (1 - v), (a, d): (1 - u) * v,
                     (b, c): u * (1 - v), (b, d): u * v}, counts)


def _combine(weights: dict, counts: dict) -> StepSummary:
    """Σ weight · count, each field an exact integer."""
    def field(get):
        total = sum(w * get(counts[k]) for k, w in weights.items())
        if total.denominator != 1:
            raise ValueError(f"the fitted count {total} is not an integer: "
                             f"the program is not affine in its trip "
                             f"counts")
        return int(total)

    kinds = {n: field(lambda s, n=n: s.coll_by_kind.get(n, 0))
             for n in COLLECTIVES}
    ops = {op: field(lambda s, op=op: s.dot_by_op.get(op, 0))
           for op in {op for s in counts.values() for op in s.dot_by_op}}
    return StepSummary(field(lambda s: s.dot_flops),
                       field(lambda s: s.hbm_bytes),
                       field(lambda s: s.coll_bytes),
                       defaultdict(int, kinds), field(lambda s: s.n_ops),
                       defaultdict(int, {k: v for k, v in ops.items() if v}))
