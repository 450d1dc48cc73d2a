"""The share of an op's roofline: the least seconds its profiled calls
need on their inputs (`harness.rooflines`) over the device seconds
inside its `record_function` ranges. None where the op made no call in
the profiled stretch or the card has no peaks in the table."""

from portbench.harness.probes import OP_RANGE


def share(run, metric, op):
    """`metric`'s share: `run.least_s[metric]` over the device seconds in
    `op`'s ranges."""
    if run.profile is None:
        return None
    least = run.least_s.get(metric)
    spent = run.profile.range_device_s.get(OP_RANGE + op, 0.0)
    if not least or spent <= 0:
        return None
    return 100.0 * least / spent
