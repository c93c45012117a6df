"""Launches of the package's kernels in one call: its launch counter,
`bn_tpu_torch.ops.build.COUNTS`, read before and after every call (median
over the calls of every rank; the count is exact)."""

from cardbench.roofline import median_of

COUNTERS = {"launches": "bn_tpu_torch.ops.build.COUNTS"}


def read(records, context):
    return median_of(records, "launches")
