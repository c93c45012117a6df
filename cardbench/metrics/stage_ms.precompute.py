"""Device ms of the precompute stage in one call (median over calls): CUDA events
around every call of `bn_tpu_torch.ate.precompute`."""

from cardbench.roofline import median_span

SPANS = {"precompute": "bn_tpu_torch.ate.precompute"}


def read(records, context):
    return median_span(records, "precompute")
