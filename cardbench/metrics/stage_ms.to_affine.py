"""Device ms of the to_affine stage in one call (median over calls): CUDA events
around every call of `bn_tpu_torch.curve.to_affine`."""

from cardbench.roofline import median_span

SPANS = {"to_affine": "bn_tpu_torch.curve.to_affine"}


def read(records, context):
    return median_span(records, "to_affine")
