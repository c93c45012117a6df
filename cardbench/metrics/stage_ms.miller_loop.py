"""Device ms of the miller_loop stage in one call (median over calls): CUDA events
around every call of `bn_tpu_torch.ate.miller_loop`."""

from cardbench.roofline import median_span

SPANS = {"miller_loop": "bn_tpu_torch.ate.miller_loop"}


def read(records, context):
    return median_span(records, "miller_loop")
