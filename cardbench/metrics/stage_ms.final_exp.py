"""Device ms of the final_exp stage in one call (median over calls): CUDA events
around every call of `bn_tpu_torch.fields.tower.final_exponentiation`."""

from cardbench.roofline import median_span

SPANS = {"final_exp": "bn_tpu_torch.fields.tower.final_exponentiation"}


def read(records, context):
    return median_span(records, "final_exp")
