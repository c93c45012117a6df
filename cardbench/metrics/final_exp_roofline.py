"""The final_exp stage's least time over its measured time, in %: the work of
the reference's algorithm for the call's pairs (cardbench/roofline.py) at the
card's published peak, over stage_ms.final_exp."""

from cardbench.roofline import median_span, share, stage_bound_ms

SPANS = {"final_exp": "bn_tpu_torch.fields.tower.final_exponentiation"}


def read(records, context):
    return share(stage_bound_ms("final_exp", context["pairs"], context["card"]), median_span(records, "final_exp"))
