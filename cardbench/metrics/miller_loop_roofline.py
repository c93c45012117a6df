"""The miller_loop stage's least time over its measured time, in %: the work of
the reference's algorithm for the call's pairs (cardbench/roofline.py) at the
card's published peak, over stage_ms.miller_loop."""

from cardbench.roofline import median_span, share, stage_bound_ms

SPANS = {"miller_loop": "bn_tpu_torch.ate.miller_loop"}


def read(records, context):
    return share(stage_bound_ms("miller_loop", context["pairs"], context["card"]), median_span(records, "miller_loop"))
