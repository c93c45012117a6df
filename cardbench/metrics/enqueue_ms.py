"""Host ms the client spends enqueuing one call, without a synchronise
(median over the calls of every rank)."""

from cardbench.roofline import median_of


def read(records, context):
    return median_of(records, "enqueue_ms")
