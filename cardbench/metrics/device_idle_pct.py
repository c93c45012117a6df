"""Share of the profiled stretch in which no kernel ran on the card, in %
(mean over the ranks)."""

from cardbench.roofline import profile_mean


def read(records, context):
    busy, window = profile_mean(records, "busy_s"), profile_mean(records, "window_s")
    if busy is None or not window:
        return None
    return 100.0 * (1.0 - busy / window)
