"""Device ms of the NCCL kernels in one call (the exchange between the
ranks, its wait for the slowest rank included): the median NCCL kernel of the
profiled stretch times their number a call, mean over the ranks."""

from cardbench.roofline import profile_mean


def read(records, context):
    found = [r["profile"]["nccl"] for r in records if r.get("profile") and r["profile"].get("nccl")]
    calls = profile_mean(records, "calls")
    if not found or not calls:
        return None
    return 1e3 * sum(n["median_s"] * n["kernels"] / calls for n in found) / len(found)
