"""The least time the card could take for a stage's work, and the readings
the per-layer readers share.

Work is counted on the reference's algorithm, never on the package's kernels,
so fusing or splitting kernels leaves it unchanged: the base-field products of
each stage of one pairing (reference/work.json, recounted by
reference.field.count_work), each a Montgomery product of 8 32-bit words, 136
word products of 32 x 32 -> 64 bits (2 * 8^2 + 8), each two 32-bit
multiply-adds (low and high half).  Bytes are the stage's inputs read once
and outputs written once, 32 bytes a base-field element.  The peaks are the
published ones (peaks.json) at the card's maximum SM clock.
"""

from __future__ import annotations

import json
import statistics
from pathlib import Path

HERE = Path(__file__).resolve().parent
MAD_PER_PRODUCT = 136 * 2
FQ_BYTES = 32
FQ12_MUL_PRODUCTS = 54  # an Fq12 product of the reference (3 Fq6 of 6 Fq2 of 3)

# base-field elements a stage reads and writes, per pair
STAGE_ELEMENTS = {
    "to_affine": (3 + 6) + (2 + 4),  # Jacobian G1 and G2 in, affine out
    "precompute": 4 + 102 * 3 * 2,  # affine G2 in, 102 lines of three Fq2 out
    "miller_loop": (102 * 3 * 2 + 2) + 12,  # lines and affine G1 in, Fq12 out
    "final_exp": 12 + 12,
}


def products_per_pair() -> dict:
    return json.loads((HERE / "reference" / "work.json").read_text())["products_per_pair"]


def peak(card: dict):
    """(32-bit multiply-adds per second, bytes per second) of the card, or
    None where its kind or clock is not known."""
    table = json.loads((HERE / "peaks.json").read_text())
    spec = table.get(card.get("kind"))
    if spec is None or not card.get("clock_max_mhz"):
        return None
    return spec["sms"] * spec["int32_mad_per_clock_per_sm"] * card["clock_max_mhz"] * 1e6, spec["hbm_bytes_per_s"]


def bound_ms(products: float, elements: float, card: dict):
    """Least ms for that many base-field products and elements moved."""
    rates = peak(card)
    if rates is None:
        return None
    mads, bw = rates
    return max(products * MAD_PER_PRODUCT / mads, elements * FQ_BYTES / bw) * 1e3


def stage_bound_ms(stage: str, pairs: int, card: dict):
    return bound_ms(products_per_pair()[stage] * pairs, STAGE_ELEMENTS[stage] * pairs, card)


def median_span(records: list, name: str):
    """Median over the calls of every rank of a span's ms, or None."""
    values = [v for r in records for v in r.get("spans_ms", {}).get(name, [])]
    return statistics.median(values) if values else None


def median_of(records: list, key: str):
    values = [v for r in records for v in (r.get(key) or []) if v is not None]
    return statistics.median(values) if values else None


def profile_mean(records: list, key: str):
    """Mean over the ranks of one number of the profiled stretch, or None."""
    values = [r["profile"][key] for r in records if r.get("profile") and r["profile"].get(key) is not None]
    return sum(values) / len(values) if values else None


def share(bound, measured):
    """100 bound / measured, or None where either is missing."""
    if bound is None or not measured:
        return None
    return 100.0 * bound / measured
