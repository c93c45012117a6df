"""The whole call's share of the card's peak, in %: the base-field products
of the reference's algorithm for the call's pairs (and, for a product of
pairings, its Fq12 products) at the published 32-bit multiply-add rate, over
the call's device time (the events around the whole call, median over calls).
It bounds the stage rooflines whatever kernels implement the stages."""

from cardbench.roofline import FQ12_MUL_PRODUCTS, bound_ms, median_span, products_per_pair, share


def read(records, context):
    pairs = context["pairs"]
    products = sum(products_per_pair().values()) * pairs
    if context["output"] == "gt_product":
        products += (pairs - 1 + context["ranks"] - 1) * FQ12_MUL_PRODUCTS
    return share(bound_ms(products, 0, context["card"]), median_span(records, "call"))
