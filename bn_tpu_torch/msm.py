"""Pippenger multi-scalar multiplication over G1: sum_i s_i * P_i for large
point sets.

Counterpart of the JAX package's msm.py, with the same schedule and the same
order of group operations, so the Jacobian result has the same limbs.

Bucket accumulation is a fixed-length gather schedule rather than
scatter-adds: the host bins point indices per (window, bucket) with numpy,
pads every bucket's list to the largest occupancy R (capped; the overflow
goes to window-local spill rounds), and the device replays R rounds of
`buckets += gather(points, idx[:, r])` with all windows x buckets side by
side in one batch: one `torch.index_select` per coordinate and one
`point_add` launch of w * 2^c lanes a round.  Buckets are weighted by the
suffix-sum identity sum_j j*A_j = sum_j suffix_j, computed by two log-depth
shift-scans over the bucket axis with the point-add monoid (c `point_add`
launches each); windows combine by Horner doubling at batch 1.

The host schedule (numpy) is the JAX package's, unchanged.  The device side
is plain loops of curve.add / curve.double; tensors are created on the card
unless the caller names another device.
"""

from __future__ import annotations

import numpy as np
import torch

from . import curve
from . import oracle as O
from . import params as P
from .convert import default_device
from .fields import fp

DEFAULT_C = 16  # window size in bits for 2^20-class inputs
# Window-size balance: the TOP window only ranges over the scalar's leftover
# high bits, and its bucket load is n / 2^(256 mod' c) — for c=13 the 20th
# window spans just 7 effective bits of the 254-bit Fr scalars, so its 128
# live buckets each hold ~n/128 digits and the occupancy-capped schedule
# degenerates into ~n/(128*r_cap) serial spill rounds (measured: 53 rounds,
# 223 s at n=2^20).  c=16 divides 256 exactly; the top window then spans the
# scalars' remaining ~13.8 bits and stays load-balanced with the rest.


def auto_c(n: int) -> int:
    """Window size matched to the input size.

    A fixed c=16 sizes the bucket accumulator at 16*2^16 ≈ 1M lanes
    (~200 MB across 3 Jacobian coords) and runs the 16-round shift-scan
    bucket reduce over all of them — ~6x the memory/reduce work a small
    MSM needs.  Scale c with n (classic Pippenger balance: accumulation
    ~n*256/c adds vs reduction ~2^c adds per window), keeping the
    even-divisor-of-256 choices that leave the top window load-balanced."""
    if n >= 1 << 19:
        return 16
    for c in (13, 11, 9, 7, 5):
        if n >= 1 << (c + 3):
            return c
    return 4


# ---------------------------------------------------------------------------
# host-side schedule construction
# ---------------------------------------------------------------------------


def scalars_to_u16(scalars) -> np.ndarray:
    """Pack canonical scalars into a (N, 16) uint16 limb matrix."""
    buf = b"".join(
        (int(s) % P.R_SCALAR).to_bytes(32, "little") for s in scalars
    )
    return np.frombuffer(buf, dtype="<u2").reshape(len(scalars), 16).copy()


def extract_digits(sc16: np.ndarray, c: int) -> np.ndarray:
    """(N, 16) uint16 scalars -> (w, N) int32 window digits."""
    n = sc16.shape[0]
    nbits = 256
    w = (nbits + c - 1) // c
    bits = np.unpackbits(
        sc16.view(np.uint8).reshape(n, 32), axis=1, bitorder="little"
    )  # (N, 256) little-endian bits
    digits = np.zeros((w, n), dtype=np.int32)
    for k in range(w):
        lo = k * c
        hi = min(lo + c, nbits)
        seg = bits[:, lo:hi].astype(np.int32)
        weights = (1 << np.arange(hi - lo)).astype(np.int32)
        digits[k] = seg @ weights
    return digits


def build_schedule(digits: np.ndarray, c: int, r_cap: int | None = None):
    """Per-(window, bucket) padded index lists.

    Returns idx (w, 2^c, R) int32 where entry N means 'no point' (maps to an
    appended point at infinity), with R the max bucket occupancy (capped at
    r_cap when given — use build_schedule_capped to recover the spill).
    """
    idx, _, _ = build_schedule_capped(digits, c, r_cap)
    return idx


def build_schedule_capped(digits: np.ndarray, c: int, r_cap: int | None):
    """Like build_schedule but with a bounded R: bucket entries beyond
    r_cap are NOT scheduled; instead they are returned as a leftover digit
    matrix (same shape as `digits`, zero where scheduled) for a further
    spill round.  Bounds device memory against skewed /
    adversarial scalar distributions (a uniform load never spills: R
    concentrates around N/2^c).

    Returns (idx, leftover_digits, has_leftover)."""
    w, n = digits.shape
    nb = 1 << c
    counts = np.zeros((w, nb), dtype=np.int64)
    for k in range(w):
        counts[k] = np.bincount(digits[k], minlength=nb)
    r_true = int(counts[:, 1:].max()) if nb > 1 else 0  # bucket 0 is dead weight
    r_max = max(1, r_true if r_cap is None else min(r_true, r_cap))
    idx = np.full((w, nb, r_max), n, dtype=np.int32)
    leftover = np.zeros_like(digits)
    for k in range(w):
        order = np.argsort(digits[k], kind="stable")
        d_sorted = digits[k][order]
        offsets = np.zeros(nb, dtype=np.int64)
        offsets[1:] = np.cumsum(counts[k])[:-1]
        rank = np.arange(n, dtype=np.int64) - offsets[d_sorted]
        keep = (d_sorted != 0) & (rank < r_max)
        idx[k, d_sorted[keep], rank[keep]] = order[keep].astype(np.int32)
        spill = (d_sorted != 0) & (rank >= r_max)
        if spill.any():
            leftover[k, order[spill]] = d_sorted[spill]
    return idx, leftover, bool(leftover.any())


def default_r_cap(n: int, c: int) -> int:
    """Bucket-occupancy cap: mean + 6 sigma of the uniform (Poisson-ish)
    load, so uniform inputs virtually never spill while adversarial ones
    are processed in bounded-size rounds."""
    mean = max(1.0, n / float(1 << c))
    return int(mean + 6.0 * mean**0.5 + 16)


# ---------------------------------------------------------------------------
# device-side accumulation
# ---------------------------------------------------------------------------


def _accumulate_rounds(px, py, pz, idx, acc):
    """Replay the gather schedule: acc (a batch of w*nb Jacobian points, or
    one window's nb) += R rounds of gathered points.  idx: (w, nb, R) integer
    tensor on the points' device."""
    spec = curve.g1_spec()
    w, nb, r_rounds = idx.shape
    by_round = idx.reshape(w * nb, r_rounds).t().contiguous()
    for ids in by_round:
        gathered = tuple(torch.index_select(t, -1, ids) for t in (px, py, pz))
        acc = curve.add(spec, acc, gathered)
    return acc


def _accumulate_window(px, py, pz, idx, acc, w0: int, nb: int):
    """Accumulate one spill round into a single window's 2^c lanes of acc,
    which is updated in place (and returned)."""
    start = w0 * nb
    sub = tuple(t[..., start : start + nb] for t in acc)
    sub = _accumulate_rounds(px, py, pz, idx, sub)
    for t, s in zip(acc, sub):
        t[..., start : start + nb] = s
    return acc


def _shift_scan(spec, pt, nb: int):
    """Inclusive prefix scan over the last axis with the point-add monoid by
    log-depth shifts; points at infinity (the monoid's identity) shift in."""
    x, y, z = pt
    zero_fq = torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
    one_fq = fp.FQ.one_const(x.device)[:, 0].expand(x.shape[:-1])

    def shifted(t, fill, d):
        return torch.cat([fill[..., None].expand(t.shape[:-1] + (d,)), t[..., :-d]], dim=-1)

    d = 1
    while d < nb:
        x, y, z = curve.add(spec, (x, y, z), (shifted(x, zero_fq, d), shifted(y, one_fq, d), shifted(z, zero_fq, d)))
        d *= 2
    return (x, y, z)


def _bucket_reduce(acc, c: int, w: int, nb: int):
    """Weight buckets by index and combine windows (Horner).  Returns a
    batch-1 Jacobian point."""
    spec = curve.g1_spec()
    # bucket weighting: sum_j j*A_j = sum_{j>=1} suffix_j.  Split the batch
    # axis into (w, L, nb) with the bucket axis trailing (limb axis stays -2),
    # reversed so that suffix sums become prefix sums.
    rev = tuple(torch.flip(torch.movedim(t.reshape(P.NLIMBS, w, nb), 0, 1), (-1,)) for t in acc)
    suf = _shift_scan(spec, rev, nb)
    # suf[..., i] = suffix_{nb-1-i}; the sum over suffix_j for j >= 1 is the
    # (nb-1)-prefix total, i.e. element nb-2 of a second inclusive scan
    total = _shift_scan(spec, suf, nb)
    wsums = tuple(t[..., nb - 2] for t in total)  # (w, L) per coordinate

    # Horner over windows: R = ((W_{w-1} * 2^c) + W_{w-2}) * 2^c + ...
    def win(k):
        return tuple(t[k][..., None] for t in wsums)

    res = win(w - 1)
    for k in range(w - 2, -1, -1):
        for _ in range(c):
            res = curve.double(spec, res)
        res = curve.add(spec, res, win(k))
    return res


def host_points_to_affine_arrays(points, device=None):
    """Host oracle points -> (px, py, pz) tensors (16, N+1) on `device` with
    an appended point at infinity in the last slot (index N encodes 'no
    point')."""
    aff = []
    for p in points:
        if len(p) == 3:
            a = O.g_to_affine(O.FQ_OPS, p)
            assert a is not None, "infinity input points not supported"
        else:
            a = p
        aff.append(a)
    n = len(aff)
    px = fp.to_device(fp.FQ, [a[0] for a in aff] + [0], device)
    py = fp.to_device(fp.FQ, [a[1] for a in aff] + [0], device)
    pz = torch.cat([fp.ones(fp.FQ, (n,), device), fp.zeros(fp.FQ, (1,), device)], dim=-1)
    return px, py, pz


def msm(points, scalars, c: int | None = None, r_cap: int | None = None, device=None):
    """Multi-scalar multiplication over G1.

    points: list of host oracle Jacobian/affine points; scalars: list of
    ints.  Returns a batch-1 Jacobian point on `device` (default: the card).

    The window size c defaults to auto_c(n) — scaled to the input so small
    MSMs don't pay a 2^16-bucket accumulator.  Bucket occupancy per
    accumulation round is capped at r_cap (default: mean + 6 sigma of the
    uniform load); skewed scalar distributions spill into further bounded
    rounds instead of inflating the schedule tensor, so device memory is
    input-independent."""
    n = len(scalars)
    assert n >= 1
    if c is None:
        c = auto_c(n)
    px, py, pz = host_points_to_affine_arrays(points, device)
    if r_cap is None:
        r_cap = default_r_cap(n, c)
    return msm_run(px, py, pz, build_rounds(scalars, c, r_cap), c)


def build_rounds(scalars, c: int, r_cap: int):
    """Host-side: full bounded-occupancy schedule.

    Returns (first_idx, spills): first_idx is the (w, 2^c, R<=r_cap) main
    schedule; spills is a list of (window, idx(1, 2^c, r_cap)) rounds for
    buckets whose occupancy exceeded the cap.  Spills are WINDOW-LOCAL:
    overload is concentrated (a skewed input, or a window whose digit range
    is narrower than 2^c), so re-running the full (w, 2^c) grid per spill
    round would multiply the work w-fold for nothing — each spill round
    instead touches one window's 2^c lanes, and all spill rounds share one
    padded shape."""
    digits = extract_digits(scalars_to_u16(scalars), c)
    n_inf = digits.shape[1]  # index n encodes 'no point'
    first, leftover, more = build_schedule_capped(digits, c, r_cap)
    spills = []
    while more:
        more = False
        for wk in range(digits.shape[0]):
            if not leftover[wk].any():
                continue
            idx, left_wk, more_wk = build_schedule_capped(
                leftover[wk : wk + 1], c, r_cap
            )
            if idx.shape[-1] < r_cap:
                pad = np.full(
                    (1, idx.shape[1], r_cap - idx.shape[-1]), n_inf, np.int32
                )
                idx = np.concatenate([idx, pad], axis=-1)
            spills.append((wk, idx))
            leftover[wk] = left_wk[0]
            more = more or more_wk
    return first, spills


def msm_run(px, py, pz, rounds, c: int):
    """Device-side: execute a prebuilt (first, spills) schedule on the
    device the points lie on."""
    first, spills = rounds
    spec = curve.g1_spec()
    device = px.device
    w, nb = first.shape[0], 1 << c
    acc = curve.zero(spec, (w * nb,), device)
    acc = _accumulate_rounds(px, py, pz, torch.from_numpy(first).to(device), acc)
    for wk, idx in spills:
        acc = _accumulate_window(px, py, pz, torch.from_numpy(idx).to(device), acc, wk, nb)
    return _bucket_reduce(acc, c, w, nb)


def msm_oracle(points, scalars):
    """Host-side exact reference for testing."""
    acc = O.g_zero(O.FQ_OPS)
    for p, s in zip(points, scalars):
        acc = O.g_add(O.FQ_OPS, acc, O.g1_mul(p, s))
    return acc
