"""Base-field and Fq2 operations: CUDA kernels with their plain versions.

Counterpart of the JAX package's ops/mont_pallas.py.  Nine functions —
mont_mul, mod_add, mod_sub, mod_neg, mod_signed_sum, pow_fixed, fq2_mul,
fq2_sq, fq2_xi — each with

 - a wrapper that dispatches on where its operand lies and on nothing else:
   a CPU tensor goes to the plain version, a CUDA tensor to the kernel in
   csrc/kernels_fq.cu or csrc/kernel_pow_fixed.cu (or the call raises);
 - `<name>_plain`, the same function in plain PyTorch on ops/limbs.py.

Operands are int32 limb tensors (..., 16, B); the Fq2 functions take
(..., 2, 16, B).  Binary wrappers broadcast their operands against each other
and materialise the result before a launch (`expand(...).contiguous()`): the
kernels read dense tensors only.  mod_signed_sum, a whole level of sums,
differences and negations in one launch (mod_sub and mod_neg are its one-
output cases), reads its sources in place and writes where the caller says:
any strides between the (16, B) blocks of an element.  Its Fq2 form
(fq2=True) works on (..., 2, 16, B) elements, a dense (2, 16, B) block each,
and a term may multiply its source by xi = 9 + u: so a tower formula's
products by xi join the level of sums around them, and fq2_xi is the Fq2
form's one-term case.  fq2_sq's kernel is a team of two warps on 32
elements, one coefficient a warp.  The modulus is an argument (Fq or Fr) and
reaches the kernel as eight 32-bit words plus -m^-1 mod 2^32.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import params as P
from . import build
from . import limbs as lb


@functools.lru_cache(maxsize=None)
def _m_limbs(modulus: int):
    return P.int_to_limbs(modulus)


@functools.lru_cache(maxsize=None)
def _mod_args(modulus: int):
    """(modulus words as a C array, -m^-1 mod 2^32) for a kernel call."""
    inv32 = (-P.inv_mod(modulus, 1 << P.WORD_BITS)) % (1 << P.WORD_BITS)
    return (ctypes.c_uint32 * P.NWORDS)(*P.int_to_words(modulus)), ctypes.c_uint32(inv32)


def _on_card(*ts) -> bool:
    """True for CUDA operands, False for CPU operands; anything else raises."""
    kinds = {t.device.type for t in ts}
    if kinds == {"cpu"}:
        return False
    if kinds == {"cuda"} and len({t.device for t in ts}) == 1:
        return True
    raise ValueError(f"operands must all lie on the CPU or on one CUDA device, got {[str(t.device) for t in ts]}")


def broadcast(*ts):
    """Expand operands to their common shape (views; no copy)."""
    if all(t.shape == ts[0].shape for t in ts):
        return ts
    shape = torch.broadcast_shapes(*(t.shape for t in ts))
    return tuple(t.expand(shape) for t in ts)


def _check_destination(name: str, dst, shape, ins):
    """A caller-named output: dense int32 of the right shape on the operands'
    device, and not one of the operands (the kernels read through
    __restrict__ pointers)."""
    if dst.dtype != torch.int32 or tuple(dst.shape) != tuple(shape) or dst.device != ins[0].device:
        raise ValueError(f"{name}: destination {tuple(dst.shape)} {dst.dtype} on {dst.device}, expected {tuple(shape)} torch.int32 on {ins[0].device}")
    if not dst.is_contiguous():
        raise ValueError(f"{name}: a destination must be contiguous")
    if any(dst.data_ptr() == t.data_ptr() for t in ins):
        raise ValueError(f"{name}: a destination may not be one of the operands")
    return dst


def launch(name: str, ins, structs, modulus: int, extra=(), out_structs=None, outs=None, instance=None):
    """Check the operands, allocate the output like ins[0] and start kernel
    `name`.  ins[k] has shape (*lead, *structs[k], 16, B) with one `lead`
    for all; the kernel sees rows = prod(lead) elements of batch B.  `extra`
    are the kernel's own arguments between B and the modulus.  A kernel with
    several outputs names their structs in `out_structs` and gets a tuple
    back; `outs` may then name a destination for each (None = allocate).
    `instance` names the instantiation `extra` picks (build.INSTANCE_COUNTS).

    A dense copy made here may be freed as soon as this returns, before the
    kernel has run: PyTorch's allocator hands the memory out again only to
    work queued later on the same stream, which is the stream of the launch."""
    B = ins[0].shape[-1]
    lead = tuple(ins[0].shape[: ins[0].dim() - 2 - len(structs[0])])
    dense = []
    for t, st in zip(ins, structs):
        if t.dtype != torch.int32:
            raise TypeError(f"{name}: limb tensors are torch.int32, got {t.dtype}")
        if tuple(t.shape) != lead + tuple(st) + (P.NLIMBS, B):
            raise ValueError(f"{name}: operand of shape {tuple(t.shape)}, expected {lead + tuple(st) + (P.NLIMBS, B)}")
        dense.append(t.contiguous())
    if out_structs is None:
        results = [torch.empty_like(dense[0])]
    else:
        results = []
        for dst, st in zip(outs or [None] * len(out_structs), out_structs):
            shape = lead + tuple(st) + (P.NLIMBS, B)
            if dst is None:  # a fresh tensor needs no check
                results.append(torch.empty(shape, dtype=torch.int32, device=dense[0].device))
            else:
                results.append(_check_destination(name, dst, shape, dense))
    rows = 1
    for d in lead:
        rows *= d
    if rows * B:
        words, inv32 = _mod_args(modulus)
        build.launch(name, results[0].device, *(t.data_ptr() for t in dense), *(t.data_ptr() for t in results),
                     rows, B, *extra, words, inv32, instance=instance)
    return results[0] if out_structs is None else tuple(results)


# ---------------------------------------------------------------------------
# base field
# ---------------------------------------------------------------------------


def mont_mul_plain(a, b, modulus: int):
    return lb.mont_mul(a, b, _m_limbs(modulus))


def mont_mul(a, b, modulus: int):
    """Montgomery product a*b*2^-256 mod m, result < m."""
    a, b = broadcast(a, b)
    if not _on_card(a, b):
        return mont_mul_plain(a, b, modulus)
    return launch("mont_mul", (a, b), ((), ()), modulus)


def mod_add_plain(a, b, modulus: int):
    return lb.mod_add(a, b, _m_limbs(modulus))


def mod_add(a, b, modulus: int):
    a, b = broadcast(a, b)
    if not _on_card(a, b):
        return mod_add_plain(a, b, modulus)
    return launch("mod_add", (a, b), ((), ()), modulus)


def mod_sub_plain(a, b, modulus: int):
    return lb.mod_sub(a, b, _m_limbs(modulus))


def mod_sub(a, b, modulus: int):
    a, b = broadcast(a, b)
    if not _on_card(a, b):
        return mod_sub_plain(a, b, modulus)
    return launch("mod_sub", (a, b), ((), ()), modulus)


def mod_neg_plain(a, modulus: int):
    return lb.mod_neg(a, _m_limbs(modulus))


def mod_neg(a, modulus: int):
    if not _on_card(a):
        return mod_neg_plain(a, modulus)
    return launch("mod_neg", (a,), ((),), modulus)


# ---------------------------------------------------------------------------
# a level of signed sums
# ---------------------------------------------------------------------------

SUM_MAX_TERMS = 4  # csrc/signed_sum.cuh's bounds
SUM_MAX_SOURCES = 16
SUM_MAX_OUTPUTS = 16
_SUM_ROW_DIMS = 3
_SUM_XI_FLAG = 32  # csrc/signed_sum.cuh's BN_SUM_XI
XI = "xi"  # a term (i, sign, XI): sign * xi * sources[i], in an Fq2 level


@functools.lru_cache(maxsize=None)
def _sum_codes(terms, fq2: bool):
    """Check a level's terms and encode them as the kernel reads them: output
    k's term j is +(i + 1) for +source i, -(i + 1) for -source i, with 32
    added to i + 1 for xi times source i, 0 after its last term.  Returns
    (the codes as a C array, sources the terms name)."""
    if not 1 <= len(terms) <= SUM_MAX_OUTPUTS:
        raise ValueError(f"mod_signed_sum: 1 to {SUM_MAX_OUTPUTS} outputs, got {len(terms)}")
    codes, named = [], 0
    for out_terms in terms:
        if not 1 <= len(out_terms) <= SUM_MAX_TERMS:
            raise ValueError(f"mod_signed_sum: 1 to {SUM_MAX_TERMS} terms an output, got {out_terms}")
        for term in out_terms:
            i, sign, *xi = term
            if sign not in (1, -1) or not 0 <= i < SUM_MAX_SOURCES or xi not in ([], [XI]):
                raise ValueError(f"mod_signed_sum: a term is (source below {SUM_MAX_SOURCES}, +1 or -1[, XI]), got {term}")
            if xi and not fq2:
                raise ValueError(f"mod_signed_sum: a xi term {term} needs the Fq2 form (fq2=True)")
            codes.append(sign * (i + 1 + (_SUM_XI_FLAG if xi else 0)))
            named = max(named, i + 1)
        codes += [0] * (SUM_MAX_TERMS - len(out_terms))
    return (ctypes.c_int8 * len(codes))(*codes), named


def _view(t):
    """An operand as (tensor, address, shape, strides), each read once."""
    return t, t.data_ptr(), tuple(t.shape), t.stride()


def _tail(fq2: bool) -> int:
    """The axes of an operand's dense block: (16, B), or (2, 16, B)."""
    return 3 if fq2 else 2


def _dense_tail(v, fq2: bool = False) -> bool:
    """Limb i of lane b at i*B + b from the element's start (of coefficient
    c at (c*16 + i)*B + b for the Fq2 form)."""
    _, _, shape, stride = v
    return (stride[-2] == shape[-1] and (stride[-1] == 1 or shape[-1] == 1)
            and (not fq2 or stride[-3] == P.NLIMBS * shape[-1]))


def _extent(v, is_out):
    """(first byte, byte after the last, is_out) of the storage v may touch."""
    _, ptr, shape, stride = v
    return ptr, ptr + 4 * (sum((n - 1) * s for n, s in zip(shape, stride)) + 1), is_out


def _block_extents(v, is_out, fq2: bool):
    """_extent of each dense block of v, for v (..., 16, B) or (..., 2, 16, B)."""
    _, ptr, shape, stride = v
    tail = _tail(fq2)
    end = 4 * (sum((n - 1) * s for n, s in zip(shape[-tail:], stride[-tail:])) + 1)
    starts = [ptr]
    for n, s in zip(shape[:-tail], stride[:-tail]):
        if n > 1:
            starts = [a + 4 * s * i for a in starts for i in range(n)]
    return [(a, a + end, is_out) for a in starts]


def _overlap(extents) -> bool:
    """True when an output's range meets another output's or a source's
    (sources may overlap each other)."""
    end_any = end_out = 0
    for lo, hi, is_out in sorted(extents):
        if lo < (end_any if is_out else end_out):
            return True
        end_any = max(end_any, hi)
        if is_out:
            end_out = max(end_out, hi)
    return False


def _self_overlapping(v) -> bool:
    """True unless v's strides put every element at its own address (checked
    axis by axis from the smallest stride: conservative)."""
    _, _, shape, stride = v
    reach = 0  # the largest offset the smaller strides reach
    for s, n in sorted((s, n) for n, s in zip(shape, stride) if n > 1):
        if s <= reach:
            return True
        reach += s * (n - 1)
    return False


def _sum_setup(terms, sources, out, fq2: bool):
    """Check a level and resolve its outputs: (codes, the sources brought to
    one shape, the outputs, as _view records, and what the call returns)."""
    codes, named = _sum_codes(terms, fq2)
    sources = broadcast(*sources)
    if not named <= len(sources) <= SUM_MAX_SOURCES:
        raise ValueError(f"mod_signed_sum: the terms name {named} sources, {len(sources)} given (at most {SUM_MAX_SOURCES})")
    srcs = [_view(t) for t in sources]
    shape = srcs[0][2]
    element = ((2,) if fq2 else ()) + (P.NLIMBS,)
    if len(shape) < len(element) + 1 or shape[-1 - len(element):-1] != element or any(t.dtype != torch.int32 for t in sources):
        raise ValueError(f"mod_signed_sum: sources are int32 (..., {', '.join(map(str, element))}, B), got {shape} {sources[0].dtype}")
    if out is None:
        result = torch.empty((len(terms),) + shape, dtype=torch.int32, device=sources[0].device)
        return codes, srcs, [_view(o) for o in result.unbind(0)], result
    outs = [_view(o) for o in (out.unbind(0) if isinstance(out, torch.Tensor) else out)]
    if len(outs) != len(terms):
        raise ValueError(f"mod_signed_sum: {len(terms)} outputs, {len(outs)} destinations")
    for v in outs:
        o = v[0]
        if o.dtype != torch.int32 or v[2] != shape or o.device != sources[0].device:
            raise ValueError(f"mod_signed_sum: destination {v[2]} {o.dtype} on {o.device}, expected {shape} torch.int32 on {sources[0].device}")
        if not _dense_tail(v, fq2) or _self_overlapping(v):
            raise ValueError("mod_signed_sum: a destination needs a dense block an element and its own address for every element")
    ops = [(v, True) for v in outs] + [(v, False) for v in srcs]
    extents = [_extent(v, is_out) for v, is_out in ops]
    if _overlap(extents):  # ranges meet: compare the dense blocks of the operands whose ranges meet

        def meets(k):  # an output: any other operand; a source: any output
            lo, hi, _ = extents[k]
            others = extents if k < len(outs) else extents[: len(outs)]
            return any(j != k and l < hi and lo < h for j, (l, h, _) in enumerate(others))

        blocks = [b for k, (v, is_out) in enumerate(ops) if meets(k) for b in _block_extents(v, is_out, fq2)]
        if _overlap(blocks):
            raise ValueError("mod_signed_sum: a destination overlaps a source or another destination")
    return codes, srcs, outs, out


def _sum_operands(ops, rows):
    """(n1, n2, descriptors) of operands (*rows, <dense block>), _view
    records: the row axes merged where every operand allows it, at most three
    left, r2 the fastest; each operand as its address and the element
    strides of r0, r1, r2."""
    dims = []  # [extent, the operands' strides], fastest first
    for d in range(len(rows) - 1, -1, -1):
        if rows[d] == 1:
            continue
        st = [v[3][d] for v in ops]
        if dims and all(x == y * dims[-1][0] for x, y in zip(st, dims[-1][1])):
            dims[-1][0] *= rows[d]
        else:
            dims.append([rows[d], st])
    if len(dims) > _SUM_ROW_DIMS:
        raise ValueError(f"mod_signed_sum: the operands' rows need {len(dims)} strides, the kernel takes {_SUM_ROW_DIMS}")
    dims += [[1, [0] * len(ops)]] * (_SUM_ROW_DIMS - len(dims))
    (n2, s2), (n1, s1), (_, s0) = dims
    words = [w for i, v in enumerate(ops) for w in (v[1], s0[i], s1[i], s2[i])]
    return n1, n2, (ctypes.c_longlong * len(words))(*words)


def _signed_sum_plain_into(terms, srcs, outs, modulus: int):
    m = _m_limbs(modulus)

    def value(i, xi):
        return fq2_xi_plain(srcs[i][0], modulus) if xi else srcs[i][0]

    for (o, *_), ((i, sign, *xi), *rest) in zip(outs, terms):
        acc = value(i, xi) if sign > 0 else lb.mod_neg(value(i, xi), m)
        for i, sign, *xi in rest:
            acc = (lb.mod_add if sign > 0 else lb.mod_sub)(acc, value(i, xi), m)
        o.copy_(acc)


def mod_signed_sum_plain(terms, sources, modulus: int, out=None, fq2: bool = False):
    """mod_signed_sum's plain version: fq2_xi_plain for a xi term, then
    ops/limbs.py's mod_neg, mod_add and mod_sub term by term."""
    _, srcs, outs, result = _sum_setup(terms, sources, out, fq2)
    _signed_sum_plain_into(terms, srcs, outs, modulus)
    return result


def mod_signed_sum(terms, sources, modulus: int, out=None, fq2: bool = False):
    """A level of signed sums in one launch: output k is
    sum_j sign_kj * sources[i_kj] mod m for its terms ((i_kj, sign_kj), ...)
    in terms[k], sign +1 or -1, a first term of -1 a negation, a lone +1 a
    copy.  Up to 16 outputs of up to 4 terms each, over up to 16 sources.
    `terms` is a tuple of tuples of pairs (the encoding is cached on it).

    The sources broadcast to one shape S = (..., 16, B) and are read in place
    (any strides between (16, B) blocks).  The result is a new (K, *S) tensor
    for K outputs, or is written where `out` says: a (K, *S) tensor or K
    tensors of shape S, views into the caller's tensors (a slice of the
    stacked or packed tensor the result's consumer reads), each with a dense
    (16, B) block an element.  A destination may not overlap a source or
    another destination (their storage ranges, then their blocks, are
    compared); the call returns `out`.  Every result is the canonical
    residue, so the order of the terms changes no bit.

    With fq2=True the level's elements are Fq2: S = (..., 2, 16, B), a dense
    (2, 16, B) block an element, and a term may be a triple (i, sign, XI),
    sign * xi * sources[i] with xi = 9 + u (one thread then owns both
    coefficients of an output's lane)."""
    codes, srcs, outs, result = _sum_setup(terms, sources, out, fq2)
    if not _on_card(*(v[0] for v in srcs), *(v[0] for v in outs)):
        _signed_sum_plain_into(terms, srcs, outs, modulus)
        return result
    srcs = [v if _dense_tail(v, fq2) else _view(v[0].contiguous()) for v in srcs]
    shape = srcs[0][2]
    rows = 1
    for d in shape[: -_tail(fq2)]:
        rows *= d
    if rows * shape[-1]:
        n1, n2, desc = _sum_operands(srcs + outs, shape[: -_tail(fq2)])
        words, inv32 = _mod_args(modulus)
        build.launch("mod_signed_sum", srcs[0][0].device, desc, codes, len(srcs), len(outs), n1, n2,
                     rows, shape[-1], int(fq2), words, inv32)
    return result


# ---------------------------------------------------------------------------
# fixed-exponent power
# ---------------------------------------------------------------------------

WINDOW = 4


@functools.lru_cache(maxsize=None)
def digit_schedule(e: int):
    """Big-endian base-16 digits of e > 0, leading zeros stripped."""
    if e <= 0:
        raise ValueError(f"pow_fixed: the exponent must be positive, got {e}")
    nd = (e.bit_length() + WINDOW - 1) // WINDOW
    return tuple((e >> (i * WINDOW)) & (2**WINDOW - 1) for i in range(nd - 1, -1, -1))


def window_pow(mul, one, a, e: int):
    """a^e by the window-4 ladder on a product `mul` with identity `one`:
    table[k] = a^k, then res = res^16 * table[d] for each further digit.  The
    Montgomery one is an exact identity of the product, so a zero digit needs
    no special case, and the leading digit is never zero, so 0^e = 0."""
    table = [one]
    for _ in range(2**WINDOW - 1):
        table.append(mul(table[-1], a))
    digits = digit_schedule(e)
    res = table[digits[0]]
    for d in digits[1:]:
        for _ in range(WINDOW):
            res = mul(res, res)
        res = mul(res, table[d])
    return res


def _mont_one(modulus: int) -> int:
    return P.R_MONT % modulus


def pow_fixed_plain(a, e: int, modulus: int):
    m = _m_limbs(modulus)
    one = lb.const(P.int_to_limbs(_mont_one(modulus)), a.device).expand_as(a)
    return window_pow(lambda x, y: lb.mont_mul(x, y, m), one, a, e)


@functools.lru_cache(maxsize=None)
def _pow_args(e: int, modulus: int):
    """The kernel's own arguments: exponent words, digit count, R mod m."""
    if e >= 1 << (P.WORD_BITS * P.NWORDS):
        raise ValueError("pow_fixed: the exponent must be below 2^256")
    return (
        (ctypes.c_uint32 * P.NWORDS)(*P.int_to_words(e)),
        len(digit_schedule(e)),
        (ctypes.c_uint32 * P.NWORDS)(*P.int_to_words(_mont_one(modulus))),
    )


def pow_fixed(a, e: int, modulus: int):
    """a^e in the Montgomery domain for a fixed exponent 0 < e < 2^256; one
    launch whatever e.  Maps 0 to 0."""
    if not _on_card(a):
        return pow_fixed_plain(a, e, modulus)
    return launch("pow_fixed", (a,), ((),), modulus, extra=_pow_args(e, modulus))


# ---------------------------------------------------------------------------
# Fq2 = Fq[u]/(u^2+1), tensors (..., 2, 16, B)
# ---------------------------------------------------------------------------


def _c2(a, i):
    return a[..., i, :, :]


def _pack2(x0, x1):
    return torch.stack((x0, x1), dim=-3)


def fq2_mul_plain(a, b, modulus: int):
    """Karatsuba: the 3 products stacked into one mont_mul."""
    m = _m_limbs(modulus)
    a0, a1, b0, b1 = _c2(a, 0), _c2(a, 1), _c2(b, 0), _c2(b, 1)
    lhs = torch.stack([a0, a1, lb.mod_add(a0, a1, m)])
    rhs = torch.stack([b0, b1, lb.mod_add(b0, b1, m)])
    aa, bb, cc = lb.mont_mul(lhs, rhs, m)
    return _pack2(lb.mod_sub(aa, bb, m), lb.mod_sub(lb.mod_sub(cc, aa, m), bb, m))


def fq2_mul(a, b, modulus: int):
    a, b = broadcast(a, b)
    if not _on_card(a, b):
        return fq2_mul_plain(a, b, modulus)
    return launch("fq2_mul", (a, b), ((2,), (2,)), modulus)


def fq2_sq_plain(a, modulus: int):
    """Complex squaring: (a0+a1)(a0-a1), 2*a0*a1."""
    m = _m_limbs(modulus)
    a0, a1 = _c2(a, 0), _c2(a, 1)
    lhs = torch.stack([lb.mod_add(a0, a1, m), a0])
    rhs = torch.stack([lb.mod_sub(a0, a1, m), a1])
    p0, p1 = lb.mont_mul(lhs, rhs, m)
    return _pack2(p0, lb.mod_add(p1, p1, m))


def fq2_sq(a, modulus: int):
    """a^2; on the card a team of two warps on 32 elements, one coefficient a
    warp (csrc/team.cuh, Fq2SqTeam)."""
    if not _on_card(a):
        return fq2_sq_plain(a, modulus)
    return launch("fq2_sq", (a,), ((2,),), modulus)


def fq2_xi_plain(a, modulus: int):
    """Multiply by xi = 9 + u: (9*c0 - c1, c0 + 9*c1), 9x by a doubling chain."""
    m = _m_limbs(modulus)
    nine = a
    for _ in range(3):
        nine = lb.mod_add(nine, nine, m)
    nine = lb.mod_add(nine, a, m)
    return _pack2(lb.mod_sub(_c2(nine, 0), _c2(a, 1), m), lb.mod_add(_c2(nine, 1), _c2(a, 0), m))


def fq2_xi(a, modulus: int):
    """xi a: the Fq2 form of mod_signed_sum's one-term case, its table fixed
    at compile time."""
    if not _on_card(a):
        return fq2_xi_plain(a, modulus)
    return launch("fq2_xi", (a,), ((2,),), modulus)
