"""Base-field and Fq2 operations: CUDA kernels with their plain versions.

Counterpart of the JAX package's ops/mont_pallas.py.  Eight functions —
mont_mul, mod_add, mod_sub, mod_neg, pow_fixed, fq2_mul, fq2_sq, fq2_xi —
each with

 - a wrapper that dispatches on where its operand lies and on nothing else:
   a CPU tensor goes to the plain version, a CUDA tensor to the kernel in
   csrc/kernels_fq.cu or csrc/kernel_pow_fixed.cu (or the call raises);
 - `<name>_plain`, the same function in plain PyTorch on ops/limbs.py.

Operands are int32 limb tensors (..., 16, B); the Fq2 functions take
(..., 2, 16, B).  Binary wrappers broadcast their operands against each other
and materialise the result before a launch (`expand(...).contiguous()`): the
kernels read dense tensors only.  The modulus is an argument (Fq or Fr) and
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
    if not _on_card(a):
        return fq2_xi_plain(a, modulus)
    return launch("fq2_xi", (a,), ((2,),), modulus)
