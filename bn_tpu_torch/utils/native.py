"""ctypes bindings of the host codec csrc/bn_host.cpp.

Counterpart of the JAX package's utils/native.py, with one difference that
matters: it does not give way.  The library is built with g++ at first use
(ops/build.py `build_host`, into build/); a missing compiler, a failed build
or a failed load raises, and there is no `available()`: the API has one path
for Fr bytes, this codec.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np

from ..ops import build

FIELD_FQ, FIELD_FR = 0, 1
ABI_VERSION = 1

_U32P = ctypes.POINTER(ctypes.c_uint32)


@functools.lru_cache(maxsize=1)
def lib() -> ctypes.CDLL:
    """The loaded library with its argument types set."""
    L = ctypes.CDLL(str(build.build_host()))
    L.bn_fp_decode_batch.restype = ctypes.c_long
    L.bn_fp_decode_batch.argtypes = [ctypes.c_char_p, ctypes.c_long, ctypes.c_int, _U32P]
    L.bn_fp_encode_batch.restype = None
    L.bn_fp_encode_batch.argtypes = [_U32P, ctypes.c_long, ctypes.c_int, ctypes.c_char_p]
    L.bn_fq2_decode_batch.restype = ctypes.c_long
    L.bn_fq2_decode_batch.argtypes = [ctypes.c_char_p, ctypes.c_long, _U32P]
    L.bn_fq2_encode_batch.restype = None
    L.bn_fq2_encode_batch.argtypes = [_U32P, ctypes.c_long, ctypes.c_char_p]
    L.bn_fp_interpret_batch.restype = None
    L.bn_fp_interpret_batch.argtypes = [ctypes.c_char_p, ctypes.c_long, ctypes.c_int, _U32P]
    if L.bn_host_abi_version() != ABI_VERSION:
        raise RuntimeError(f"host codec ABI {L.bn_host_abi_version()}, expected {ABI_VERSION}")
    return L


def _u32p(a: np.ndarray):
    return a.ctypes.data_as(_U32P)


def _rows(limbs, width: int) -> np.ndarray:
    limbs = np.ascontiguousarray(limbs, dtype=np.uint32)
    if limbs.ndim != 2 or limbs.shape[1] != width:
        raise ValueError(f"limb rows of shape {limbs.shape}, expected (n, {width})")
    return limbs


def _whole(data: bytes, size: int) -> int:
    if len(data) % size:
        raise ValueError(f"{len(data)} bytes are not a whole number of {size}-byte values")
    return len(data) // size


def fp_decode_batch(data: bytes, field: int) -> np.ndarray:
    """(n*32) canonical BE bytes -> (n, 16) uint32 Montgomery limb rows.
    Raises ValueError at the first out-of-range element."""
    n = _whole(data, 32)
    out = np.empty((n, 16), dtype=np.uint32)
    bad = lib().bn_fp_decode_batch(data, n, field, _u32p(out))
    if bad >= 0:
        raise ValueError(f"element {bad}: integer is not less than modulus")
    return out


def fp_encode_batch(limbs: np.ndarray, field: int) -> bytes:
    """(n, 16) uint32 Montgomery limb rows -> n*32 canonical BE bytes."""
    limbs = _rows(limbs, 16)
    out = ctypes.create_string_buffer(limbs.shape[0] * 32)
    lib().bn_fp_encode_batch(_u32p(limbs), limbs.shape[0], field, out)
    return out.raw


def fq2_decode_batch(data: bytes) -> np.ndarray:
    """(n*64) BE U512 bytes -> (n, 32) uint32 rows (c0 | c1 limbs)."""
    n = _whole(data, 64)
    out = np.empty((n, 32), dtype=np.uint32)
    bad = lib().bn_fq2_decode_batch(data, n, _u32p(out))
    if bad >= 0:
        raise ValueError(f"element {bad}: integer not less than modulus squared")
    return out


def fq2_encode_batch(limbs: np.ndarray) -> bytes:
    """(n, 32) uint32 rows (c0 | c1 limbs) -> n*64 BE U512 bytes c1*q + c0."""
    limbs = _rows(limbs, 32)
    out = ctypes.create_string_buffer(limbs.shape[0] * 64)
    lib().bn_fq2_encode_batch(_u32p(limbs), limbs.shape[0], out)
    return out.raw


def fp_interpret_batch(data: bytes, field: int) -> np.ndarray:
    """(n*64) BE bytes -> (n, 16) uint32 Montgomery rows via mod-m reduction."""
    n = _whole(data, 64)
    out = np.empty((n, 16), dtype=np.uint32)
    lib().bn_fp_interpret_batch(data, n, field, _u32p(out))
    return out
