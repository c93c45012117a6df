"""Build and load the CUDA kernels under csrc/ (nvcc + ctypes, no torch headers).

Counterpart in role of the JAX package's utils/native.py, with one
difference that matters: nothing here gives way.  A missing nvcc, a failed
compile, a missing symbol or a refused launch raises.

Each `*.cu` under csrc/ becomes one shared library under build/ (a directory
.gitignore lists), compiled for sm_90a at first use.  All sources are compiled
at once, one nvcc process each, because a kernel file with a whole Fq12
formula takes much longer than the small ones.  Libraries are keyed by a hash
of every source and flag, so an edit rebuilds and a second process reuses.

The host codec csrc/bn_host.cpp (bytes <-> Montgomery limbs, no device code)
is built the same way with g++ by `build_host()`, under a key of its own: an
edit of it rebuilds it alone, and nvcc never sees it.

`launch(name, *args)` is the only place a kernel is started: it appends the
current CUDA stream, calls the C entry, raises unless it returns 0
(cudaGetLastError), and adds one to COUNTS[name] (and, for a kernel whose C
entry picks one of several instantiations, to INSTANCE_COUNTS[name, instance]).
"""

from __future__ import annotations

import collections
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD = _PKG / "build"

_P = ctypes.c_void_p
_LL = ctypes.c_longlong
_U32 = ctypes.c_uint32
_MODARGS = [ctypes.POINTER(_U32), _U32]  # modulus words (host), -m^-1 mod 2^32

# C entry -> (source file stem, argtypes before the trailing stream pointer)
_BINARY = [_P, _P, _P, _LL, _LL] + _MODARGS
_UNARY = [_P, _P, _LL, _LL] + _MODARGS
ENTRIES = {
    "mont_mul": ("kernels_fq", _BINARY),
    "mod_add": ("kernels_fq", _BINARY),
    "mod_sub": ("kernels_fq", _BINARY),
    "mod_neg": ("kernels_fq", _UNARY),
    "fq2_mul": ("kernels_fq", _BINARY),
    "fq2_sq": ("kernels_fq", _UNARY),
    "fq2_xi": ("kernels_fq", _UNARY),
    # a level of signed sums: operand descriptors and term codes (host
    # arrays), source and output counts, the extents n1, n2, rows, B; the
    # flag says Fq2 elements (the Fq2 form, whose terms may multiply by xi)
    "mod_signed_sum": ("kernels_fq", [ctypes.POINTER(_LL), ctypes.POINTER(ctypes.c_int8)] + [ctypes.c_int] * 4
                       + [_LL, _LL, ctypes.c_int] + _MODARGS),
    "fq12_mul": ("kernel_fq12_mul", _BINARY),
    "fq12_sq": ("kernel_fq12_sq", _UNARY),
    "fq12_mul024_pre": ("kernel_fq12_mul024_pre", [_P, _P, _P, _P, _LL, _LL] + _MODARGS),
    "fq12_cyclo_sq": ("kernel_fq12_cyclo_sq", _UNARY),
    # f, coeff (ell_0, ell_vw, ell_vv unscaled), out
    "fq12_mul024": ("kernel_fq12_mul024", _BINARY),
    # f, coeff, px, py, out; the flag says square first (a doubling step)
    "miller_step": ("kernel_miller_step", [_P] * 5 + [_LL, _LL, ctypes.c_int] + _MODARGS),
    # exponent words (host), digit count, R mod m words (host)
    "pow_fixed": ("kernel_pow_fixed", [_P, _P, _LL, _LL, ctypes.POINTER(_U32), ctypes.c_int, ctypes.POINTER(_U32)] + _MODARGS),
    "fq12_cyclo_sq_chain": ("kernel_fq12_cyclo_sq_chain", [_P, _P, _LL, _LL, ctypes.c_int] + _MODARGS),
    # r, r_out, coeffs_out; the twist's b as Montgomery words (host)
    "double_step": ("kernels_g2_step", [_P, _P, _P, _LL, _LL, ctypes.POINTER(_U32)] + _MODARGS),
    # r, base, r_out, coeffs_out
    "madd_step": ("kernels_g2_step", [_P, _P, _P, _P, _LL, _LL] + _MODARGS),
    # x1, y1, z1, x2, y2, z2, x3, y3, z3; the flags say G2 (coordinates over
    # Fq2) and the design (0: one thread a point, 1: the team)
    "point_add": ("kernels_curve", [_P] * 9 + [_LL, _LL, ctypes.c_int, ctypes.c_int] + _MODARGS),
    # x, y, z, x3, y3, z3
    "point_double": ("kernels_curve", [_P] * 6 + [_LL, _LL, ctypes.c_int, ctypes.c_int] + _MODARGS),
    # not kernels of the pairing: the multiply-add rate probe and the empty
    # kernel (the launch floor) chip_smoke.py uses
    "imad_probe": ("kernels_fq", [_P, ctypes.c_int, ctypes.c_int, ctypes.c_int]),
    "empty_probe": ("kernels_fq", [ctypes.c_int, ctypes.c_int]),
}
PROBES = ("imad_probe", "empty_probe")
KERNELS = tuple(k for k in ENTRIES if k not in PROBES)

# launches per kernel since the last reset_counts()
COUNTS = {k: 0 for k in KERNELS}
# launches per (kernel, instantiation) where the caller names one, e.g.
# ("miller_step", "square"): the C entry's flag picks a template instance
INSTANCE_COUNTS = collections.Counter()

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
# Per-source extra flags.  The Fq12, the Miller-step, the precompute-step and
# the curve kernels call the Montgomery product out of line (see csrc/fq.cuh):
# tools/torch_kernel_variants.py measures each 1.4 to 2 times faster that way
# than with 18 to 54 inlined copies, and the team of
# kernel_fq12_cyclo_sq_chain.cu, 3 products a thread, 6-7 % faster.
# kernel_fq12_mul.cu's team calls no Montgomery product (csrc/fq_dw.cuh).
SOURCE_FLAGS = {
    "kernel_fq12_sq": ["-DBN_MUL_OUT_OF_LINE"],
    "kernel_fq12_mul024_pre": ["-DBN_MUL_OUT_OF_LINE"],
    "kernel_fq12_mul024": ["-DBN_MUL_OUT_OF_LINE"],
    "kernel_miller_step": ["-DBN_MUL_OUT_OF_LINE"],
    "kernel_fq12_cyclo_sq": ["-DBN_MUL_OUT_OF_LINE"],
    "kernel_fq12_cyclo_sq_chain": ["-DBN_MUL_OUT_OF_LINE"],
    "kernels_g2_step": ["-DBN_MUL_OUT_OF_LINE"],
    "kernels_curve": ["-DBN_MUL_OUT_OF_LINE"],
}


def reset_counts() -> None:
    for k in COUNTS:
        COUNTS[k] = 0
    INSTANCE_COUNTS.clear()


def nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc") if os.environ.get("CUDA_HOME") else None,
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, $PATH, /usr/local/cuda/bin): the CUDA kernels cannot be built")


def sources() -> list:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _key() -> str:
    h = hashlib.sha256()
    for p in sorted(CSRC.iterdir()):
        if p.suffix in (".cu", ".cuh"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    h.update(repr((NVCC_FLAGS, sorted(SOURCE_FLAGS.items()))).encode())
    return h.hexdigest()[:16]


def lib_path(stem: str) -> Path:
    return BUILD / f"lib{stem}.{_key()}.so"


def ptxas_log(stem: str) -> str:
    """What `-Xptxas -v` said when the library was built (registers, spills)."""
    return lib_path(stem).with_suffix(".ptxas.txt").read_text()


def compile_start(stem: str, out: Path, flags=None, src: Path | None = None) -> subprocess.Popen:
    """Start one nvcc for csrc/<stem>.cu (or `src`, with csrc/ on the include
    path and <stem>'s flags) -> out; the caller waits."""
    flags = SOURCE_FLAGS.get(stem, []) if flags is None else flags
    src = CSRC / f"{stem}.cu" if src is None else src
    cmd = [nvcc()] + NVCC_FLAGS + list(flags) + ["-I", str(CSRC), "-o", str(out), str(src)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


@functools.lru_cache(maxsize=1)
def build_all() -> float:
    """Compile every source that has no library yet, all at once; done once
    per process.  Returns the seconds the build took (0.0 when every library
    was there already)."""
    BUILD.mkdir(exist_ok=True)
    t0 = time.perf_counter()
    procs = {}
    for stem in sources():
        if not lib_path(stem).exists():
            tmp = lib_path(stem).with_suffix(f".tmp{os.getpid()}.so")
            procs[stem] = (compile_start(stem, tmp), tmp)
    failed = []
    for stem, (proc, tmp) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"--- {stem}.cu (exit {proc.returncode}) ---\n{log}")
            continue
        lib_path(stem).with_suffix(".ptxas.txt").write_text(log)
        os.replace(tmp, lib_path(stem))
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0 if procs else 0.0


@functools.lru_cache(maxsize=None)
def _lib(stem: str) -> ctypes.CDLL:
    build_all()
    return ctypes.CDLL(str(lib_path(stem)))


@functools.lru_cache(maxsize=None)
def entry(name: str):
    """The C function bn_<name> with its argtypes set."""
    stem, argtypes = ENTRIES[name]
    fn = getattr(_lib(stem), f"bn_{name}")
    fn.argtypes = list(argtypes) + [_P]
    fn.restype = ctypes.c_int
    return fn


def launch(name: str, device: torch.device, *args, instance: str | None = None) -> None:
    """Start kernel `name` on `device`'s current stream; raise if refused.
    `instance` names the instantiation the arguments pick, where there are
    several, for INSTANCE_COUNTS."""
    fn = entry(name)
    if device.index is None or device.index == torch.cuda.current_device():
        rc = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    else:  # a launch goes to the current device: make the operands' device current
        with torch.cuda.device(device):
            rc = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"CUDA kernel bn_{name} was not launched: cudaError {rc}")
    if name in COUNTS:
        COUNTS[name] += 1
        if instance is not None:
            INSTANCE_COUNTS[name, instance] += 1


# ---------------------------------------------------------------------------
# the host codec: csrc/bn_host.cpp, g++
# ---------------------------------------------------------------------------

HOST_SOURCE = CSRC / "bn_host.cpp"
HOST_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC"]


def host_lib_path() -> Path:
    h = hashlib.sha256(HOST_SOURCE.read_bytes())
    h.update(repr(HOST_FLAGS).encode())
    return BUILD / f"libbn_host.{h.hexdigest()[:16]}.so"


def build_host() -> Path:
    """Compile the host codec unless its library is there already, and return
    the library's path.  A missing g++ or a failed compile raises."""
    out = host_lib_path()
    if out.exists():
        return out
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: the host codec csrc/bn_host.cpp cannot be built")
    BUILD.mkdir(exist_ok=True)
    tmp = out.with_suffix(f".tmp{os.getpid()}.so")
    proc = subprocess.run([gxx] + HOST_FLAGS + ["-o", str(tmp), str(HOST_SOURCE)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed on {HOST_SOURCE.name} (exit {proc.returncode}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out
