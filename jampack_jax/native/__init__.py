"""Host-side native engine: ctypes bindings over a shared library built
from src/.

The library is compiled with -march=native, so a build is only valid on
the host that made it: it lives in <checkout>/build/native/ under a name
keyed on the sources, the compile command and the host's CPU, and is
built on first import when no matching file exists.  All entry points
release the GIL, so Python-level thread pools give block-level
parallelism on top of the library's inner OpenMP loops.
"""

import ctypes
import fcntl
import hashlib
import os
import platform
import subprocess

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "src")
_BUILD = os.path.join(os.path.dirname(os.path.dirname(_DIR)), "build",
                      "native")
_FLAGS = ["-std=c++17", "-O3", "-fPIC", "-shared", "-fopenmp",
          "-march=native"]


def _host_cpu() -> str:
    """The host facts -march=native depends on: machine and CPU model and
    feature flags (first processor entry of /proc/cpuinfo, where the
    kernel provides one)."""
    facts = [platform.machine()]
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith(("model name", "flags", "Features")):
                    facts.append(line.strip())
                if not line.strip() and len(facts) > 1:
                    break
    except OSError:
        facts.append(platform.processor())
    return "\n".join(facts)


def _sources():
    return sorted(os.path.join(_SRC, f) for f in os.listdir(_SRC)
                  if f.endswith((".cpp", ".hpp")))


def _library_path() -> str:
    h = hashlib.sha256()
    for path in _sources():
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    h.update(" ".join(_FLAGS).encode())
    h.update(_host_cpu().encode())
    return os.path.join(_BUILD, f"libjam-{h.hexdigest()[:16]}.so")


def _build(so: str) -> None:
    srcs = [p for p in _sources() if p.endswith(".cpp")]
    tmp = f"{so}.{os.getpid()}.tmp"
    subprocess.run(["g++", *_FLAGS, "-o", tmp, *srcs], check=True,
                   capture_output=True, text=True)
    os.replace(tmp, so)


def _load():
    so = _library_path()
    if not os.path.exists(so):
        os.makedirs(_BUILD, exist_ok=True)
        # one builder at a time (parallel test workers import this at once)
        with open(os.path.join(_BUILD, ".lock"), "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            if not os.path.exists(so):
                _build(so)
    lib = ctypes.CDLL(so)

    u8p = np.ctypeslib.ndpointer(dtype=np.uint8, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(dtype=np.int32, flags="C_CONTIGUOUS")
    c = ctypes.c_int32
    c64 = ctypes.c_int64

    lib.jam_checksum.argtypes = [u8p, c64]
    lib.jam_checksum.restype = ctypes.c_uint32
    lib.jam_sais.argtypes = [u8p, i32p, c]
    lib.jam_sais.restype = c
    lib.jam_bwt_forward_u.argtypes = [u8p, c64, u8p, c]
    lib.jam_bwt_forward_u.restype = c64
    lib.jam_bwt_inverse_u.argtypes = [u8p, c64, u8p, c, c]
    lib.jam_bwt_inverse_u.restype = c64
    lib.jam_ans_encode_c.argtypes = [u8p, c64, u8p, c64, c, c]
    lib.jam_ans_encode_c.restype = c64
    lib.jam_ans_decode.argtypes = [u8p, c64, u8p, c64, c, c]
    lib.jam_ans_decode.restype = c64
    lib.jam_lpx_encode.argtypes = [u8p, c64, u8p, c, c]
    lib.jam_lpx_encode.restype = c64
    lib.jam_lpx_decode.argtypes = [u8p, c64, u8p, c, c]
    lib.jam_lpx_decode.restype = c64
    lib.jam_filters_encode.argtypes = [u8p, c64, u8p, c, c]
    lib.jam_filters_encode.restype = c64
    lib.jam_filters_decode.argtypes = [u8p, c64, u8p]
    lib.jam_filters_decode.restype = c64
    lib.jam_lz_encode.argtypes = [u8p, c64, u8p, c]
    lib.jam_lz_encode.restype = c64
    lib.jam_lz_decode.argtypes = [u8p, c64, u8p, c64]
    lib.jam_lz_decode.restype = c64
    return lib


_lib = _load()


def _as_u8(data) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(data, dtype=np.uint8))


def checksum(data) -> int:
    a = _as_u8(data)
    return int(_lib.jam_checksum(a, a.size))


def sais(data) -> np.ndarray:
    a = _as_u8(data)
    sa = np.empty(a.size, dtype=np.int32)
    if _lib.jam_sais(a, sa, a.size) != 0:
        raise RuntimeError("sais failed")
    return sa


def bwt_forward(data, units: int = 120) -> np.ndarray:
    a = _as_u8(data)
    out = np.empty(a.size + units * 4, dtype=np.uint8)
    n = _lib.jam_bwt_forward_u(a, a.size, out, units)
    assert n == out.size
    return out


def bwt_inverse(data, threads: int = 0, units: int = 120) -> np.ndarray:
    a = _as_u8(data)
    out = np.empty(max(a.size - units * 4, 0), dtype=np.uint8)
    n = _lib.jam_bwt_inverse_u(a, a.size, out, threads, units)
    if n < 0:
        raise ValueError("corrupt BWT stream")
    return out[:n]


def ans_encode(data, chunk: int = 0, lanes: int = 0) -> np.ndarray:
    a = _as_u8(data)
    cap = (a.size + (a.size >> 2) + 8192
           + 2048 * (a.size // max(chunk, 1) if chunk else 0)
           + 24 * max(lanes, 0) * (a.size // max(chunk or (1 << 20), 1) + 1))
    out = np.empty(cap, dtype=np.uint8)
    n = _lib.jam_ans_encode_c(a, a.size, out, cap, chunk, lanes)
    if n == -1:
        raise ValueError("model failure (CDF): chunk not encodable in ref-compat mode")
    if n < 0:
        raise ValueError("ans encode out of space")
    return out[:n]  # view: stage results are consumed read-only


def ans_decode(data, cap: int, threads: int = 0, lanes: int = 0) -> np.ndarray:
    a = _as_u8(data)
    out = np.empty(cap, dtype=np.uint8)
    n = _lib.jam_ans_decode(a, a.size, out, cap, threads, lanes)
    if n < 0:
        raise ValueError("invalid rANS state or corrupt chunk header")
    return out[:n]  # view: stage results are consumed read-only


def lpx_encode(data, threads: int = 0, spans: int = 4) -> np.ndarray:
    a = _as_u8(data)
    out = np.empty(a.size, dtype=np.uint8)
    _lib.jam_lpx_encode(a, a.size, out, threads, spans)
    return out


def lpx_decode(data, threads: int = 0, spans: int = 4) -> np.ndarray:
    a = _as_u8(data)
    out = np.empty(a.size, dtype=np.uint8)
    _lib.jam_lpx_decode(a, a.size, out, threads, spans)
    return out


def filters_encode(data, mode: int = 1, threads: int = 0) -> np.ndarray:
    a = _as_u8(data)
    nchunks = (a.size + (64 << 10) - 1) // (64 << 10)
    out = np.empty(a.size + 2 * max(nchunks, 1), dtype=np.uint8)
    n = _lib.jam_filters_encode(a, a.size, out, mode, threads)
    return out[:n]  # view: stage results are consumed read-only


def filters_decode(data) -> np.ndarray:
    a = _as_u8(data)
    out = np.empty(a.size, dtype=np.uint8)
    n = _lib.jam_filters_decode(a, a.size, out)
    if n < 0:
        raise ValueError("unsupported filter configuration")
    return out[:n]  # view: stage results are consumed read-only


def lz_encode(data, mode: int = 0) -> np.ndarray:
    a = _as_u8(data)
    # worst case: tokens never accepted -> end marker + raw data + headroom
    out = np.empty(a.size + (a.size >> 3) + 64, dtype=np.uint8)
    n = _lib.jam_lz_encode(a, a.size, out, mode)
    return out[:n]  # view: stage results are consumed read-only


def lz_decode(data, cap: int) -> np.ndarray:
    a = _as_u8(data)
    out = np.empty(cap, dtype=np.uint8)
    n = _lib.jam_lz_decode(a, a.size, out, cap)
    if n < 0:
        raise ValueError("invalid lz77 token stream")
    return out[:n]  # view: stage results are consumed read-only
