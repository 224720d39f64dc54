"""ctypes bindings for the native core (libhvd_core.so).

Counterpart of ``horovod_tpu/native.py`` over the port's copy of its C++
sources (``horovod_tpu_torch/cpp/``): the reference's Python layer loads
its C++ core with ctypes (``horovod/common/basics.py:29``), and so does
this module, exposing:

  fusion_plan       bucketing (reference FuseResponses); ``ops/fusion.py``
                    ``bucket_plan`` prefers it
  Autotune          GP/EI tuner (``utils/autotune.py``)
  encode_request/decode_request/encode_response/decode_response  the wire
                    codec of the eager consistency check (``ops/eager.py``)

The library also holds the JAX package's response cache, timeline
writer, stall inspector and TCP controller; the port binds them with
the entries that will call them (``ROADMAP.md`` Queue A).

:func:`load` builds the library with ``g++`` at first use into
``horovod_tpu_torch/_build/native/`` (never under ``horovod_tpu/``),
under a file lock so that concurrent processes build it once.  The
library's file name carries a hash of every source and header and of
the flags, as ``ops/build.py`` names the CUDA libraries: an edited
source is rebuilt and a stale library is never loaded, whatever the
files' times say (the JAX package compares modification times,
``horovod_tpu/native.py:38-53``, which a copy to another machine with
another clock can fool).  Its consumers fall back to pure Python where
no compiler exists (:func:`available` is then False).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import List, Optional, Sequence, Tuple

_HERE = os.path.dirname(os.path.abspath(__file__))
_CPP_DIR = os.path.join(_HERE, "cpp")
_BUILD_DIR = os.path.join(_HERE, "_build", "native")
# The JAX package's Makefile (horovod_tpu/cpp/Makefile): its sources and
# flags.
_SOURCES = ("common.cc", "fusion.cc", "cache.cc", "timeline.cc", "stall.cc",
            "wire.cc", "controller.cc", "autotune.cc")
_CXXFLAGS = ("-O2", "-fPIC", "-std=c++17", "-Wall", "-Wextra", "-pthread")

_lib = None
_lib_lock = threading.Lock()
_build_failed = False


def lib_path() -> str:
    """Where the library of the current sources and flags lives."""
    digest = hashlib.sha256(" ".join(_CXXFLAGS).encode())
    for sub in ("include", "src"):
        d = os.path.join(_CPP_DIR, sub)
        for f in sorted(os.listdir(d)):
            if f.endswith((".cc", ".h")):
                digest.update(f.encode())
                with open(os.path.join(d, f), "rb") as fh:
                    digest.update(fh.read())
    return os.path.join(_BUILD_DIR, f"libhvd_core-{digest.hexdigest()[:16]}.so")


def _build(path: str) -> None:
    """Compile each source in parallel (one ``g++ -c`` per source), link
    into a temporary file and move it to ``path``, so that a process
    loading the library never sees half of it."""
    os.makedirs(_BUILD_DIR, exist_ok=True)
    cxx = os.environ.get("CXX", "g++")
    tag = f"{os.getpid()}.tmp"
    objs = [os.path.join(_BUILD_DIR, f"{s}.{tag}.o") for s in _SOURCES]
    tmp = f"{path}.{tag}"
    try:
        procs = [subprocess.Popen(
            [cxx, *_CXXFLAGS, "-I", os.path.join(_CPP_DIR, "include"), "-c",
             os.path.join(_CPP_DIR, "src", src), "-o", obj],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
            for src, obj in zip(_SOURCES, objs)]
        logs = [p.communicate(timeout=300)[0] for p in procs]
        for src, p, log in zip(_SOURCES, procs, logs):
            if p.returncode:
                raise RuntimeError(f"g++ {src}: {log.decode(errors='replace')}")
        subprocess.run([cxx, "-o", tmp, *objs, "-shared", "-pthread"], check=True,
                       capture_output=True, timeout=300)
        os.replace(tmp, path)
    finally:
        for f in objs + [tmp]:
            if os.path.exists(f):
                os.remove(f)


def load(build: bool = True) -> Optional[ctypes.CDLL]:
    """Load (building it if needed) the native core; None if unavailable."""
    global _lib, _build_failed
    with _lib_lock:
        if _lib is not None:
            return _lib
        path = lib_path()
        if build and not _build_failed and not os.path.exists(path):
            try:
                import fcntl

                os.makedirs(_BUILD_DIR, exist_ok=True)
                with open(os.path.join(_BUILD_DIR, ".build.lock"), "w") as lock_fh:
                    fcntl.flock(lock_fh, fcntl.LOCK_EX)
                    if not os.path.exists(path):
                        _build(path)
            except Exception as e:  # no compiler, or a failed build
                _build_failed = True
                import logging

                logging.getLogger("horovod_tpu_torch").warning(
                    "native core build failed (%s); falling back to pure Python", e)
        if not os.path.exists(path):
            return None
        lib = ctypes.CDLL(path)
        _configure(lib)
        _lib = lib
        return _lib


def available() -> bool:
    return load() is not None


def _configure(lib: ctypes.CDLL) -> None:
    c = ctypes
    lib.hvd_version.restype = c.c_char_p
    lib.hvd_last_error.restype = c.c_char_p
    lib.hvd_fusion_plan.restype = c.c_int64
    lib.hvd_fusion_plan.argtypes = [
        c.POINTER(c.c_int64), c.POINTER(c.c_int32), c.c_int64, c.c_int64,
        c.POINTER(c.c_int64),
    ]
    lib.hvd_wire_encode_request.restype = c.c_int64
    lib.hvd_wire_encode_request.argtypes = [
        c.c_int32, c.c_int32, c.c_int32, c.c_int32, c.POINTER(c.c_int64),
        c.c_int32, c.c_char_p, c.POINTER(c.c_uint8), c.c_int64,
    ]
    lib.hvd_wire_decode_request.restype = c.c_int64
    lib.hvd_wire_decode_request.argtypes = [
        c.POINTER(c.c_uint8), c.c_int64, c.POINTER(c.c_int32),
        c.POINTER(c.c_int32), c.POINTER(c.c_int32), c.POINTER(c.c_int32),
        c.POINTER(c.c_int64), c.c_int32, c.POINTER(c.c_int32), c.c_char_p,
        c.c_int64,
    ]
    lib.hvd_wire_encode_response.restype = c.c_int64
    lib.hvd_wire_encode_response.argtypes = [
        c.c_int32, c.c_char_p, c.c_char_p, c.POINTER(c.c_int64),
        c.c_int32, c.POINTER(c.c_uint8), c.c_int64,
    ]
    lib.hvd_wire_decode_response.restype = c.c_int64
    lib.hvd_wire_decode_response.argtypes = [
        c.POINTER(c.c_uint8), c.c_int64, c.POINTER(c.c_int32), c.c_char_p,
        c.c_int64, c.c_char_p, c.c_int64, c.POINTER(c.c_int64), c.c_int32,
        c.POINTER(c.c_int32),
    ]
    lib.hvd_autotune_new.restype = c.c_void_p
    lib.hvd_autotune_new.argtypes = [c.c_double, c.c_double]
    lib.hvd_autotune_free.argtypes = [c.c_void_p]
    lib.hvd_autotune_observe.argtypes = [c.c_void_p, c.c_double, c.c_double]
    lib.hvd_autotune_suggest.restype = c.c_double
    lib.hvd_autotune_suggest.argtypes = [c.c_void_p]
    lib.hvd_autotune_best.restype = c.c_double
    lib.hvd_autotune_best.argtypes = [c.c_void_p, c.POINTER(c.c_double)]


# ---------------------------------------------------------------- fusion

def fusion_plan(
    sizes_bytes: Sequence[int], dtype_ids: Sequence[int], threshold_bytes: int
) -> Optional[List[List[int]]]:
    """Native bucket plan; None when the native core is unavailable."""
    lib = load()
    if lib is None:
        return None
    n = len(sizes_bytes)
    sizes = (ctypes.c_int64 * n)(*sizes_bytes)
    dtypes = (ctypes.c_int32 * n)(*dtype_ids)
    out = (ctypes.c_int64 * n)()
    nb = lib.hvd_fusion_plan(sizes, dtypes, n, threshold_bytes, out)
    if nb < 0:
        return None
    buckets: List[List[int]] = [[] for _ in range(nb)]
    for i in range(n):
        buckets[out[i]].append(i)
    return buckets


# -------------------------------------------------------------- autotune

class Autotune:
    """GP/EI tuner over log2(fusion threshold bytes)."""

    def __init__(self, low_log2_bytes: float = 16.0, high_log2_bytes: float = 28.0):
        self._lib = load()
        if self._lib is None:
            raise RuntimeError("native core unavailable")
        self._h = self._lib.hvd_autotune_new(low_log2_bytes, high_log2_bytes)

    def observe(self, log2_bytes: float, score: float) -> None:
        self._lib.hvd_autotune_observe(self._h, log2_bytes, score)

    def suggest(self) -> float:
        return self._lib.hvd_autotune_suggest(self._h)

    def best(self) -> Tuple[float, float]:
        score = ctypes.c_double(0)
        x = self._lib.hvd_autotune_best(self._h, ctypes.byref(score))
        return x, score.value

    def close(self) -> None:
        if self._h:
            self._lib.hvd_autotune_free(self._h)
            self._h = None


# ------------------------------------------------------------------ wire

# Request types (reference message.h:50-121)
REQUEST_ALLREDUCE = 0
REQUEST_ALLGATHER = 1
REQUEST_BROADCAST = 2
REQUEST_JOIN = 3
REQUEST_ADASUM = 4
REQUEST_ALLTOALL = 5
REQUEST_REDUCESCATTER = 6
REQUEST_BARRIER = 7

# Response types echo the request type; ERROR signals a rejected
# submission (reference message.h ResponseType).
RESPONSE_ERROR = 8


def encode_request(rank: int, rtype: int, dtype: int, root: int,
                   dims: Sequence[int], name: str) -> bytes:
    lib = load()
    if lib is None:
        raise RuntimeError("native core unavailable")
    cap = 64 + 8 * len(dims) + len(name)
    out = (ctypes.c_uint8 * cap)()
    dims_arr = (ctypes.c_int64 * max(1, len(dims)))(*dims) if dims else None
    n = lib.hvd_wire_encode_request(
        rank, rtype, dtype, root, dims_arr, len(dims), name.encode(), out, cap
    )
    if n < 0:
        raise ValueError("encode failed")
    return bytes(out[:n])


def decode_request(buf: bytes):
    lib = load()
    if lib is None:
        raise RuntimeError("native core unavailable")
    arr = (ctypes.c_uint8 * len(buf)).from_buffer_copy(buf)
    rank = ctypes.c_int32()
    rtype = ctypes.c_int32()
    dtype = ctypes.c_int32()
    root = ctypes.c_int32()
    ndim = ctypes.c_int32()
    dims = (ctypes.c_int64 * 16)()
    name = ctypes.create_string_buffer(4096)
    consumed = lib.hvd_wire_decode_request(
        arr, len(buf), ctypes.byref(rank), ctypes.byref(rtype),
        ctypes.byref(dtype), ctypes.byref(root), dims, 16, ctypes.byref(ndim),
        name, len(name),
    )
    if consumed < 0:
        raise ValueError("decode failed")
    return {
        "rank": rank.value,
        "type": rtype.value,
        "dtype": dtype.value,
        "root": root.value,
        "dims": list(dims[: ndim.value]),
        "name": name.value.decode(),
        "consumed": consumed,
    }


def encode_response(rtype: int, names: Sequence[str], error: str = "",
                    sizes: Sequence[int] = ()) -> bytes:
    lib = load()
    if lib is None:
        raise RuntimeError("native core unavailable")
    names_b = "\n".join(names).encode()
    error_b = error.encode()
    # cap from BYTE lengths (multibyte text expands past char counts)
    cap = 64 + len(names_b) + len(error_b) + 8 * len(sizes)
    out = (ctypes.c_uint8 * cap)()
    sizes_arr = (
        (ctypes.c_int64 * max(1, len(sizes)))(*sizes) if sizes else None
    )
    n = lib.hvd_wire_encode_response(
        rtype, names_b, error_b, sizes_arr, len(sizes), out, cap,
    )
    if n < 0:
        raise ValueError("encode failed")
    return bytes(out[:n])


def decode_response(buf: bytes):
    lib = load()
    if lib is None:
        raise RuntimeError("native core unavailable")
    arr = (ctypes.c_uint8 * len(buf)).from_buffer_copy(buf)
    rtype = ctypes.c_int32()
    nsizes = ctypes.c_int32()
    # every size costs 8 wire bytes, so len(buf)//8 + 1 can hold them all
    sizes_cap = len(buf) // 8 + 1
    sizes = (ctypes.c_int64 * sizes_cap)()
    names = ctypes.create_string_buffer(max(8192, len(buf) + 1))
    err = ctypes.create_string_buffer(max(4096, len(buf) + 1))
    consumed = lib.hvd_wire_decode_response(
        arr, len(buf), ctypes.byref(rtype), names, len(names), err,
        len(err), sizes, sizes_cap, ctypes.byref(nsizes),
    )
    if consumed < 0:
        raise ValueError("decode failed")
    names_s = names.value.decode()
    return {
        "type": rtype.value,
        "names": names_s.split("\n") if names_s else [],
        "error": err.value.decode(),
        "sizes": list(sizes[: nsizes.value]),
        "consumed": consumed,
    }


if __name__ == "__main__":
    import sys

    if "--build" in sys.argv:
        lib = load(build=True)
        print("built:", lib_path() if lib is not None else "FAILED")
        sys.exit(0 if lib is not None else 1)
    print("usage: python -m horovod_tpu_torch.native --build")
