"""Build the port's CUDA sources into shared libraries loaded with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by
``nvcc`` for Hopper (``sm_90a``) on first use, into ``_build/`` beside
the sources (listed in ``.gitignore``).  The library's file name carries
a hash of the source, of every ``csrc`` header it includes and of the
flags, so an edited source or header is rebuilt and a stale library is
never loaded.  :func:`build` starts one ``nvcc`` per
source, all at once, and waits for them together.

No JAX counterpart: the JAX package's kernels are Pallas and compile
inside XLA.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Sequence

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}
# Compiler output of each build this process ran (ptxas register and
# spill report), by source name.
build_logs: Dict[str, str] = {}


def nvcc() -> str:
    """Path of the CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else the one on
    ``PATH``, else the toolkit's default location."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME); the port's CUDA kernels are built "
        "from horovod_tpu_torch/csrc at first use"
    )


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def _sources(path: Path, seen: Dict[Path, bytes]) -> Dict[Path, bytes]:
    """``path`` and every file beside it that it includes with quotes,
    transitively, with their contents."""
    if path not in seen:
        text = seen[path] = path.read_bytes()
        for inc in _INCLUDE.findall(text):
            dep = (path.parent / inc.decode()).resolve()
            if dep.exists():
                _sources(dep, seen)
    return seen


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path, text in sorted(_sources((CSRC / f"{name}.cu").resolve(), {}).items()):
        h.update(path.name.encode() + b"\0" + text)
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Sequence[str]) -> Dict[str, Path]:
    """Compile every source in ``names`` that has no current library, one
    ``nvcc`` each, all started together.  Raises with the compiler's
    output if any of them fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {n: library_path(n) for n in names}
    procs = {}
    for n, path in paths.items():
        if path.exists():
            continue
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ))
    failed = []
    for n, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        build_logs[n] = out
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {n}.cu (rc {proc.returncode}):\n{out}")
            tmp.unlink(missing_ok=True)
        else:
            # Atomic publish: ranks building at once never load a torn file.
            os.replace(tmp, paths[n])
    if failed:
        raise RuntimeError("\n".join(failed))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            path = build([name])[name]
            lib = _loaded[name] = ctypes.CDLL(str(path))
        return lib
