"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` exports plain C launch functions and is compiled by
``nvcc`` for Hopper (``sm_90a``) into its own shared library, loaded with
``ctypes``.  Nothing is built when a module is imported: the first call that
needs a library builds it, into ``build/kernels/`` at the root of the
checkout (listed in ``.gitignore``), under a name that carries the hash of
the source and the flags — an edited source rebuilds, an unchanged one
loads the library already built.  ``build_all`` starts one ``nvcc`` per
source at once and waits for all of them.

Numerics flags: ``--fmad=false`` (no multiply contracted into an add),
``-prec-div=true`` and ``-prec-sqrt=true`` (correctly rounded division and
square root), never ``--use_fast_math`` — the reference floors float32
scores, and one ulp can move a floor and so a binding.

The host C++ sources (``HOST_SOURCES``: preemption's reprieve sweep and
ranking, ``csrc/preempt_sweep.cpp``) build the same way with ``g++ -O2
-shared -fPIC`` beside them; ``build_all`` starts those too.

A failed build raises; there is no fallback to the plain version.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, List

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "kernels"

SOURCES = ("filter_score", "normalize_combine", "topk_rows", "auction", "spread",
           "interpodaffinity", "prev_delta", "scatter_rows", "scan", "gang", "cosched",
           "diag_pack", "selector_match", "dra", "preempt", "fork", "selectorspread",
           "tie_noise")
# host C++ libraries (plain C interface, loaded with ctypes like the kernels)
HOST_SOURCES = ("preempt_sweep",)
GXX_FLAGS = ["-O2", "-shared", "-fPIC"]

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3",
    "--fmad=false", "-prec-div=true", "-prec-sqrt=true", "-ftz=false",
    "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()
# nvcc builds started by this process (a measured window that builds a
# kernel pays the build inside it; the perf harness reports the count)
BUILDS = 0
# ptxas resource reports (registers, shared memory, spills) per source,
# from the build that produced the loaded library
PTXAS_LOG: Dict[str, str] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine "
                       "with the CUDA toolkit (PATH or /usr/local/cuda/bin)")


def gxx_path() -> str:
    found = shutil.which("g++")
    if found:
        return found
    raise RuntimeError("g++ not found: the host C++ libraries are built with it")


def _is_host(name: str) -> bool:
    return name in HOST_SOURCES


def _source(name: str) -> Path:
    return CSRC / (f"{name}.cpp" if _is_host(name) else f"{name}.cu")


def _lib_path(name: str) -> Path:
    src = _source(name).read_bytes()
    flags = GXX_FLAGS if _is_host(name) else NVCC_FLAGS
    h = hashlib.sha256(src + " ".join(flags).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{h}.so"


def _start(name: str):
    """Start the build of one source (nvcc, or g++ for a host source); →
    (Popen, tmp path, final path) or None when the library is already
    built."""
    global BUILDS
    out = _lib_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    BUILDS += 1
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    if _is_host(name):
        cmd = [gxx_path(), *GXX_FLAGS, "-o", str(tmp), str(_source(name))]
    else:
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(_source(name))]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return proc, tmp, out


def _finish(name: str, started) -> None:
    if started is None:
        log = _lib_path(name).with_suffix(".log")
        if log.exists():
            PTXAS_LOG.setdefault(name, log.read_text())
        return
    proc, tmp, out = started
    text, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"{proc.args[0]} failed for csrc/{_source(name).name} "
                           f"(exit {proc.returncode}):\n{text}")
    os.replace(tmp, out)
    out.with_suffix(".log").write_text(text)
    PTXAS_LOG[name] = text


def build_all(names: Iterable[str] = SOURCES + HOST_SOURCES) -> List[Path]:
    """Build every named source in parallel (one nvcc or g++ each); →
    library paths."""
    names = list(names)
    started = {n: _start(n) for n in names}
    for n in names:
        _finish(n, started[n])
    return [_lib_path(n) for n in names]


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu`` (or a host source's
    ``.cpp``), built on first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            _finish(name, _start(name))
            lib = ctypes.CDLL(str(_lib_path(name)))
            _LIBS[name] = lib
        return lib


def check(err: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launch function."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t {err}")
