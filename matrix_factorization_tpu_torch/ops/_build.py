"""Build the port's native sources and load them with ``ctypes``.

Each ``csrc/<name>.cu`` (a CUDA kernel) or ``csrc/<name>.cpp`` (the host
helpers of ``host_loader.cpp``) has a plain C interface and is compiled at
first use, by ``nvcc`` for Hopper or by the host's ``g++``, into
``build/lib<name>-<hash>.so`` at the root of the checkout (a directory git
ignores). The hash is that of the source and the flags, so an edited
source is rebuilt and a stale library is never loaded. The compiler writes
to a temporary name that is then renamed into place, so processes that
build at once never load a half-written library. A failed build raises;
nothing falls back to another path.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
build_logs: Dict[str, str] = {}  # name -> compiler output (registers, spills)


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError("nvcc was not found: the CUDA kernels cannot be built")


def _gxx() -> str:
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ was not found: the host helpers cannot be built")
    return gxx


def _source(name: str) -> Path:
    cu = CSRC / f"{name}.cu"
    return cu if cu.exists() else CSRC / f"{name}.cpp"


def _flags(src: Path):
    return NVCC_FLAGS if src.suffix == ".cu" else GXX_FLAGS


def _target(name: str) -> Path:
    src = _source(name)
    digest = hashlib.sha256(src.read_bytes() + " ".join(_flags(src)).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def _start(name: str):
    """Start the compiler for ``name`` unless its library is built;
    returns (target, process or None)."""
    out = _target(name)
    if out.exists():
        return out, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # the pid and thread keep concurrent builders' temporaries apart
    tmp = out.with_suffix(f".{os.getpid()}-{threading.get_ident()}.tmp")
    src = _source(name)
    compiler = _nvcc() if src.suffix == ".cu" else _gxx()
    proc = subprocess.Popen(
        [compiler, *_flags(src), "-o", str(tmp), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    return out, (proc, tmp)


def _finish(name: str, out: Path, job) -> None:
    if job is None:
        return
    proc, tmp = job
    log, _ = proc.communicate()
    build_logs[name] = log
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"the compiler failed to build "
                           f"{_source(name).name}:\n{log}")
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing


def build(names: Iterable[str]) -> float:
    """Build the named sources, all compiler processes at once; returns
    the wall seconds taken."""
    t0 = time.perf_counter()
    with _lock:
        jobs = [(n, *_start(n)) for n in names]
        for name, out, job in jobs:
            _finish(name, out, job)
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` or ``.cpp``, built on
    first use."""
    lib = _libs.get(name)
    if lib is None:
        build([name])
        with _lock:
            lib = _libs.get(name)
            if lib is None:
                lib = _libs[name] = ctypes.CDLL(str(_target(name)))
    return lib
