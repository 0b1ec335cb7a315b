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
from typing import Dict, Iterable, Optional, Sequence, Tuple

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")
SMEM_LIMIT = 232_448  # dynamic shared memory a block may take on sm_90 (kMaxSmem)

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
build_logs: Dict[str, str] = {}  # name -> compiler output (registers, spills)
_count_lock = threading.Lock()
_launches: Dict[str, int] = {}  # entry point -> zero returns of the checked call
_sm_counts: Dict[int, int] = {}  # CUDA device index -> its SMs


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


Signature = Tuple[Sequence[type], Optional[type]]  # (argtypes, restype)
LIBRARIES: Dict[str, "Library"] = {}  # source name -> its bound library


class Library:
    """The binding of ``csrc/<name>.cu`` or ``.cpp``: ``entries`` maps each
    C entry point of the source to its ``ctypes`` (argument types, return
    type), exactly as the source declares it; ``error`` names the source's
    function from a non-zero status to its message (declared here), or is
    None. Nothing is built or loaded until the first call."""

    def __init__(self, name: str, entries: Dict[str, Signature],
                 error: Optional[str] = None):
        self.name = name
        self.entries = dict(entries)
        if error is not None:
            self.entries[error] = ([ctypes.c_int], ctypes.c_char_p)
        self.error = error
        self._lib: Optional[ctypes.CDLL] = None
        LIBRARIES[name] = self

    def cdll(self) -> ctypes.CDLL:
        """The loaded library, every entry point of the table bound; built
        on first use."""
        lib = self._lib
        if lib is None:
            loaded = load(self.name)
            with _lock:
                if self._lib is None:
                    for entry, (argtypes, restype) in self.entries.items():
                        fn = getattr(loaded, entry)
                        fn.argtypes = list(argtypes)
                        fn.restype = restype
                    self._lib = loaded
                lib = self._lib
        return lib

    def fn(self, entry: str):
        """The bound entry point ``entry``, called raw; ``ValueError`` for a
        name that is not in the table."""
        if entry not in self.entries:
            raise ValueError(f"{entry} is not an entry point of {self.name}")
        return getattr(self.cdll(), entry)

    def __call__(self, entry: str, *args) -> None:
        """The checked call of the status entry point ``entry``: a non-zero
        return raises ``RuntimeError`` with the library's message and counts
        nothing; a zero return counts one launch of ``entry``. An entry
        point outside the table, or one that returns no status, is refused."""
        if self.entries.get(entry, (None, None))[1] is not ctypes.c_int:
            raise ValueError(f"{entry} is not a status entry point of {self.name}")
        rc = getattr(self.cdll(), entry)(*args)
        if rc != 0:
            msg = (self.fn(self.error)(rc).decode() if self.error is not None
                   else f"status {rc}")
            raise RuntimeError(f"{entry} failed: {msg}")
        with _count_lock:
            _launches[entry] = _launches.get(entry, 0) + 1


def _declared(entries: Tuple[str, ...]) -> None:
    known = {e for lib in LIBRARIES.values() for e in lib.entries}
    for entry in entries:
        if entry not in known:
            raise ValueError(f"{entry} is not an entry point of a bound library")


def launches(*entries: str) -> int:
    """Launches of the named entry points together (zero returns of the
    checked call) since import or their last :func:`reset_launches`."""
    _declared(entries)
    with _count_lock:
        return sum(_launches.get(e, 0) for e in entries)


def reset_launches(*entries: str) -> None:
    """Zero the launch counts of the named entry points, or of every entry
    point when none is named."""
    _declared(entries)
    with _count_lock:
        if not entries:
            _launches.clear()
        for entry in entries:
            _launches.pop(entry, None)


def sm_count(device) -> int:
    """SMs of the CUDA ``device`` (a ``torch.device``), asked once a card."""
    import torch

    idx = device.index if device.index is not None else torch.cuda.current_device()
    n = _sm_counts.get(idx)
    if n is None:
        n = _sm_counts[idx] = torch.cuda.get_device_properties(
            idx).multi_processor_count
    return n


def check(name: str, t, device, dtype, shape=None, aligned: bool = False) -> None:
    """``ValueError`` unless the tensor ``t`` (the argument ``name``) lies on
    ``device``, has ``dtype``, is contiguous, with ``aligned`` starts on a
    16-byte boundary, and has ``shape`` where one is given."""
    if t.device != device:
        raise ValueError(f"{name} must be on {device}, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if aligned and t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
