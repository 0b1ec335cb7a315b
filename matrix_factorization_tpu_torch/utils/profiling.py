"""Tracing / profiling / throughput observability (PyTorch port of
``matrix_factorization_tpu/utils/profiling.py``).

* :class:`Timer` — wall-clock block timer that forces device completion
  (``torch.cuda.synchronize`` plus a host sum of each given tensor) before
  it reads the clock: CUDA calls return before the card has finished.
* :class:`ThroughputMeter` — rating-updates/sec/chip counter.
* :func:`trace` — a ``torch.profiler`` trace (CPU and, with a GPU, CUDA
  activity) written as a Chrome trace into a directory; a no-op when the
  profiler cannot start, as JAX's is.
* :class:`EpochLogger` — per-epoch RMSE/throughput logging like the
  reference's verbose prints (``kernel_matrix_factorization.py:442-443``).
"""

from __future__ import annotations

import contextlib
import os
import time
import warnings
from dataclasses import dataclass, field
from pathlib import Path
from typing import List, Optional

import torch


def force_completion(*arrays) -> float:
    """Wait for the device work behind each tensor (a CUDA tensor's device
    is synchronized) and return the host sum of all of them."""
    total = 0.0
    for a in arrays:
        t = torch.as_tensor(a)
        if t.device.type == "cuda":
            torch.cuda.synchronize(t.device)
        total += float(t.sum())
    return total


class Timer:
    """``with Timer() as t: ...`` then ``t.seconds``."""

    def __init__(self, sync_arrays=()):
        self._sync = tuple(sync_arrays)
        self.seconds = 0.0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        for a in self._sync:
            force_completion(a)
        self.seconds = time.perf_counter() - self._t0
        return False


@dataclass
class ThroughputMeter:
    """Accumulates (updates, seconds) and reports updates/sec/chip."""

    n_chips: int = 1
    total_updates: int = 0
    total_seconds: float = 0.0

    def record(self, n_updates: int, seconds: float) -> None:
        self.total_updates += int(n_updates)
        self.total_seconds += float(seconds)

    @property
    def updates_per_sec(self) -> float:
        return self.total_updates / self.total_seconds if self.total_seconds else 0.0

    @property
    def updates_per_sec_per_chip(self) -> float:
        return self.updates_per_sec / max(1, self.n_chips)

    def report(self) -> dict:
        return {
            "updates_per_sec": self.updates_per_sec,
            "updates_per_sec_per_chip": self.updates_per_sec_per_chip,
            "total_updates": self.total_updates,
            "total_seconds": self.total_seconds,
            "n_chips": self.n_chips,
        }


@contextlib.contextmanager
def trace(log_dir: Optional[str]):
    """``torch.profiler`` trace of the block, written as a Chrome trace
    (``trace_<pid>_<ns>.json``) into ``log_dir``; CUDA activity (every
    kernel, whoever launched it) is traced when a GPU is present. A
    profiler that fails to start or stop warns and leaves the block to run
    untraced, as JAX's ``jax.profiler`` context does."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    try:
        prof.__enter__()
        started = True
    except Exception as e:  # noqa: BLE001 — the traced work runs regardless
        warnings.warn(f"the profiler did not start ({e!r}); running untraced")
        started = False
    try:
        yield
    finally:
        if started:
            try:
                if torch.cuda.is_available():
                    torch.cuda.synchronize()
                prof.__exit__(None, None, None)
                out = Path(log_dir)
                out.mkdir(parents=True, exist_ok=True)
                prof.export_chrome_trace(
                    str(out / f"trace_{os.getpid()}_{time.time_ns()}.json"))
            except Exception as e:  # noqa: BLE001
                warnings.warn(f"the profiler did not stop cleanly ({e!r})")


@dataclass
class EpochLogger:
    verbose: int = 1
    history: List[dict] = field(default_factory=list)

    def log(self, epoch: int, rmse: float, n_updates: int = 0,
            seconds: float = 0.0) -> None:
        row = {"epoch": epoch, "rmse": rmse}
        if seconds > 0:
            row["updates_per_sec"] = n_updates / seconds
        self.history.append(row)
        if self.verbose:
            extra = (
                f"  ({row['updates_per_sec'] / 1e6:.1f}M updates/s)"
                if "updates_per_sec" in row else ""
            )
            print(f"Epoch {epoch} train RMSE: {rmse:.4f}{extra}")
