"""Tracing and timing (PyTorch port of
``matrix_factorization_tpu/utils/profiling.py``).

* :class:`Timer` — wall-clock block timer that forces device completion
  (``torch.cuda.synchronize`` plus a host sum of each given tensor) before
  it reads the clock: CUDA calls return before the card has finished.
* :func:`trace` — a ``torch.profiler`` trace (CPU and, with a GPU, CUDA
  activity) written as a Chrome trace into a directory; a no-op when the
  profiler cannot start, as JAX's is.
* :func:`span` — a named range of the program in that same trace, so that
  the program's spans, the aten operators and the CUDA kernels they
  launch share one clock.

**Spans.** A span is recorded exactly when a ``torch.profiler`` is
recording (under :func:`trace`, or any other ``torch.profiler.profile``);
otherwise ``span`` returns one shared null context, and its cost is the
read of the profiler's flag. There is no other switch. Each is named
``mf:<name>`` in the trace and recorded as a ``cpu_op`` event by torch's
``_RecordFunctionFast`` (about 2 us a span, against about 14 us for
``record_function``). A span opens
at a batch, bucket, block or call boundary, never inside a per-row or
per-entity loop. The device work of a span is the kernels, copies and
memsets whose launch (the CUDA runtime call, matched to its device
interval by the trace's correlation id) lies innermost in it.

SGD (``ops/segment_sgd.py``), nested as listed:

* ``sgd.epoch`` — one epoch of ``sgd_train``, with its RMSE pass when on;
* ``sgd.step`` — ``cuda_sgd.sgd_step`` of one batch (``minibatch_update``);
* ``sgd.apply`` — ``segment_sum.segment_apply`` of one batch;
* ``sgd.rmse`` — ``masked_sse``, the RMSE pass (also under ``als.epoch``).

ALS (``ops/ials.py``, ``ops/spd.py``):

* ``als.epoch`` — one epoch of ``ials_train_bucketed`` or ``ials_train``;
* ``als.bucket`` — ``bucket_sweep`` (one bucket chunk) or ``grouped_sweep``
  (one half-sweep), inside ``als.epoch``;
* ``als.normal_eq`` — ``normal_equations``: the grams, the ridge and the
  right-hand sides (off CUDA also the design gather and the mask), inside
  ``als.bucket``;
* ``als.gram_kernel`` — the call of ``ops/cuda_normal_eq.py``'s kernel
  (its ridge values, launch and, for lists longer than its slice, the
  finish kernel), inside ``als.normal_eq``; entered only on CUDA, so its
  count is the kernel's calls (one a ``normal_equations`` call: a bucket
  chunk or each piece of one; 0 on the CPU);
* ``spd.solve`` — ``spd_solve``: Jacobi scaling, the solve and the
  refinement, inside ``als.bucket`` (beside ``als.normal_eq``);
* ``spd.split`` — the block solve's split (``cuda_spd_solve.spd_split``:
  the scaling and the three blocks), inside ``spd.solve`` for
  128 < d <= 232;
* ``spd.schur`` — one level of ``spd_inverse`` above the leaf (``W``,
  ``S``, ``B12``, ``B11`` and the writes of the four blocks), inside
  ``spd.solve``, ``ease.inverse`` or an outer ``spd.schur``; in the block
  solve its two products (``W`` and ``S``, in place), inside
  ``spd.solve``;
* ``spd.leaf`` — the leaf inverse (``cuda_spd.gj_inverse``, or
  ``_base_inverse`` with ``leaf='cholesky'``), inside ``spd.schur`` or
  directly inside ``spd.solve`` (for d up to the leaf's size, and the
  block solve's two leaves);
* ``spd.backsolve`` — the block solve's back-solve and refinement
  (``cuda_spd_solve.block_solve``), inside ``spd.solve``;
* ``als.write`` — the write of the solutions into the swept table, inside
  ``als.bucket``.

EASE (``ops/ease.py``; ``EASE.fit`` on one data rank runs all three):

* ``ease.gram`` — ``gram_scan``: the chunks' slabs and products, the int8
  path's conversion to f32 included;
* ``ease.inverse`` — ``spd_inverse_scaled`` of ``G + lam I`` (Jacobi
  scaling, the Schur recursion with its ``spd.schur`` and ``spd.leaf``
  spans, one Newton-Schulz refinement), in ``fit_packed`` and
  ``ease_weights``;
* ``ease.closed_form`` — ``_closed_form``: ``B = -P / diag(P)`` over ``P``.

Search (``retrieval/search.py``, ``ops/scoring.py``):

* ``search.query`` — ``search_topk_batch``'s lookup of the index's device
  copy and the queries' host-to-device copy;
* ``search.gemm`` — one row block's ``q @ emb.T`` in ``dense_topk``;
* ``topk.sort`` / ``topk.select`` — the body ``stable_topk`` takes for a
  block (the whole-row sort, or the selection), after its ``search.gemm``;
* ``topk.sync`` — ``_plain_select_topk``'s ``nonzero()``: the host's wait
  for the block's count of rows tied across the cut, inside
  ``topk.select``; only off CUDA (the CUDA kernel of ``ops/cuda_topk.py``
  has no tie test and never syncs);
* ``topk.ties`` — ``_plain_select_topk``'s tie branch, inside
  ``topk.select``, off CUDA only; entered only when a block has a row tied
  across the cut, so its count is the count of such blocks;
* ``search.fetch`` — ``dense_topk``'s ``torch.cat`` of the blocks' answers,
  and ``search_topk_batch``'s copy of them to host arrays (two a call);
* ``search.answer`` — ``search_topk_pos``'s ``(pos, item_id, score)`` list.

The mesh trainers and the mesh search call these same functions, so
their spans are these; ``parallel/`` opens none of its own.
"""

from __future__ import annotations

import contextlib
import os
import time
import warnings
from pathlib import Path
from typing import Optional

import torch
import torch.autograd.profiler as _autograd_profiler
from torch._C._profiler import _RecordFunctionFast

SPAN_PREFIX = "mf:"
_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """``with span("sgd.step"): ...`` records the block as ``mf:sgd.step``
    while a ``torch.profiler`` records, and does nothing otherwise (the
    module docstring lists the spans)."""
    if not _autograd_profiler._is_profiler_enabled:
        return _NO_SPAN
    return _RecordFunctionFast(SPAN_PREFIX + name)


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

