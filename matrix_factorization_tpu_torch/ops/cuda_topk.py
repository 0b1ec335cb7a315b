"""Hand-written CUDA top-k selection under the port's tie rule.

The kernels ``csrc/topk_select.cu`` select and order the k largest of each
row of (rows, n) f32 scores by score descending, then position ascending
(``-0.0`` as ``0.0``, a NaN first): the rule of ``ops/scoring.py::
stable_topk``. They replace no TPU kernel (the JAX package's top-k is
``lax.top_k``). Each score and its position form one 64-bit key, so the k
largest keys are exactly the rule's answer: no tie test, no second pass,
no host sync. The source says what bounds them and how they are laid out.

``cuda_select_topk`` launches the pair and only takes CUDA tensors;
``select_plan`` is its launch plan, computed here so that the CPU tests
reach it. The plain version is ``ops/scoring.py::_plain_select_topk`` (the
CPU path of ``_select_topk``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from matrix_factorization_tpu_torch.ops import _build

# Shapes of csrc/topk_select.cu; the kernel refuses a plan outside them.
THREADS = 256         # threads a block
POOL = 4096           # keys of a block's shared-memory pool
MAX_K = 1024          # the largest k the kernel takes
MIN_CHUNK = 16_384    # the fewest scores a chunk, at k <= 512
CHUNK_PER_K = 32      # ... and at least this many scores a kept key

_vp, _ci, _cl = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
LIB = _build.Library("topk_select", {
    "mf_topk_select": ([_vp, _cl, _cl, _ci, _ci, _cl, _vp, _vp, _vp, _vp], _ci),
    "mf_topk_blocks_per_sm": ([], _ci),  # a count, not a status: called raw
}, error="mf_topk_error_string")


class SelectPlan(NamedTuple):
    """How ``mf_topk_select`` covers a (rows, n) call: ``chunks`` blocks a
    row, each over ``chunk_len`` scores (the last may be shorter); with
    one chunk a row the chunk kernel writes the answer, with more a merge
    kernel takes the chunks' k candidates."""

    chunks: int
    chunk_len: int


def select_plan(rows: int, n: int, k: int, n_sms: int,
                blocks_per_sm: int) -> SelectPlan:
    """Chunks a row so that ``rows * chunks`` blocks fill the card's
    resident slots (``blocks_per_sm`` on each of ``n_sms`` SMs) in one
    wave: a block more would run alone in a second wave. No chunk is
    shorter than ``MIN_CHUNK`` or ``CHUNK_PER_K * k`` scores (the
    candidates stay a small share of the scores); chunk lengths are
    multiples of 4 and no chunk is empty. Rows past the slots take one
    chunk each, in as many waves as they need."""
    if rows <= 0 or n <= 0 or not 0 < k <= min(n, MAX_K):
        raise ValueError(f"no plan for rows={rows} n={n} k={k}")
    chunks = n_sms * blocks_per_sm // rows
    chunks = max(1, min(chunks, n // max(MIN_CHUNK, CHUNK_PER_K * k)))
    chunk_len = -(-(-(-n // chunks)) // 4) * 4
    chunks = -(-n // chunk_len)
    if rows * chunks > 2**31 - 1:
        raise ValueError(f"{rows} rows need more than 2^31 - 1 blocks")
    return SelectPlan(chunks, chunk_len)


@functools.cache
def blocks_per_sm() -> int:
    """Resident chunk blocks an SM holds, as the built kernel's registers
    and shared memory allow (the CUDA occupancy query, asked once)."""
    b = LIB.fn("mf_topk_blocks_per_sm")()
    if b <= 0:
        raise RuntimeError("topk_select: the occupancy query failed")
    return b


def cuda_select_topk(s: torch.Tensor, k: int):
    """(rows, k) f32 scores and int64 positions of each row's k largest
    under the tie rule, from the CUDA kernels, on ``s``'s stream; no host
    sync. ``s``: a contiguous 2-D f32 CUDA tensor; 0 <= k <= min(n,
    ``MAX_K``)."""
    if s.device.type != "cuda":
        raise ValueError(f"cuda_select_topk takes a CUDA tensor, got {s.device}")
    if s.dtype != torch.float32:
        raise ValueError(f"cuda_select_topk takes float32 scores, not {s.dtype}")
    if s.dim() != 2 or not s.is_contiguous():
        raise ValueError("cuda_select_topk takes a contiguous 2-D tensor")
    rows, n = s.shape
    if not 0 <= k <= min(n, MAX_K) or n > 2**31 - 1:
        raise ValueError(f"cuda_select_topk takes 0 <= k <= min(n, {MAX_K}) "
                         f"and n < 2^31, got k={k}, n={n}")
    vals = torch.empty((rows, k), dtype=torch.float32, device=s.device)
    idx = torch.empty((rows, k), dtype=torch.int64, device=s.device)
    if rows == 0 or k == 0:
        return vals, idx
    plan = select_plan(rows, n, k, _build.sm_count(s.device), blocks_per_sm())
    cand = (torch.empty((rows, plan.chunks, k), dtype=torch.int64,
                        device=s.device) if plan.chunks > 1 else None)
    LIB("mf_topk_select",
        s.data_ptr(), rows, n, k, plan.chunks, plan.chunk_len,
        None if cand is None else cand.data_ptr(), vals.data_ptr(),
        idx.data_ptr(), torch.cuda.current_stream(s.device).cuda_stream)
    return vals, idx
