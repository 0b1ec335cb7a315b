"""Deterministic sorted-segment sums (PyTorch port).

``segment_sum(out, vals, perm, ids_sorted)`` computes
``out[ids_sorted[j]] += vals[perm[j]]`` in place: the port's counterpart
of ``jax.ops.segment_sum`` and ``.at[].add``, which the bias, count and
profile reductions of ``ops/als.py`` and the content model use. On the
card it is the hand-written kernel ``mf_segment_sum`` of
``csrc/segment_sum.cu``, whose source says what bounds it and how it is
laid out: the stream is cut into chunks of ``CHUNK`` entries, a warp a
chunk; at ``d <= ENTRIES_MAX_D`` (the bias, count and residual sums) the
lanes own slices of ``SLICE`` entries, at wider rows they own columns.
A run of equal ids is summed in a fixed order from zero, and a run that
crosses a chunk boundary is summed in pieces that a second launch adds in
chunk order. One writer a row, no float atomics, so the same inputs give
the same bits. ``index_add_`` and its relatives add with float atomics
on CUDA, in an order that changes from run to run, and appear on no CUDA
path of the port. The same source holds ``mf_segment_apply``, the SGD
step's secondary apply (``ops/cuda_sgd.py::cuda_segment_apply``), on the
same scheme with rows of float4 lanes.

``sorted_order(ids)`` gives the ``(perm, ids_sorted)`` the sum takes: a
stable ``torch.sort`` on the ids' device. ``plain_segment_sum`` is
``index_add_`` of ``vals[perm]`` at ``ids_sorted``, which on the CPU adds
in ``j`` order; the CPU path and the comparisons on the card use it.
``segmented_segment_sum`` is the kernels' summation in plain PyTorch, bit
for bit: the tests of its boundary logic use it, and the checks on the
card hold both kernels to it with ``torch.equal``. ``segment_sum`` picks
by the tensors' device: a CUDA tensor always launches the kernel.
"""

from __future__ import annotations

import ctypes
import threading
from typing import NamedTuple, Optional, Tuple

import torch

# The launch geometry; csrc/segment_sum.cu is compiled for the same values
# (kChunk, kWarps, MF_ENTRIES_MAX_D) and refuses any other.
CHUNK = 256  # consecutive entries one warp owns
SLICE = CHUNK // 32  # consecutive entries one lane owns (entries layout)
ENTRIES_MAX_D = 1  # widest rows the entries layout takes
WARPS = 8  # warps a block
LAYOUTS = ("columns", "entries")  # the C entry's layout codes 0 and 1

_count_lock = threading.Lock()
launches = 0  # mf_segment_sum calls since import or reset_launches()


def reset_launches() -> None:
    global launches
    with _count_lock:
        launches = 0


def _count() -> None:
    global launches
    with _count_lock:
        launches += 1


_lib = None


def _library():
    global _lib
    if _lib is None:
        from matrix_factorization_tpu_torch.ops import _build

        lib = _build.load("segment_sum")
        vp, ci, cll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.mf_segment_sum.argtypes = [vp, vp, vp, vp, cll, ci, vp, ci, ci,
                                       cll, cll, cll, vp]
        lib.mf_segment_sum.restype = ci
        lib.mf_segment_apply.argtypes = [vp, vp, vp, vp, cll, ci, vp, ci, cll,
                                         cll, cll, vp]
        lib.mf_segment_apply.restype = ci
        lib.mf_segment_sum_error_string.argtypes = [ci]
        lib.mf_segment_sum_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def sorted_order(ids: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(perm, ids_sorted)``, both int32 on ``ids``' device: the stable
    ascending sort of ``ids`` (equal ids keep their order, so the sum
    over a segment runs in input order)."""
    ids_sorted, perm = torch.sort(ids.reshape(-1), stable=True)
    return perm.to(torch.int32), ids_sorted.to(torch.int32)


def _as_2d(out: torch.Tensor, vals: torch.Tensor):
    """(rows, d) / (n, d) views of ``out`` and ``vals``; 1-D tensors are
    one column."""
    if out.dim() == 1 and vals.dim() == 1:
        return out.view(-1, 1), vals.view(-1, 1)
    if out.dim() != 2 or vals.dim() != 2 or out.shape[1] != vals.shape[1]:
        raise ValueError(f"out {tuple(out.shape)} and vals "
                         f"{tuple(vals.shape)} must be (rows, d) and (n, d) "
                         f"or both 1-D")
    return out, vals


# ---------------------------------------------------------------------------
# Plain PyTorch versions (CPU tensors, and the comparisons on the card)
# ---------------------------------------------------------------------------


def plain_segment_sum(out: torch.Tensor, vals: torch.Tensor,
                      perm: torch.Tensor, ids_sorted: torch.Tensor) -> None:
    """``out[ids_sorted[j]] += vals[perm[j]]`` by ``index_add_``."""
    out2, vals2 = _as_2d(out, vals)
    out2.index_add_(0, ids_sorted.long(), vals2[perm.long()])


def _piece_sums(g: torch.Tensor, starts: torch.Tensor,
                lengths: torch.Tensor) -> torch.Tensor:
    """Row sums of ``g[starts[p] : starts[p] + lengths[p]]`` for every piece
    ``p``, each added in entry order from zero (f32, one add an entry)."""
    out = torch.zeros((starts.numel(), g.shape[1]), dtype=g.dtype,
                      device=g.device)
    for t in range(int(lengths.max()) if lengths.numel() else 0):
        live = (lengths > t).nonzero().squeeze(1)
        out[live] += g[starts[live] + t]
    return out


def segmented_segment_sum(out: torch.Tensor, vals: torch.Tensor,
                          perm: torch.Tensor, ids_sorted: torch.Tensor,
                          chunk: int = CHUNK,
                          layout: Optional[str] = None) -> None:
    """``plain_segment_sum`` with the sums taken as the kernels take them,
    bit for bit. The stream is cut into chunks of ``chunk`` entries. In
    the ``"columns"`` layout (``mf_segment_sum`` on wide rows, and
    ``mf_segment_apply`` with its own chunk) a run's piece in a chunk is
    added in entry order from zero. In the ``"entries"`` layout each chunk
    is cut further into lane slices of ``SLICE`` entries: a run's piece in
    a slice is added in entry order from zero, and the slice pieces of a
    run in one chunk are added from zero in slice order. Then the chunk
    pieces of a run are added from zero in chunk order, and the total is
    added to ``out``'s row. ``layout=None`` takes the one ``segsum_plan``
    gives ``mf_segment_sum`` for these rows. Plain PyTorch for the tests
    and the checks on the card; the entry points never call it."""
    if chunk <= 0:
        raise ValueError(f"chunk must be positive, got {chunk}")
    out2, vals2 = _as_2d(out, vals)
    n = ids_sorted.numel()
    if n == 0:
        return
    if layout is None:
        layout = segsum_plan(n, vals2.shape[1]).layout
    if layout not in LAYOUTS:
        raise ValueError(f"layout must be one of {LAYOUTS}, got {layout!r}")
    cuts = [chunk]
    if layout == "entries":
        if chunk % SLICE:
            raise ValueError(f"the entries layout cuts chunks into slices of "
                             f"{SLICE}; chunk {chunk} is not a multiple")
        cuts = [SLICE, chunk]
    ids = ids_sorted.long()
    pos = torch.arange(n, device=ids.device)
    new_run = torch.ones(n, dtype=torch.bool, device=ids.device)
    new_run[1:] = ids[1:] != ids[:-1]
    run = torch.cumsum(new_run, 0) - 1
    # level by level: the pieces of one run inside one block of `cut`
    # entries, each summed from zero in order; the last level is the run
    sums, head = vals2[perm.long()], pos
    for cut in cuts + [None]:
        r = run[head]
        first = torch.ones_like(head, dtype=torch.bool)
        first[1:] = r[1:] != r[:-1]
        if cut is not None:
            blk = head // cut
            first[1:] |= blk[1:] != blk[:-1]
        starts = first.nonzero().squeeze(1)
        lengths = torch.diff(starts, append=starts.new_tensor([head.numel()]))
        sums, head = _piece_sums(sums, starts, lengths), head[starts]
    rows = ids[head]
    out2[rows] = out2[rows] + sums


# ---------------------------------------------------------------------------
# The kernel
# ---------------------------------------------------------------------------


class SegsumPlan(NamedTuple):
    """How one ``mf_segment_sum`` call is laid out on the card."""

    layout: str  # "entries" (lanes over entries) or "columns"
    chunk: int  # entries a warp owns
    n_chunks: int  # ceil(n / chunk)
    grid: int  # blocks of WARPS warps, one warp a chunk
    finish_grid: int  # blocks of the finishing launch (0: none)
    scratch_shape: Tuple[int, int]  # f32 pieces of crossing runs


def segsum_plan(n: int, d: int,
                entries_max_d: int = ENTRIES_MAX_D) -> SegsumPlan:
    """The launch plan for ``n`` entries of ``d`` columns; needs no look
    at the data, so the wrapper allocates the scratch without waiting for
    the card. Rows of at most ``entries_max_d`` columns take the entries
    layout, wider ones the columns layout. The scratch holds two slots of
    ``d`` floats a chunk: the piece of a run that begins at the chunk's
    start and crosses a boundary, and that of another that begins later
    and crosses its end. ``entries_max_d`` other than the default is for
    a build of the source with another ``MF_ENTRIES_MAX_D``
    (``tools/probe_kernels.py``)."""
    if n <= 0 or d <= 0:
        raise ValueError(f"the segment sum needs n > 0 and d > 0, got n={n}, "
                         f"d={d}")
    n_chunks = -(-n // CHUNK)
    return SegsumPlan("entries" if d <= entries_max_d else "columns", CHUNK,
                      n_chunks, -(-n_chunks // WARPS),
                      -(-(n_chunks - 1) // WARPS), (2 * n_chunks, d))


def _check(name: str, t: torch.Tensor, device: torch.device, dtype,
           shape) -> None:
    if t.device != device:
        raise ValueError(f"{name} must be on {device}, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")


def cuda_segment_sum(out: torch.Tensor, vals: torch.Tensor,
                     perm: torch.Tensor, ids_sorted: torch.Tensor) -> None:
    """``out[ids_sorted[j]] += vals[perm[j]]`` by ``mf_segment_sum``, in
    place, on ``out``'s stream: ``out`` (rows, d) or (rows,) and ``vals``
    (n, d) or (n,) f32, ``perm`` and ``ids_sorted`` (n,) int32 with
    ``ids_sorted`` ascending. Ids are not bounds-checked (that would
    sync): they come from the vocabulary."""
    dev = out.device
    if dev.type != "cuda":
        raise ValueError(f"cuda_segment_sum takes CUDA tensors, got {dev}")
    out2, vals2 = _as_2d(out, vals)
    n, d = vals2.shape
    _check("out", out2, dev, torch.float32, (out2.shape[0], d))
    _check("vals", vals2, dev, torch.float32, (n, d))
    _check("perm", perm, dev, torch.int32, (n,))
    _check("ids_sorted", ids_sorted, dev, torch.int32, (n,))
    if n == 0:
        return
    plan = segsum_plan(n, d)
    scratch = torch.empty(plan.scratch_shape, dtype=torch.float32, device=dev)
    lib = _library()
    rc = lib.mf_segment_sum(
        out2.data_ptr(), vals2.data_ptr(), perm.data_ptr(),
        ids_sorted.data_ptr(), n, d, scratch.data_ptr(),
        LAYOUTS.index(plan.layout), plan.chunk, plan.n_chunks, plan.grid,
        plan.finish_grid,
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"segment_sum launch failed: "
                           f"{lib.mf_segment_sum_error_string(rc).decode()}")
    _count()


def segment_sum(out: torch.Tensor, vals: torch.Tensor, perm: torch.Tensor,
                ids_sorted: torch.Tensor) -> torch.Tensor:
    """``cuda_segment_sum`` for a CUDA ``out``, ``plain_segment_sum`` for
    a CPU one; any other device raises. Returns ``out``."""
    if out.device.type == "cuda":
        cuda_segment_sum(out, vals, perm, ids_sorted)
    elif out.device.type == "cpu":
        plain_segment_sum(out, vals, perm, ids_sorted)
    else:
        raise ValueError(f"no segment sum for device {out.device}")
    return out


def segment_sums(vals: torch.Tensor, order: Tuple[torch.Tensor, torch.Tensor],
                 n_rows: int) -> torch.Tensor:
    """Fresh zeros of ``n_rows`` (x d) plus ``segment_sum`` of ``vals``
    over ``order`` (``sorted_order`` of the ids): the counterpart of
    ``jax.ops.segment_sum(vals, ids, num_segments=n_rows)``."""
    out = torch.zeros((n_rows,) + tuple(vals.shape[1:]), dtype=torch.float32,
                      device=vals.device)
    return segment_sum(out, vals, *order)
