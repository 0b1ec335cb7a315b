"""Hand-written CUDA mini-batch SGD step and deterministic secondary apply.

Counterpart of ``matrix_factorization_tpu/ops/pallas_sgd.py``. Two
kernels:

* ``mf_sgd_step`` (``csrc/sgd_step.cu``) replaces the Pallas
  ``_step_kernel``: for one batch sorted by the primary side's id it
  updates the primary table in place (every row from the pre-step
  tables, deltas of one row summed) and writes the per-entry secondary
  deltas ``dq`` (bs, Kp). A warp owns a
  fixed segment of ``SEG_LEN`` consecutive entries; a run of equal ids
  that crosses a segment boundary is summed in pieces, which a second
  small launch of the same call adds in segment order (``step_plan``
  lays the call out, ``segmented_sgd_step`` is that summation in plain
  PyTorch);
* ``mf_segment_apply`` (``csrc/segment_sum.cu``, beside the segment sum
  whose scheme it shares) adds ``dq`` to the secondary table over the
  pack's stable secondary argsort (``sec_perm``, ``sec_ids_sorted``), one
  writer per row and a fixed summation order, where XLA's scatter did it
  on the TPU. A float-atomic ``index_add_`` would break same-seed, same-
  bits determinism. A warp owns a fixed chunk of ``APPLY_CHUNK``
  entries; a run that crosses a chunk boundary is summed in pieces that a
  second launch adds in chunk order (``apply_plan`` lays the call out,
  ``segment_sum.segmented_segment_sum`` is that summation in plain
  PyTorch).

The sources say what bounds them and how they are laid out.

``cuda_sgd_step`` and ``cuda_segment_apply`` launch the kernels and take
only CUDA tensors. ``plain_sgd_step`` and ``plain_segment_apply`` are the
same functions in plain PyTorch (a gather, ``ext_forward_and_rowgrads``
and ``index_add_``); the CPU path and the comparisons use them. Only
tests call ``segmented_sgd_step``.
``sgd_step`` and ``segment_apply`` pick between the two by the tensors'
device: a CUDA tensor always launches the kernel.
"""

from __future__ import annotations

import ctypes
import threading
from typing import NamedTuple, Optional, Tuple

import torch

from matrix_factorization_tpu_torch.core.config import LANE, SGDConfig
from matrix_factorization_tpu_torch.ops import segment_sum
from matrix_factorization_tpu_torch.ops.segment_sum import _piece_sums

_KERNEL_CODES = {"linear": 0, "sigmoid": 1, "rbf": 2}
MAX_WIDTH = 8 * LANE  # the kernels hold a row in registers, Kp <= 1024

# The step's launch geometry; csrc/sgd_step.cu is compiled for the same
# values (kSegLen, kStages, kWarps, kMaxSmem) and refuses any other.
SEG_LEN = 64  # consecutive entries one warp owns
STEP_STAGES = 6  # secondary rows a warp keeps in flight (its cp.async ring)
STEP_WARPS = 8  # warps a block
STEP_MAX_BLOCKS_PER_SM = 4
SMEM_LIMIT = 232_448  # dynamic shared memory a block may take on sm_90
SMEM_PER_SM = 233_472  # of which a resident block reserves 1 KB
# The apply's chunk; csrc/segment_sum.cu is compiled for the same value
# (MF_APPLY_CHUNK, with the segment sum's kWarps) and refuses any other.
APPLY_CHUNK = 32  # consecutive entries one warp owns

_count_lock = threading.Lock()
step_launches = 0  # mf_sgd_step launches since import or reset_launches()
apply_launches = 0  # mf_segment_apply launches, likewise


def reset_launches() -> None:
    global step_launches, apply_launches
    with _count_lock:
        step_launches = apply_launches = 0


def _count_step() -> None:
    global step_launches
    with _count_lock:
        step_launches += 1


def _count_apply() -> None:
    global apply_launches
    with _count_lock:
        apply_launches += 1


_lib = None


def _library():
    global _lib
    if _lib is None:
        from matrix_factorization_tpu_torch.ops import _build

        lib = _build.load("sgd_step")
        vp, ci, cf, cll = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                           ctypes.c_longlong)
        lib.mf_sgd_step.argtypes = [vp, vp, vp, vp, vp, vp, vp, vp, vp, vp,
                                    cll, ci, ci, cf, cf, cf, cf, cf, ci,
                                    vp, ci, cll, ci, ci, ci, vp]
        lib.mf_sgd_step.restype = ci
        lib.mf_sgd_error_string.argtypes = [ci]
        lib.mf_sgd_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check(name: str, t: torch.Tensor, device: torch.device, dtype,
           shape=None) -> None:
    if t.device != device:
        raise ValueError(f"{name} must be on {device}, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")


def _check_width(kp: int) -> None:
    if kp % LANE or not 0 < kp <= MAX_WIDTH:
        raise ValueError(f"row width {kp} is not a multiple of {LANE} "
                         f"in (0, {MAX_WIDTH}]")


# ---------------------------------------------------------------------------
# Plain PyTorch versions (CPU tensors, and the comparisons on the card)
# ---------------------------------------------------------------------------


def plain_sgd_step(cfg: SGDConfig, mu: torch.Tensor, prim_tbl: torch.Tensor,
                   sec_tbl: torch.Tensor, prim_ids: torch.Tensor,
                   sec_ids: torch.Tensor, r: torch.Tensor, w: torch.Tensor,
                   pmask: torch.Tensor, smask: torch.Tensor, lr: float,
                   reg: float, update_prim: bool = True,
                   write_dq: bool = True) -> Optional[torch.Tensor]:
    """The step of ``cuda_sgd_step`` as gather + row math + ``index_add_``
    (``segment_sgd._minibatch_update``'s per-side deltas). The forward and
    gradients are symmetric in the two sides, so the primary rows go in as
    ``pu`` whichever side they are."""
    from matrix_factorization_tpu_torch.ops.segment_sgd import (
        ext_forward_and_rowgrads)

    x = prim_tbl[prim_ids.long()]
    y = sec_tbl[sec_ids.long()]
    pred, dx, dy = ext_forward_and_rowgrads(cfg, mu, x, y)
    err = (pred - r) * w
    rw = reg * w
    if update_prim:
        g = (err[:, None] * dx + rw[:, None] * x) * pmask[None, :]
        prim_tbl.index_add_(0, prim_ids.long(), -lr * g)
    if not write_dq:
        return None
    return -lr * ((err[:, None] * dy + rw[:, None] * y) * smask[None, :])


def plain_segment_apply(table: torch.Tensor, rows: torch.Tensor,
                        perm: torch.Tensor, ids_sorted: torch.Tensor) -> None:
    """``table[ids_sorted[j]] += rows[perm[j]]`` by ``index_add_``."""
    table.index_add_(0, ids_sorted.long(), rows[perm.long()])


def segmented_sgd_step(cfg: SGDConfig, mu: torch.Tensor,
                       prim_tbl: torch.Tensor, sec_tbl: torch.Tensor,
                       prim_ids: torch.Tensor, sec_ids: torch.Tensor,
                       r: torch.Tensor, w: torch.Tensor, pmask: torch.Tensor,
                       smask: torch.Tensor, lr: float, reg: float,
                       update_prim: bool = True, write_dq: bool = True,
                       seg_len: int = SEG_LEN) -> Optional[torch.Tensor]:
    """``plain_sgd_step`` with the primary deltas summed as ``mf_sgd_step``
    sums them: the batch is cut into segments of ``seg_len`` entries, the
    deltas of a run of equal primary ids are added in entry order inside
    each segment, and the pieces of a run that crosses segment boundaries
    are then added in segment order before the pre-step row. Plain
    PyTorch for the tests of the boundary logic; the entry points never
    call it."""
    from matrix_factorization_tpu_torch.ops.segment_sgd import (
        ext_forward_and_rowgrads)

    if seg_len <= 0:
        raise ValueError(f"seg_len must be positive, got {seg_len}")
    n = prim_ids.numel()
    ids = prim_ids.long()
    x = prim_tbl[ids]
    y = sec_tbl[sec_ids.long()]
    pred, dx, dy = ext_forward_and_rowgrads(cfg, mu, x, y)
    err = (pred - r) * w
    rw = reg * w
    if update_prim and n:
        g = -lr * ((err[:, None] * dx + rw[:, None] * x) * pmask[None, :])
        pos = torch.arange(n, device=ids.device)
        new_run = torch.ones(n, dtype=torch.bool, device=ids.device)
        new_run[1:] = ids[1:] != ids[:-1]
        starts = (new_run | (pos % seg_len == 0)).nonzero().squeeze(1)
        lengths = torch.diff(starts, append=pos.new_tensor([n]))
        pieces = _piece_sums(g, starts, lengths)
        # the pieces of one run, in segment order: piece sums of piece sums
        run_of_piece = torch.cumsum(new_run, 0)[starts] - 1
        first = torch.ones_like(starts, dtype=torch.bool)
        first[1:] = run_of_piece[1:] != run_of_piece[:-1]
        run_starts = first.nonzero().squeeze(1)
        run_lengths = torch.diff(run_starts,
                                 append=pos.new_tensor([starts.numel()]))
        total = _piece_sums(pieces, run_starts, run_lengths)
        rows = ids[starts[run_starts]]
        prim_tbl[rows] = prim_tbl[rows] + total
    if not write_dq:
        return None
    return -lr * ((err[:, None] * dy + rw[:, None] * y) * smask[None, :])


# ---------------------------------------------------------------------------
# The kernels
# ---------------------------------------------------------------------------


class StepPlan(NamedTuple):
    """How one ``mf_sgd_step`` call is laid out on the card."""

    seg_len: int  # entries a warp owns at a time
    n_segments: int  # ceil(n / seg_len)
    grid: int  # blocks of STEP_WARPS warps, persistent over the segments
    smem_bytes: int  # dynamic shared memory a block
    stages: int  # secondary rows in flight a warp
    scratch_shape: Tuple[int, int]  # f32 partial sums of crossing runs


def step_smem(kp: int, stages: int = STEP_STAGES,
              seg_len: int = SEG_LEN) -> int:
    """Shared bytes of a step block: the two masks, each warp's ring of
    ``stages`` rows, and each warp's segment metadata (16 + 4 bytes an
    entry)."""
    return 4 * kp * (2 + STEP_WARPS * stages) + 20 * seg_len * STEP_WARPS


def step_plan(n: int, kp: int, n_sms: int = 132, seg_len: int = SEG_LEN,
              stages: int = STEP_STAGES) -> StepPlan:
    """The launch plan of the step for ``n`` entries of width ``kp`` on a
    card with ``n_sms`` SMs; needs no look at the data, so the wrapper
    allocates the scratch without waiting for the card. The scratch
    holds a head and a tail slot of ``kp`` floats for every segment: the
    partial sum of a run that reaches over the segment's start (or fills
    it), and of another that reaches over its end. ``seg_len`` and
    ``stages`` other than the defaults are for a build of the source
    with other constants (``tools/probe_kernels.py``)."""
    if n <= 0:
        raise ValueError(f"the step needs n > 0, got {n}")
    _check_width(kp)
    n_segments = -(-n // seg_len)
    smem = step_smem(kp, stages, seg_len)
    if smem > SMEM_LIMIT:
        raise ValueError(f"{stages} stages of width {kp} need {smem} bytes "
                         f"of shared memory, over {SMEM_LIMIT}")
    per_sm = max(1, min(STEP_MAX_BLOCKS_PER_SM, SMEM_PER_SM // (smem + 1024)))
    grid = min(-(-n_segments // STEP_WARPS), n_sms * per_sm)
    return StepPlan(seg_len, n_segments, grid, smem, stages,
                    (2 * n_segments, kp))


class ApplyPlan(NamedTuple):
    """How one ``mf_segment_apply`` call is laid out on the card."""

    chunk: int  # entries a warp owns
    n_chunks: int  # ceil(n / chunk)
    grid: int  # blocks of segment_sum.WARPS warps, one warp a chunk
    finish_grid: int  # blocks of the finishing launch (0: none)
    scratch_shape: Tuple[int, int]  # f32 pieces of crossing runs


def apply_plan(n: int, kp: int, chunk: int = APPLY_CHUNK) -> ApplyPlan:
    """The launch plan of the apply for ``n`` entries of width ``kp``;
    needs no look at the data. The scratch holds two slots of ``kp``
    floats a chunk, as the segment sum's does. ``chunk`` other than the
    default is for a build of the source with another ``MF_APPLY_CHUNK``
    (``tools/probe_kernels.py``)."""
    if n <= 0:
        raise ValueError(f"the apply needs n > 0, got {n}")
    _check_width(kp)
    n_chunks = -(-n // chunk)
    warps = segment_sum.WARPS
    return ApplyPlan(chunk, n_chunks, -(-n_chunks // warps),
                     -(-(n_chunks - 1) // warps), (2 * n_chunks, kp))


_sm_counts: dict = {}


def _n_sms(dev: torch.device) -> int:
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    if idx not in _sm_counts:
        _sm_counts[idx] = torch.cuda.get_device_properties(
            idx).multi_processor_count
    return _sm_counts[idx]


def cuda_sgd_step(cfg: SGDConfig, mu: torch.Tensor, prim_tbl: torch.Tensor,
                  sec_tbl: torch.Tensor, prim_ids: torch.Tensor,
                  sec_ids: torch.Tensor, r: torch.Tensor, w: torch.Tensor,
                  pmask: torch.Tensor, smask: torch.Tensor, lr: float,
                  reg: float, update_prim: bool = True,
                  write_dq: bool = True) -> Optional[torch.Tensor]:
    """One step of ``mf_sgd_step`` on ``prim_tbl``'s stream: the segment
    launch and, when the primary side is updated, the launch that
    finishes the runs crossing a segment boundary.

    ``prim_ids`` and ``sec_ids`` (n,) int32 sorted by ``prim_ids``; ``r``
    and ``w`` (n,) f32; tables (rows, Kp) and masks (Kp,) f32; ``mu`` one
    f32 on the card (read by the kernel, so the call never syncs). Ids are
    not bounds-checked (that would sync): they come from the vocabulary.
    Updates ``prim_tbl`` in place unless ``update_prim`` is false; returns
    the secondary deltas (n, Kp), or None when ``write_dq`` is false."""
    if cfg.kernel not in _KERNEL_CODES:
        raise ValueError(f"unknown kernel {cfg.kernel!r}")
    dev = prim_tbl.device
    if dev.type != "cuda":
        raise ValueError(f"cuda_sgd_step takes CUDA tensors, got {dev}")
    if prim_tbl.dim() != 2 or sec_tbl.dim() != 2:
        raise ValueError("tables must be 2-D")
    kp = prim_tbl.shape[1]
    _check_width(kp)
    n = prim_ids.numel()
    f32, i32 = torch.float32, torch.int32
    _check("mu", mu, dev, f32, ())
    _check("prim_tbl", prim_tbl, dev, f32)
    _check("sec_tbl", sec_tbl, dev, f32, (sec_tbl.shape[0], kp))
    for name, t, dt in (("prim_ids", prim_ids, i32), ("sec_ids", sec_ids, i32),
                        ("r", r, f32), ("w", w, f32)):
        _check(name, t, dev, dt, (n,))
    _check("pmask", pmask, dev, f32, (kp,))
    _check("smask", smask, dev, f32, (kp,))
    dq = torch.empty((n, kp), dtype=f32, device=dev) if write_dq else None
    if n == 0:
        return dq
    plan = step_plan(n, kp, _n_sms(dev))
    scratch = (torch.empty(plan.scratch_shape, dtype=f32, device=dev)
               if update_prim else None)
    lib = _library()
    rc = lib.mf_sgd_step(
        mu.data_ptr(), prim_tbl.data_ptr(), sec_tbl.data_ptr(),
        prim_ids.data_ptr(), sec_ids.data_ptr(), r.data_ptr(), w.data_ptr(),
        pmask.data_ptr(), smask.data_ptr(),
        dq.data_ptr() if dq is not None else None, n, kp,
        _KERNEL_CODES[cfg.kernel], float(cfg.gamma), float(cfg.a),
        float(cfg.c), float(lr), float(reg), int(bool(update_prim)),
        scratch.data_ptr() if scratch is not None else None, plan.seg_len,
        plan.n_segments, plan.grid, plan.smem_bytes, plan.stages,
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(
            f"sgd_step launch failed: {lib.mf_sgd_error_string(rc).decode()}")
    _count_step()
    return dq


def cuda_segment_apply(table: torch.Tensor, rows: torch.Tensor,
                       perm: torch.Tensor, ids_sorted: torch.Tensor) -> None:
    """``table[ids_sorted[j]] += rows[perm[j]]`` by ``mf_segment_apply``,
    in place, on ``table``'s stream (the chunk launch and, when a chunk
    follows the first, the finishing launch): ``table`` (rows, Kp) and
    ``rows`` (n, Kp) f32, ``perm`` and ``ids_sorted`` (n,) int32 with
    ``ids_sorted`` ascending."""
    dev = table.device
    if dev.type != "cuda":
        raise ValueError(f"cuda_segment_apply takes CUDA tensors, got {dev}")
    if table.dim() != 2:
        raise ValueError("table must be 2-D")
    kp = table.shape[1]
    _check_width(kp)
    n = perm.numel()
    _check("table", table, dev, torch.float32)
    _check("rows", rows, dev, torch.float32, (n, kp))
    _check("perm", perm, dev, torch.int32, (n,))
    _check("ids_sorted", ids_sorted, dev, torch.int32, (n,))
    if n == 0:
        return
    plan = apply_plan(n, kp)
    scratch = torch.empty(plan.scratch_shape, dtype=torch.float32, device=dev)
    lib = segment_sum._library()
    rc = lib.mf_segment_apply(
        table.data_ptr(), rows.data_ptr(), perm.data_ptr(),
        ids_sorted.data_ptr(), n, kp, scratch.data_ptr(), plan.chunk,
        plan.n_chunks, plan.grid, plan.finish_grid,
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(
            f"segment_apply launch failed: "
            f"{lib.mf_segment_sum_error_string(rc).decode()}")
    _count_apply()


# ---------------------------------------------------------------------------
# Routing by device
# ---------------------------------------------------------------------------


def sgd_step(cfg: SGDConfig, mu, prim_tbl, sec_tbl, prim_ids, sec_ids, r, w,
             pmask, smask, lr, reg, update_prim=True, write_dq=True):
    """``cuda_sgd_step`` for CUDA tables, ``plain_sgd_step`` for CPU
    tables; any other device raises."""
    if prim_tbl.device.type == "cuda":
        fn = cuda_sgd_step
    elif prim_tbl.device.type == "cpu":
        fn = plain_sgd_step
    else:
        raise ValueError(f"no SGD step for device {prim_tbl.device}")
    return fn(cfg, mu, prim_tbl, sec_tbl, prim_ids, sec_ids, r, w, pmask,
              smask, lr, reg, update_prim, write_dq)


def segment_apply(table, rows, perm, ids_sorted) -> None:
    """``cuda_segment_apply`` for a CUDA table, ``plain_segment_apply``
    for a CPU table; any other device raises."""
    if table.device.type == "cuda":
        cuda_segment_apply(table, rows, perm, ids_sorted)
    elif table.device.type == "cpu":
        plain_segment_apply(table, rows, perm, ids_sorted)
    else:
        raise ValueError(f"no segment apply for device {table.device}")
