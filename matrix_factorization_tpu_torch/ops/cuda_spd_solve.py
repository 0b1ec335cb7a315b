"""The Schur block solve of batched SPD systems on Hopper: the hand-written
kernels of ``csrc/spd_block_solve.cu``, their plain versions and their
wrappers.

For systems ``A x = b`` of ``cuda_spd.MAX_D < d <= MAX_D`` (ALS at
k = 200: d = 201), ``ops/spd.py::spd_solve`` eliminates one Schur block of
the Jacobi-scaled system ``As = D A D``, ``D = diag(ds)``, instead of
forming its inverse. With the split ``m = split_point(d)``, ``n = d - m``:

* ``spd_split`` gives ``ds = 1 / sqrt(max(diag A, tiny))`` and the scaled
  blocks ``As11`` (E, m, m), ``As12`` (E, m, n) and ``As22`` (E, n, n),
  each contiguous; ``As21 = As12^T`` is not formed;
* the caller inverts ``As11`` and ``S = As22 - As12^T W``, ``W = inv11
  As12``, by the Gauss-Jordan leaf;
* ``block_solve`` solves the scaled system from ``inv11``, ``As12``,
  ``invS`` and ``W``: ``y1 = inv11 rs1``, ``x2 = invS (rs2 - As12^T y1)``,
  ``x1 = y1 - W x2`` with ``rs = ds b`` and ``x = ds [x1; x2]``, then runs
  ``refine`` steps of iterative refinement, ``x += ds elim(ds (b - A x))``,
  the residual summed in float64 against the unscaled ``A``.

The kernels (``mf_spd_split``, ``mf_spd_block_solve``) replace no TPU
kernel; their source says why they were added, what bounds them and how
they are laid out. ``plain_spd_split`` and ``plain_block_solve`` are the
same steps in plain PyTorch: the CPU runs them, and the comparisons on the
card use them. ``spd_split`` and ``block_solve`` pick between the two by
the tensors' device: a CUDA tensor always launches the kernel.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from matrix_factorization_tpu_torch.ops import _build, cuda_spd

MAX_D = 232  # kMaxD: the staged blocks of a larger d outgrow shared memory
SOLVE_THREADS = 512  # kSolveThreads
COL_TILE = 128  # kColTile: columns of the column product a pass
_GROUPS = SOLVE_THREADS // COL_TILE  # its partial sums a column

_vp, _ci, _cll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
LIB = _build.Library("spd_block_solve", {
    "mf_spd_split": ([_vp, _cll, _ci, _vp, _vp, _vp, _vp, _vp], _ci),
    "mf_spd_block_solve": ([_vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp, _cll, _ci, _ci,
                            _ci, _ci, _vp], _ci),
}, error="mf_spd_block_error_string")


def split_point(d: int) -> int:
    """The Schur split of a (d, d) system: ``d / 2`` rounded up to a
    multiple of 8, as ``ops/spd.py::_inverse`` splits."""
    return ((d // 2 + 7) // 8) * 8


def _region(n: int) -> int:
    return -(-n // 4) * 4 + 4


def solve_smem(d: int) -> int:
    """Dynamic shared bytes of the back-solve at d (``solve_smem`` in the
    source): the four staged blocks, each region rounded up to 16 bytes
    with 4 floats for a source off a 16-byte boundary (an entity's invS
    starts n^2 floats past the last one's: off a boundary at odd n), six
    vectors of d and the column product's partial sums."""
    if not cuda_spd.MAX_D < d <= MAX_D:
        raise ValueError(f"the block solve takes {cuda_spd.MAX_D} < d <= {MAX_D}, got {d}")
    m = split_point(d)
    n = d - m
    return 4 * (_region(m * m) + 2 * _region(m * n) + _region(n * n) + 6 * d
                + _GROUPS * COL_TILE)


def solve_grid(E: int, sms: int) -> int:
    """Persistent blocks of the back-solve for E >= 1 systems on a card of
    ``sms`` SMs: one an SM (its shared memory holds one), at most E."""
    return min(E, sms)


def _check_systems(A: torch.Tensor) -> int:
    if A.dim() != 3 or A.shape[1] != A.shape[2]:
        raise ValueError(f"the block solve takes (E, d, d) systems, got {tuple(A.shape)}")
    d = A.shape[-1]
    if not cuda_spd.MAX_D < d <= MAX_D:
        raise ValueError(f"the block solve takes {cuda_spd.MAX_D} < d <= {MAX_D}, got {d}")
    return d


def plain_spd_split(A: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """(As11, As12, As22, ds) of the (E, d, d) systems ``A``, new contiguous
    tensors: ``ds = 1 / sqrt(max(diag A, tiny))``, each correctly rounded,
    and ``(A_ij ds_i) ds_j``."""
    d = _check_systems(A)
    m = split_point(d)
    diag = torch.diagonal(A, dim1=-2, dim2=-1)
    ds = torch.reciprocal(torch.sqrt(diag.clamp_min(torch.finfo(A.dtype).tiny)))
    As = A * ds[:, :, None] * ds[:, None, :]
    return (As[:, :m, :m].contiguous(), As[:, :m, m:].contiguous(),
            As[:, m:, m:].contiguous(), ds)


def cuda_spd_split(A: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """:func:`plain_spd_split` by ``mf_spd_split`` on ``A``'s stream, into
    new tensors, the same bits. ``A`` must be a contiguous CUDA f32 tensor;
    E may be 0 (nothing is launched)."""
    d = _check_systems(A)
    if A.device.type != "cuda":
        raise ValueError(f"cuda_spd_split takes CUDA tensors, got {A.device}")
    _build.check("A", A, A.device, torch.float32)
    E, m = A.shape[0], split_point(d)
    if E >= 2**31:
        raise ValueError(f"the block solve launches at most 2^31 - 1 systems, got {E}")
    n = d - m
    A11, A12, A22 = (A.new_empty((E, r, c)) for r, c in ((m, m), (m, n), (n, n)))
    ds = A.new_empty((E, d))
    if E:
        LIB("mf_spd_split", A.data_ptr(), E, d, A11.data_ptr(), A12.data_ptr(),
            A22.data_ptr(), ds.data_ptr(), torch.cuda.current_stream(A.device).cuda_stream)
    return A11, A12, A22, ds


def spd_split(A: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """``cuda_spd_split`` for a CUDA tensor, ``plain_spd_split`` for a CPU
    tensor; any other device raises."""
    if A.device.type == "cuda":
        return cuda_spd_split(A)
    if A.device.type == "cpu":
        return plain_spd_split(A)
    raise ValueError(f"no spd_split for device {A.device}")


def _products(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``M v`` of each system, as exact f32 products summed along the rows
    (no TF32 on any device)."""
    return (M * v[:, None, :]).sum(-1)


def plain_block_solve(inv11: torch.Tensor, A12: torch.Tensor, invS: torch.Tensor,
                      W: torch.Tensor, ds: torch.Tensor, A: torch.Tensor,
                      b: torch.Tensor, refine: int = 1) -> torch.Tensor:
    """x (E, d) of ``A x = b`` by the kernel's steps (module docstring):
    the elimination from the scaled system's blocks, then ``refine``
    refinement steps with the residual ``b - A x`` in float64, rounded to
    f32."""
    m = inv11.shape[-1]

    def eliminate(rs):
        y1 = _products(inv11, rs[:, :m])
        x2 = _products(invS, rs[:, m:] - _products(A12.transpose(1, 2), y1))
        return torch.cat([y1 - _products(W, x2), x2], dim=1)

    x = ds * eliminate(ds * b)
    for _ in range(refine):
        r = b.double() - (A.double() @ x.double()[:, :, None])[:, :, 0]
        x = x + ds * eliminate(ds * r.to(b.dtype))
    return x


def cuda_block_solve(inv11: torch.Tensor, A12: torch.Tensor, invS: torch.Tensor,
                     W: torch.Tensor, ds: torch.Tensor, A: torch.Tensor,
                     b: torch.Tensor, refine: int = 1) -> torch.Tensor:
    """:func:`plain_block_solve` by ``mf_spd_block_solve`` on ``A``'s
    stream, into a new (E, d) tensor: the same steps, the sums in the
    kernel's order. Every tensor must be a contiguous CUDA f32 tensor of
    the shapes the split gives; E may be 0 (nothing is launched). A
    ``refine`` below 0 refines none, as ``range(refine)`` does in the plain
    version."""
    d = _check_systems(A)
    dev = A.device
    if dev.type != "cuda":
        raise ValueError(f"cuda_block_solve takes CUDA tensors, got {dev}")
    E, m = A.shape[0], split_point(d)
    n = d - m
    for name, t, shape in (("inv11", inv11, (E, m, m)), ("A12", A12, (E, m, n)),
                           ("invS", invS, (E, n, n)), ("W", W, (E, m, n)),
                           ("ds", ds, (E, d)), ("A", A, (E, d, d)), ("b", b, (E, d))):
        _build.check(name, t, dev, torch.float32, shape)
    if E >= 2**31:
        raise ValueError(f"the block solve launches at most 2^31 - 1 systems, got {E}")
    x = b.new_empty((E, d))
    if E:
        LIB("mf_spd_block_solve", inv11.data_ptr(), A12.data_ptr(), invS.data_ptr(),
            W.data_ptr(), ds.data_ptr(), A.data_ptr(), b.data_ptr(), x.data_ptr(), E,
            d, max(refine, 0), solve_grid(E, _build.sm_count(dev)), solve_smem(d),
            torch.cuda.current_stream(dev).cuda_stream)
    return x


def block_solve(inv11: torch.Tensor, A12: torch.Tensor, invS: torch.Tensor,
                W: torch.Tensor, ds: torch.Tensor, A: torch.Tensor, b: torch.Tensor,
                refine: int = 1) -> torch.Tensor:
    """``cuda_block_solve`` for CUDA tensors, ``plain_block_solve`` for CPU
    tensors; any other device raises."""
    if A.device.type == "cuda":
        return cuda_block_solve(inv11, A12, invS, W, ds, A, b, refine)
    if A.device.type == "cpu":
        return plain_block_solve(inv11, A12, invS, W, ds, A, b, refine)
    raise ValueError(f"no block_solve for device {A.device}")
