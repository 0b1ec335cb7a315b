"""Batched SPD inverses and solves for the ALS normal equations (PyTorch
port).

Counterpart of ``matrix_factorization_tpu/ops/spd.py``. ``spd_inverse`` is
the recursive Schur-complement block inverse: for SPD
``A = [[A11, A12], [A12^T, A22]]``, split at a multiple of 8,

    S       = A22 - A12^T A11^{-1} A12          (SPD Schur complement)
    A^{-1}  = [[inv11 + W S^{-1} W^T,  -W S^{-1}],
               [ -S^{-1} W^T,           S^{-1} ]],   W = A11^{-1} A12

so every level is a few batched products, down to leaves of d <= 128,
which the Gauss-Jordan leaf inverts: the hand-written kernel of
``ops/cuda_spd.py`` on a CUDA tensor, its plain version on the CPU.
``spd_solve`` Jacobi-scales to a unit diagonal, solves the scaled system
and refines once: for 128 < d <= 232 by one Schur block elimination that
never forms the inverse (``ops/cuda_spd_solve.py``), otherwise by applying
the inverse; ``spd_inverse_scaled`` scales and refines an explicit inverse
(Newton-Schulz steps). ``spd_inverse_ns`` inverts one
SPD matrix by the Newton-Schulz iteration alone, and
``spd_inverse_ns_sharded`` does so with the rows split over the ranks of a
mesh's first axis (EASE past 16,384 items).

``leaf``: ``'auto'`` and ``'gj'`` mean the Gauss-Jordan leaf on every
device; ``'cholesky'`` (the JAX package's ``'xla'``) inverts leaves of
d <= ``base`` by ``torch.linalg.cholesky`` and a triangular solve, a cross-
check that nothing on the main path uses. The JAX package's mesh pins
(``spec``, ``spec_min``) have no counterpart (under SPMD a rank holds its
shard as a plain tensor).

Every product here is exact f32: TF32 stays off (a Schur complement of an
ill-conditioned gram taken at lower precision can come out indefinite).
"""

from __future__ import annotations

import contextlib
import math
from typing import NamedTuple

import torch

from matrix_factorization_tpu_torch.ops import cuda_spd, cuda_spd_solve
from matrix_factorization_tpu_torch.ops.segment_sgd import round_up
from matrix_factorization_tpu_torch.utils.profiling import span

LEAVES = ("auto", "gj", "cholesky")


@contextlib.contextmanager
def exact_f32():
    """TF32 off for the CUDA products inside, restored after."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    with exact_f32():
        return torch.matmul(a, b)


def _t(a: torch.Tensor) -> torch.Tensor:
    return a.transpose(-1, -2)


def _base_inverse(A: torch.Tensor) -> torch.Tensor:
    """Small-block SPD inverse: Cholesky, ``L^{-1}`` by one triangular
    solve against I, then ``A^{-1} = L^{-T} L^{-1}``."""
    chol = torch.linalg.cholesky(A)
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device).expand(A.shape)
    inv_l = torch.linalg.solve_triangular(chol, eye, upper=False)
    return _mm(_t(inv_l), inv_l)


def spd_inverse(A: torch.Tensor, base: int = 32,
                leaf: str = "auto") -> torch.Tensor:
    """Batched inverse of SPD matrices ``A`` (..., d, d) by recursive Schur
    complements, split at multiples of 8 down to the leaf (see the module
    docstring for ``leaf``), into a new tensor; ``A`` is not changed."""
    return _inverse(A, base, leaf, inplace=False)


def _inverse(A: torch.Tensor, base: int, leaf: str, inplace: bool) -> torch.Tensor:
    """:func:`spd_inverse`, its blocks written into a new tensor, or with
    ``inplace`` over ``A``, which the caller gives up (each block of ``A``
    is read before the result is written over it). A level's complement
    ``S`` is its own, so its inverse is written over it. Every product sees
    the same operands, strides included, either way, so the result's bits
    do not depend on ``inplace``."""
    if leaf not in LEAVES:
        raise ValueError(f"leaf must be one of {LEAVES}, got {leaf!r}")
    d = A.shape[-1]
    if leaf != "cholesky" and d <= cuda_spd.MAX_D:
        flat = A.reshape((-1,) + tuple(A.shape[-2:])).contiguous()
        with span("spd.leaf"):
            inv = cuda_spd.gj_inverse(flat)
        return inv.reshape(A.shape)
    if d <= base:
        with span("spd.leaf"):
            return _base_inverse(A)
    with span("spd.schur"):
        m = ((d // 2 + 7) // 8) * 8  # split point, multiple of 8
        A11 = A[..., :m, :m]
        A12 = A[..., :m, m:]
        A22 = A[..., m:, m:]
        inv11 = _inverse(A11, base, leaf, inplace=False)
        W = _mm(inv11, A12)                      # (..., m, d-m)
        S = A22 - _mm(_t(A12), W)                # Schur complement, SPD
        invS = _inverse(S, base, leaf, inplace=True)
        del S
        B12 = _mm(W, invS).neg_()                # (..., m, d-m)
        B11 = inv11.sub_(_mm(B12, _t(W)))
        del inv11, W
        out = A if inplace else A.new_empty(A.shape)
        out[..., :m, :m] = B11
        out[..., :m, m:] = B12
        out[..., m:, :m] = _t(B12)
        out[..., m:, m:] = invS
        return out


def _jacobi(A: torch.Tensor) -> torch.Tensor:
    """``1/sqrt(diag(A))``, the diagonal clamped to the smallest normal."""
    diag = torch.diagonal(A, dim1=-2, dim2=-1)
    return torch.rsqrt(diag.clamp_min(torch.finfo(A.dtype).tiny))


def spd_inverse_scaled(A: torch.Tensor, base: int = 32, refine: int = 1,
                       leaf: str = "auto") -> torch.Tensor:
    """Explicit SPD inverse with :func:`spd_solve`'s conditioning
    insurance: Jacobi scaling to a unit diagonal before the Schur
    recursion, then ``refine`` Newton-Schulz steps
    (``P <- 2P - P A P``) in exact f32. The scaled system becomes ``P``
    in place; passed as a temporary (the caller keeping no reference),
    ``A`` is let go after the last refinement's first product, so that
    three (..., d, d) matrices are live at its second."""
    dscale = _jacobi(A)
    As = A * dscale[..., :, None]
    As.mul_(dscale[..., None, :])
    P = _inverse(As, base, leaf, inplace=True)
    del As
    P.mul_(dscale[..., :, None]).mul_(dscale[..., None, :])
    for r in range(refine):
        AP = _mm(A, P)
        if r == refine - 1:
            del A
        PAP = _mm(P, AP)
        del AP
        P.mul_(2.0).sub_(PAP)
        del PAP
    return P


def _matvec(A: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return _mm(A, x[..., None])[..., 0]


def spd_solve(A: torch.Tensor, b: torch.Tensor, base: int = 32,
              refine: int = 1, leaf: str = "auto") -> torch.Tensor:
    """Batched solve of SPD systems ``A x = b``, one right-hand side each:
    ``A`` (..., d, d), ``b`` (..., d).

    Jacobi-scales to a unit diagonal (the ALS grams' diagonals span the
    entities' rating counts), solves the scaled system, then runs
    ``refine`` steps of iterative refinement (``x += A^-1 (b - A x)``). For
    ``cuda_spd.MAX_D < d <= cuda_spd_solve.MAX_D`` with the Gauss-Jordan
    leaf that is :func:`_block_solve`; otherwise the Schur-recursion
    inverse of the scaled system is formed and applied, against an
    exact-f32 residual."""
    with span("spd.solve"):
        d = A.shape[-1]
        if leaf in ("auto", "gj") and cuda_spd.MAX_D < d <= cuda_spd_solve.MAX_D:
            return _block_solve(A, b, refine)
        return _inverse_solve(A, b, base, refine, leaf)


def _inverse_solve(A: torch.Tensor, b: torch.Tensor, base: int, refine: int,
                   leaf: str) -> torch.Tensor:
    """:func:`spd_solve` by the Schur-recursion inverse of the scaled
    system, applied by batched matrix-vector products, the residual in
    exact f32 (every d; the solve of d <= 128 and d > 232)."""
    dscale = _jacobi(A)
    As = A * dscale[..., :, None] * dscale[..., None, :]
    inv = _inverse(As, base, leaf, inplace=True)

    def apply_inv(r):
        return dscale * _matvec(inv, dscale * r)

    x = apply_inv(b)
    for _ in range(refine):
        x = x + apply_inv(b - _matvec(A, x))
    return x


def _schur_blocks(A: torch.Tensor):
    """The back-solve's inputs of the (E, d, d) systems ``A``, contiguous,
    split at ``m = cuda_spd_solve.split_point(d)``: the split and scaling
    (span ``spd.split``), the Gauss-Jordan leaf of ``As11`` and of the
    complement ``S = As22 - As12^T W``, ``W = inv11 As12``, formed in
    ``As22``'s place (``spd.leaf``, ``spd.schur``). Returns (inv11, As12,
    invS, W, ds)."""
    with span("spd.split"):
        A11, A12, S, ds = cuda_spd_solve.spd_split(A)
    with span("spd.leaf"):
        inv11 = cuda_spd.gj_inverse(A11)
    del A11
    with span("spd.schur"):
        W = _mm(inv11, A12)
        with exact_f32():
            S.baddbmm_(_t(A12), W, alpha=-1.0)
    with span("spd.leaf"):
        invS = cuda_spd.gj_inverse(S)
    return inv11, A12, invS, W, ds


def _block_solve(A: torch.Tensor, b: torch.Tensor, refine: int) -> torch.Tensor:
    """:func:`spd_solve` by one Schur block elimination of the scaled
    system: :func:`_schur_blocks`, then the back-solve and its refinement
    (span ``spd.backsolve``). No inverse of the whole system is formed,
    stored or read."""
    d = A.shape[-1]
    A = A.reshape(-1, d, d).contiguous()
    blocks = _schur_blocks(A)
    with span("spd.backsolve"):
        x = cuda_spd_solve.block_solve(*blocks, A, b.reshape(-1, d).contiguous(),
                                       refine)
    return x.reshape(b.shape)


def solve_spd(A: torch.Tensor, b: torch.Tensor, base: int = 32,
              refine: int = 1, leaf: str = "auto") -> torch.Tensor:
    """The SPD solve of the ALS normal equations: every d goes through
    :func:`spd_solve` with the Gauss-Jordan leaf, as the JAX package does on
    the TPU (``ops/spd.py:385-389``). The JAX package's CPU shortcut (a
    direct Cholesky solve for d <= 64) is not taken, so the CPU runs the
    leaf the GPU runs."""
    return spd_solve(A, b, base=base, refine=refine, leaf=leaf)


def spd_inverse_ns(A: torch.Tensor, max_iters: int = 100,
                   tol: float = 1e-5) -> torch.Tensor:
    """Inverse of one SPD matrix ``A`` (d, d) by the Newton-Schulz
    iteration ``P <- P (2I - As P)`` on the Jacobi-scaled system ``As``,
    from ``P0 = I / ||As||_F`` (the eigenvalues of ``I - c As`` lie in
    (0, 1) for SPD ``As``), in exact f32. A step first measures the
    residual ``||As P - I||_F / sqrt(d)`` of the P it starts from, then
    updates; the loop ends after the step whose residual is at most
    ``tol``, or after ``max_iters`` steps, as the JAX package's
    ``while_loop`` does. Each step's stop test reads the residual on the
    host (a sync on the card), as the JAX package's sharded form does."""
    if A.dim() != 2 or A.shape[0] != A.shape[1]:
        raise ValueError(f"A must be one (d, d) matrix, got {tuple(A.shape)}")
    d = A.shape[-1]
    ds = _jacobi(A)
    As = A * ds[:, None] * ds[None, :]
    eye = torch.eye(d, dtype=A.dtype, device=A.device)
    P = eye / torch.sqrt(torch.sum(As * As))
    root_d = torch.sqrt(torch.tensor(float(d), dtype=A.dtype))
    for _ in range(max_iters):
        AP = _mm(As, P)
        res = float(torch.sqrt(torch.sum((AP - eye) ** 2)).cpu() / root_d)
        P = 2.0 * P - _mm(P, AP)
        if not res > tol:
            break
    return P * ds[:, None] * ds[None, :]


class NSLayout(NamedTuple):
    """The row-sharded Newton-Schulz layout of a (d, d) system on this
    rank: ``n`` ranks on the first axis (``group``), this one ``r``; the
    system padded to ``dp``, ``dl`` rows a rank from ``row0 = r dl``, the
    real ones ``[lo, hi)`` (the padding cut off, so the last ranks may
    hold fewer rows, or none); column slabs ``blk`` wide."""

    group: object
    n: int
    r: int
    d: int
    dp: int
    dl: int
    blk: int
    lo: int
    hi: int

    @property
    def row0(self) -> int:
        return self.r * self.dl


def ns_layout(d: int, mesh, col_block: int = 1024) -> NSLayout:
    """The layout of a (d, d) system on this rank of ``mesh``'s first axis:
    ``dp = round_up(d, 8 N)``, ``blk = min(col_block, dp)`` stepped down by
    8 until it divides ``dp`` (JAX ``spd_inverse_ns_sharded``)."""
    from matrix_factorization_tpu_torch.parallel.mesh import first_axis

    group, n, r = first_axis(mesh)
    dp = round_up(d, 8 * n)
    blk = min(col_block, dp)
    while dp % blk:
        blk -= 8
    dl = dp // n
    return NSLayout(group, n, r, d, dp, dl, blk, min(r * dl, d),
                    min((r + 1) * dl, d))


def padded_rows(A_rows: torch.Tensor, lay: NSLayout) -> torch.Tensor:
    """This rank's ``dl`` rows of ``blockdiag(A, I)`` (dl, dp) from its real
    rows ``A_rows`` (hi - lo, d): the identity block pads the system to
    ``dp`` exactly (the inverse of ``blockdiag(A, I)`` is
    ``blockdiag(inv(A), I)``)."""
    Ap = torch.zeros((lay.dl, lay.dp), dtype=torch.float32, device=A_rows.device)
    Ap[:lay.hi - lay.lo, :lay.d] = A_rows
    pad = torch.arange(lay.hi - lay.lo, lay.dl, device=A_rows.device)
    Ap[pad, lay.row0 + pad] = 1.0
    return Ap


def _slab_mm(X_l: torch.Tensor, Y_l: torch.Tensor, lay: NSLayout,
             out: torch.Tensor) -> torch.Tensor:
    """This rank's rows of ``X @ Y`` for row-sharded ``X`` and ``Y``, into
    ``out`` (which may be ``Y_l`` itself: a slab is gathered before its
    columns are written). For each ``blk``-wide column slab of ``Y`` the
    ranks' rows of it are all-gathered into a (dp, blk) slab (a
    contiguous copy first: collectives refuse strided views) and the local
    rows multiply it in exact f32. A rank's memory beyond its three row
    shards is one slab."""
    from matrix_factorization_tpu_torch.parallel.distributed import all_gather_rows

    with exact_f32():
        for c in range(0, lay.dp, lay.blk):
            slab = all_gather_rows(Y_l[:, c:c + lay.blk].contiguous(), lay.group)
            out[:, c:c + lay.blk] = X_l @ slab
            del slab
    return out


def ns_sharded_steps(Ap: torch.Tensor, lay: NSLayout, max_iters: int = 100,
                     tol: float = 1e-5, info: dict = None) -> torch.Tensor:
    """The row-sharded Newton-Schulz iteration on this rank's padded rows
    ``Ap`` (dl, dp) of an SPD system, which it overwrites with the
    Jacobi-scaled system ``As``: ``P <- P (2I - As P)`` from
    ``P0 = I / ||As||_F``, each product by :func:`_slab_mm`. A step
    measures ``||As P - I||_F / sqrt(dp)`` of the P it starts from (a
    local sum of squares, one ``all_reduce``), then updates; the group's
    first rank decides whether the residual is below ``tol`` and
    broadcasts it, so that every rank stops at the same step (a rank
    that compared its own float could leave the others waiting in the
    next collective). Returns this rank's rows of the inverse of the
    unscaled system, (dl, dp); ``info`` (a dict) gets ``steps`` and the
    last ``residual``."""
    import torch.distributed as dist

    from matrix_factorization_tpu_torch.parallel.distributed import all_gather_rows

    dev = Ap.device
    diag = all_gather_rows(Ap.diagonal(offset=lay.row0).contiguous(), lay.group)
    ds = torch.rsqrt(diag.clamp_min(torch.finfo(torch.float32).tiny))
    As = Ap.mul_(ds[lay.row0:lay.row0 + lay.dl, None]).mul_(ds[None, :])
    flat = As.view(-1)
    sq = torch.dot(flat, flat).reshape(1)
    dist.all_reduce(sq, group=lay.group)
    P = torch.zeros_like(As)
    P.diagonal(offset=lay.row0).copy_(torch.rsqrt(sq).expand(lay.dl))
    AP = torch.empty_like(As)
    decide = torch.zeros(1, dtype=torch.int32, device=dev)
    src = dist.get_global_rank(lay.group, 0)
    steps, res = 0, None
    for _ in range(max_iters):
        _slab_mm(As, P, lay, AP)
        # ||As P - I||^2 with the diagonal's 1 taken off and put back bit
        # for bit (a subtraction and an addition would not restore it)
        dg = AP.diagonal(offset=lay.row0)
        keep = dg.clone()
        dg.sub_(1.0)
        flat = AP.view(-1)
        res_sq = torch.dot(flat, flat).reshape(1)
        dg.copy_(keep)
        dist.all_reduce(res_sq, group=lay.group)
        _slab_mm(P, AP, lay, AP)          # AP <- P (As P), in place
        P.mul_(2.0).sub_(AP)             # P <- 2P - P As P
        steps += 1
        if lay.r == 0:
            res = math.sqrt(float(res_sq.cpu())) / math.sqrt(lay.dp)
            decide.fill_(int(res < tol))
        dist.broadcast(decide, src=src, group=lay.group)
        if int(decide.cpu()):
            break
    del AP, As
    if info is not None:
        info.update(steps=steps, residual=res)
    return P.mul_(ds[lay.row0:lay.row0 + lay.dl, None]).mul_(ds[None, :])


def spd_inverse_ns_sharded(A: torch.Tensor, mesh, max_iters: int = 100,
                           tol: float = 1e-5, col_block: int = 1024,
                           info: dict = None) -> torch.Tensor:
    """Row-sharded Newton-Schulz inverse of an SPD (d, d) system over the
    ranks of ``mesh``'s first axis (N ranks; ranks on its other axes
    compute the same rows): the system padded with an identity block to
    ``dp = round_up(d, 8 N)``, rank r holding rows ``[r dp / N, (r + 1) dp
    / N)`` of ``As``, ``P`` and ``As P``, every product a loop over column
    slabs of at most ``col_block`` (JAX ``ops/spd.py:238-286``). A rank's
    memory during the steps is three row shards and one slab. ``A`` (the
    whole matrix) is not modified. Returns this rank's real rows
    ``[lo, hi)`` (:func:`ns_layout`) of the inverse, (hi - lo, d).
    ``info`` as in :func:`ns_sharded_steps`."""
    d = A.shape[-1]
    lay = ns_layout(d, mesh, col_block)
    P = ns_sharded_steps(padded_rows(A[lay.lo:lay.hi], lay), lay, max_iters,
                         tol, info)
    return P[:lay.hi - lay.lo, :d].clone()
