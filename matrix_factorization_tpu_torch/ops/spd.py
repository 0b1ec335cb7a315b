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
``spd_solve`` Jacobi-scales to a unit diagonal, applies the inverse of the
scaled system and refines once; ``spd_inverse_scaled`` does the same for
an explicit inverse (Newton-Schulz steps). ``spd_inverse_ns`` inverts one
SPD matrix by the Newton-Schulz iteration alone.

``leaf``: ``'auto'`` and ``'gj'`` mean the Gauss-Jordan leaf on every
device; ``'cholesky'`` (the JAX package's ``'xla'``) inverts leaves of
d <= ``base`` by ``torch.linalg.cholesky`` and a triangular solve, a cross-
check that nothing on the main path uses. The JAX package's mesh pins
(``spec``, ``spec_min``) have no counterpart (under SPMD a rank holds its
shard as a plain tensor); its column-sharded Newton-Schulz inverse
(``spd_inverse_ns_sharded``) comes with EASE on a mesh (slice 6d).

Every product here is exact f32: TF32 stays off (a Schur complement of an
ill-conditioned gram taken at lower precision can come out indefinite).
"""

from __future__ import annotations

import contextlib

import torch

from matrix_factorization_tpu_torch.ops import cuda_spd

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
    docstring for ``leaf``)."""
    if leaf not in LEAVES:
        raise ValueError(f"leaf must be one of {LEAVES}, got {leaf!r}")
    d = A.shape[-1]
    if leaf != "cholesky" and d <= cuda_spd.MAX_D:
        flat = A.reshape((-1,) + tuple(A.shape[-2:])).contiguous()
        return cuda_spd.gj_inverse(flat).reshape(A.shape)
    if d <= base:
        return _base_inverse(A)
    m = ((d // 2 + 7) // 8) * 8  # split point, multiple of 8
    A11 = A[..., :m, :m]
    A12 = A[..., :m, m:]
    A22 = A[..., m:, m:]
    inv11 = spd_inverse(A11, base, leaf)
    W = _mm(inv11, A12)                      # (..., m, d-m)
    S = A22 - _mm(_t(A12), W)                # Schur complement, SPD
    invS = spd_inverse(S, base, leaf)
    B12 = -_mm(W, invS)                      # (..., m, d-m)
    B11 = inv11 - _mm(B12, _t(W))
    top = torch.cat([B11, B12], dim=-1)
    bot = torch.cat([_t(B12), invS], dim=-1)
    return torch.cat([top, bot], dim=-2)


def _jacobi(A: torch.Tensor) -> torch.Tensor:
    """``1/sqrt(diag(A))``, the diagonal clamped to the smallest normal."""
    diag = torch.diagonal(A, dim1=-2, dim2=-1)
    return torch.rsqrt(diag.clamp_min(torch.finfo(A.dtype).tiny))


def spd_inverse_scaled(A: torch.Tensor, base: int = 32, refine: int = 1,
                       leaf: str = "auto") -> torch.Tensor:
    """Explicit SPD inverse with :func:`spd_solve`'s conditioning
    insurance: Jacobi scaling to a unit diagonal before the Schur
    recursion, then ``refine`` Newton-Schulz steps
    (``P <- 2P - P A P``) in exact f32."""
    dscale = _jacobi(A)
    As = A * dscale[..., :, None] * dscale[..., None, :]
    inv = spd_inverse(As, base, leaf)
    P = inv * dscale[..., :, None] * dscale[..., None, :]
    for _ in range(refine):
        AP = _mm(A, P)
        P = 2.0 * P - _mm(P, AP)
    return P


def _matvec(A: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return _mm(A, x[..., None])[..., 0]


def spd_solve(A: torch.Tensor, b: torch.Tensor, base: int = 32,
              refine: int = 1, leaf: str = "auto") -> torch.Tensor:
    """Batched solve of SPD systems ``A x = b``, one right-hand side each:
    ``A`` (..., d, d), ``b`` (..., d).

    Jacobi-scales to a unit diagonal (the ALS grams' diagonals span the
    entities' rating counts), forms the Schur-recursion inverse of the
    scaled system, applies it, then runs ``refine`` steps of iterative
    refinement (``x += A^-1 (b - A x)``, exact-f32 residual) against the
    same inverse."""
    dscale = _jacobi(A)
    As = A * dscale[..., :, None] * dscale[..., None, :]
    inv = spd_inverse(As, base, leaf)

    def apply_inv(r):
        return dscale * _matvec(inv, dscale * r)

    x = apply_inv(b)
    for _ in range(refine):
        x = x + apply_inv(b - _matvec(A, x))
    return x


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
