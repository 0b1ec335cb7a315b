"""The port's SPD solves (``ops/spd.py``) and Gauss-Jordan leaf
(``ops/cuda_spd.py``) against the JAX package on the CPU.

The same seeded ridged grams (``X^T X + ridge I``, the class of matrix the
ALS normal equations produce, as ``tests/test_spd.py::_ridged_gram`` makes
them) go through both packages:

* the plain leaf against the JAX leaf run by the Pallas interpreter
  (``gj_inverse(interpret=True)``) at atol 1e-4, for E not a multiple of
  128 (the TPU kernel's lane batch);
* the Schur recursion (d > 128, so several leaves) against the JAX
  ``spd_inverse(leaf='xla')`` and float64 numpy;
* ``spd_solve``, ``solve_spd`` and ``spd_inverse_scaled`` against their
  JAX counterparts, with the JAX tests' own bars against float64
  (``|A A^-1 - I| < 5e-3``, solves within 1e-3 relative); for
  128 < d <= 232 the solve is the Schur block elimination of
  ``ops/cuda_spd_solve.py`` (its plain versions here), which forms no
  inverse of the whole system;
* ``spd_inverse`` and ``spd_inverse_scaled`` (EASE's path) bit for bit
  against a frozen copy of their steps.

The JAX package's CPU path takes a Cholesky leaf (and a direct Cholesky
solve for d <= 64) where the port always takes the Gauss-Jordan leaf, so
the two agree to rounding, not bitwise.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from matrix_factorization_tpu.ops import spd as jspd
from matrix_factorization_tpu.ops.pallas_spd import gj_inverse as jax_gj_inverse
from matrix_factorization_tpu_torch.ops import _build, cuda_spd, cuda_spd_solve, spd


def _ridged_gram(rng, E, d, L=64, ridge=0.1):
    X = rng.standard_normal((E, L, d)).astype(np.float32) * 0.3
    A = np.einsum("eld,elf->edf", X, X) + ridge * np.eye(d, dtype=np.float32)
    return A.astype(np.float32)


def _eye_err(A, inv):
    d = A.shape[-1]
    return np.abs(np.einsum("eij,ejk->eik", A.astype(np.float64),
                            np.asarray(inv, np.float64)) - np.eye(d)).max()


@pytest.mark.parametrize("d", [1, 8, 33, 64, 101, 128])
def test_plain_leaf_matches_jax_leaf(d):
    A = _ridged_gram(np.random.default_rng(d), 130, d, ridge=0.5)
    got = cuda_spd.gj_inverse(torch.from_numpy(A))
    want = np.asarray(jax_gj_inverse(jnp.asarray(A), interpret=True))
    assert got.dtype == torch.float32 and got.shape == (130, d, d)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)
    assert _eye_err(A, got.numpy()) < 5e-3


def test_leaf_takes_what_the_kernel_takes():
    with pytest.raises(ValueError, match="d <= 128"):
        cuda_spd.gj_inverse(torch.eye(129)[None])
    with pytest.raises(ValueError, match="d <= 128"):
        cuda_spd.plain_gj_inverse(torch.eye(129)[None])
    for bad in (torch.eye(4), torch.zeros(2, 3, 4)):
        with pytest.raises(ValueError, match="E, d, d"):
            cuda_spd.gj_inverse(bad)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_spd.cuda_gj_inverse(torch.eye(4)[None])
    # the CPU path is the plain version and launches nothing
    before = _build.launches("mf_gj_inverse")
    out = cuda_spd.gj_inverse(torch.eye(3)[None] * 4.0)
    assert _build.launches("mf_gj_inverse") == before
    torch.testing.assert_close(out, torch.eye(3)[None] / 4.0)
    assert cuda_spd.gj_inverse(torch.zeros(0, 5, 5)).shape == (0, 5, 5)


@pytest.mark.parametrize("d,leaves", [(201, [104, 97]),
                                      (300, [80, 72, 80, 68])])
def test_schur_recursion_matches_jax_and_float64(d, leaves, monkeypatch):
    """d = 201 splits once (104 + 97, the config-3 leaves at k = 200);
    d = 300 twice on each side."""
    A = _ridged_gram(np.random.default_rng(d), 5, d, L=2 * d, ridge=0.5)
    seen = []
    plain = cuda_spd.plain_gj_inverse

    def counted(M):
        seen.append(M.shape[-1])
        return plain(M)

    monkeypatch.setattr(cuda_spd, "plain_gj_inverse", counted)
    got = spd.spd_inverse(torch.from_numpy(A)).numpy()
    assert seen == leaves
    want = np.asarray(jspd.spd_inverse(jnp.asarray(A), leaf="xla"))
    exact = np.linalg.inv(A.astype(np.float64))
    np.testing.assert_allclose(got, want, atol=1e-4)
    np.testing.assert_allclose(got, exact, atol=1e-4)
    assert _eye_err(A, got) < 5e-3


def test_cholesky_leaf_agrees_with_gj_leaf():
    A = torch.from_numpy(_ridged_gram(np.random.default_rng(1), 6, 201,
                                      L=256, ridge=0.5))
    gj = spd.spd_inverse(A, leaf="gj")
    torch.testing.assert_close(spd.spd_inverse(A), gj, atol=0, rtol=0)
    torch.testing.assert_close(spd.spd_inverse(A, leaf="cholesky"), gj,
                               atol=1e-4, rtol=1e-4)
    with pytest.raises(ValueError, match="leaf"):
        spd.spd_inverse(A, leaf="xla")


@pytest.mark.parametrize("d", [8, 64, 65, 201, 136, 232])
def test_solves_match_jax(d):
    rng = np.random.default_rng(100 + d)
    A = _ridged_gram(rng, 6, d, ridge=0.5)
    b = rng.standard_normal((6, d)).astype(np.float32)
    exact = np.linalg.solve(A.astype(np.float64), b.astype(np.float64)[..., None])[..., 0]
    scale = max(np.abs(exact).max(), 1.0)
    At, bt = torch.from_numpy(A), torch.from_numpy(b)
    for fn, jfn in ((spd.solve_spd, jspd.solve_spd),
                    (spd.spd_solve, jspd.spd_solve)):
        got = fn(At, bt).numpy()
        want = np.asarray(jfn(jnp.asarray(A), jnp.asarray(b)))
        np.testing.assert_allclose(got, want, atol=1e-4 * scale)
        assert np.abs(got - exact).max() < 1e-3 * scale


@pytest.mark.parametrize("d", [201, 136, 232])
def test_refinement_tightens_residual(d):
    rng = np.random.default_rng(7)
    A = torch.from_numpy(_ridged_gram(rng, 8, d, L=256, ridge=0.1))
    b = torch.from_numpy(rng.standard_normal((8, d)).astype(np.float32))

    def rel_res(x):
        r = torch.linalg.norm((A @ x[..., None])[..., 0] - b, dim=-1)
        return float((r / torch.linalg.norm(b, dim=-1)).max())

    raw = rel_res(spd.spd_solve(A, b, refine=0))
    ref = rel_res(spd.spd_solve(A, b, refine=1))
    assert ref < raw and ref < 5e-3


@pytest.mark.parametrize("d", [96, 136, 201, 232])
def test_jacobi_scaling_survives_wild_diagonals(d):
    """ALS grams' diagonals span the entities' rating counts: two
    entities scaled apart by 1e6 keep the same relative accuracy, and the
    port agrees with the JAX solve."""
    rng = np.random.default_rng(11)
    A = _ridged_gram(rng, 4, d, ridge=0.5)
    scale = np.array([1.0, 1e3, 1e-3, 1.0], np.float32)[:, None]
    A = (A * scale[..., None] * scale[:, None, :]).astype(np.float32)
    b = rng.standard_normal((4, d)).astype(np.float32)
    got = spd.solve_spd(torch.from_numpy(A), torch.from_numpy(b)).numpy()
    exact = np.linalg.solve(A.astype(np.float64), b.astype(np.float64)[..., None])[..., 0]
    rel = np.abs(got - exact).max() / max(np.abs(exact).max(), 1.0)
    assert rel < 1e-3
    want = np.asarray(jspd.solve_spd(jnp.asarray(A), jnp.asarray(b)))
    assert np.abs(got - want).max() / max(np.abs(exact).max(), 1.0) < 1e-3


@pytest.mark.parametrize("d", [128, 129, 201, 232, 233])
def test_block_solve_takes_128_lt_d_le_232(d, monkeypatch):
    """``spd_solve`` takes the Schur block elimination exactly for
    128 < d <= 232 with the Gauss-Jordan leaf (one split, two leaves, one
    back-solve; the CPU runs the plain versions and launches nothing), the
    inverse elsewhere and with ``leaf='cholesky'``; within 1e-3 relative
    of float64 either way (the JAX bar), for E not a multiple of 4 and
    leading batch dimensions kept."""
    rng = np.random.default_rng(d)
    A = _ridged_gram(rng, 6, d, L=256, ridge=0.1)
    b = rng.standard_normal((6, d)).astype(np.float32)
    exact = np.linalg.solve(A.astype(np.float64), b.astype(np.float64)[..., None])[..., 0]
    seen, leaves = [], []

    def counted(module, name, log, entry):
        fn = getattr(module, name)

        def run(*args, **kwargs):
            log.append(entry(args))
            return fn(*args, **kwargs)

        monkeypatch.setattr(module, name, run)

    counted(cuda_spd_solve, "plain_spd_split", seen, lambda a: "split")
    counted(cuda_spd_solve, "plain_block_solve", seen, lambda a: "backsolve")
    counted(cuda_spd, "plain_gj_inverse", leaves, lambda a: a[0].shape[-1])
    before = _build.launches("mf_spd_split", "mf_spd_block_solve", "mf_gj_inverse")
    At, bt = torch.from_numpy(A).reshape(2, 3, d, d), torch.from_numpy(b).reshape(2, 3, d)
    got = spd.spd_solve(At, bt)
    assert got.shape == (2, 3, d)
    block = 128 < d <= 232
    m = cuda_spd_solve.split_point(d)
    assert seen == (["split", "backsolve"] if block else [])
    if block:
        assert leaves == [m, d - m]
    assert _build.launches("mf_spd_split", "mf_spd_block_solve", "mf_gj_inverse") == before
    scale = max(np.abs(exact).max(), 1.0)
    assert np.abs(got.reshape(6, d).numpy() - exact).max() < 1e-3 * scale
    seen.clear()
    chol = spd.spd_solve(At, bt, leaf="cholesky")
    assert seen == [] and np.abs(chol.reshape(6, d).numpy() - exact).max() < 1e-3 * scale


def test_plain_split_is_the_scaled_blocks():
    """``plain_spd_split``: ds the correctly rounded ``1 / sqrt`` of the
    clamped diagonal, each block ``(A_ij ds_i) ds_j`` of the split at
    ``split_point``, contiguous; the shapes the kernel does not take
    raise."""
    A = torch.from_numpy(_ridged_gram(np.random.default_rng(3), 5, 201, ridge=0.5))
    A[2, 7, 7] = 0.0  # clamped to the smallest normal
    A11, A12, A22, ds = cuda_spd_solve.plain_spd_split(A)
    m = cuda_spd_solve.split_point(201)
    assert m == 104 and (A11.shape, A12.shape, A22.shape) == ((5, 104, 104),
                                                            (5, 104, 97), (5, 97, 97))
    tiny = torch.finfo(torch.float32).tiny
    want_ds = 1.0 / torch.sqrt(torch.diagonal(A, dim1=1, dim2=2).clamp_min(tiny))
    assert torch.equal(ds, want_ds) and float(ds[2, 7]) == 1.0 / np.sqrt(np.float32(tiny))
    As = A * ds[:, :, None] * ds[:, None, :]
    for got, want in ((A11, As[:, :m, :m]), (A12, As[:, :m, m:]), (A22, As[:, m:, m:])):
        assert got.is_contiguous() and torch.equal(got, want)
    for bad in (torch.eye(128)[None], torch.eye(233)[None], torch.zeros(2, 201, 200),
                torch.eye(201)):
        with pytest.raises(ValueError):
            cuda_spd_solve.spd_split(bad)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_spd_solve.cuda_spd_split(A)


def _frozen_inverse(A, base=32):
    """``spd._inverse`` with the Gauss-Jordan leaf, frozen as EASE's path
    runs it, written out: the blocks of every level in place."""
    d = A.shape[-1]
    if d <= cuda_spd.MAX_D:
        flat = A.reshape((-1,) + tuple(A.shape[-2:])).contiguous()
        return cuda_spd.gj_inverse(flat).reshape(A.shape)
    m = ((d // 2 + 7) // 8) * 8
    A11, A12, A22 = A[..., :m, :m], A[..., :m, m:], A[..., m:, m:]
    inv11 = _frozen_inverse(A11, base)
    W = torch.matmul(inv11, A12)
    invS = _frozen_inverse(A22 - torch.matmul(A12.transpose(-1, -2), W), base)
    B12 = torch.matmul(W, invS).neg_()
    B11 = inv11.sub_(torch.matmul(B12, W.transpose(-1, -2)))
    out = A.new_empty(A.shape)
    out[..., :m, :m] = B11
    out[..., :m, m:] = B12
    out[..., m:, :m] = B12.transpose(-1, -2)
    out[..., m:, m:] = invS
    return out


def test_ease_inverses_keep_their_bits():
    """EASE's path does not take the block solve: ``spd_inverse`` and
    ``spd_inverse_scaled`` give the bits of a frozen copy of their steps
    (Jacobi scaling by ``rsqrt``, the Schur recursion, one Newton-Schulz
    step) on seeded matrices of one and two recursion levels."""
    for E, d in ((3, 201), (1, 300)):
        A = torch.from_numpy(_ridged_gram(np.random.default_rng(d), E, d, L=2 * d,
                                          ridge=0.5))
        assert torch.equal(spd.spd_inverse(A), _frozen_inverse(A))
        ds = torch.rsqrt(torch.diagonal(A, dim1=-2, dim2=-1).clamp_min(
            torch.finfo(torch.float32).tiny))
        As = A * ds[..., :, None]
        As.mul_(ds[..., None, :])
        P = _frozen_inverse(As)
        P.mul_(ds[..., :, None]).mul_(ds[..., None, :])
        P = P.mul(2.0).sub_(torch.matmul(P, torch.matmul(A, P)))
        assert torch.equal(spd.spd_inverse_scaled(A.clone()), P)


def test_spd_inverse_scaled_skewed_diagonal():
    """The EASE failure mode of ``tests/test_spd.py:123``: gram diagonals
    spanning popularity counts 5..800; the scaled and refined inverse
    stays finite and accurate, and matches the JAX one."""
    rng = np.random.default_rng(7)
    A = _ridged_gram(rng, 1, 96, L=48, ridge=5.0)
    scale = np.sqrt(rng.uniform(5.0, 800.0, (1, 96))).astype(np.float32)
    A = (A * scale[..., None] * scale[:, None, :]).astype(np.float32)
    P = spd.spd_inverse_scaled(torch.from_numpy(A), refine=1).numpy()
    assert np.isfinite(P).all()
    R = np.einsum("eij,ejk->eik", A.astype(np.float64), P.astype(np.float64))
    assert np.abs(R - np.eye(96)).max() < 1e-3
    want = np.asarray(jspd.spd_inverse_scaled(jnp.asarray(A), refine=1))
    np.testing.assert_allclose(P, want, atol=1e-5, rtol=1e-3)


@pytest.mark.parametrize("d,ridge,tol", [(48, 1.0, 1e-5), (96, 5.0, 1e-4)])
def test_newton_schulz_inverse_matches_jax(d, ridge, tol):
    """``spd_inverse_ns`` against the JAX package's on one Jacobi-skewed
    ridged gram: the same steps (the residual test on the P a step starts
    from), within 1e-5 of JAX's inverse relative to its largest entry, and
    an inverse (``|A P - I|`` < 1e-3)."""
    rng = np.random.default_rng(d)
    A = _ridged_gram(rng, 1, d, L=2 * d, ridge=ridge)[0]
    scale = np.sqrt(rng.uniform(1.0, 50.0, d)).astype(np.float32)
    A = (A * scale[:, None] * scale[None, :]).astype(np.float32)
    got = spd.spd_inverse_ns(torch.from_numpy(A), tol=tol).numpy()
    want = np.asarray(jspd.spd_inverse_ns(jnp.asarray(A), tol=tol))
    assert got.shape == (d, d) and np.isfinite(got).all()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    R = A.astype(np.float64) @ got.astype(np.float64)
    assert np.abs(R - np.eye(d)).max() < 1e-3
    with pytest.raises(ValueError, match="one"):
        spd.spd_inverse_ns(torch.from_numpy(A)[None])
