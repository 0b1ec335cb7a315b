"""The ALS normal equations on the CPU: the launch plan of
``csrc/als_normal_eq.cu`` (``ops/cuda_normal_eq.py``), a model of its
microtile order held to the source statement for statement, and a plain
twin of the kernel's sums held against the port's plain body
(``ops/ials.py::plain_normal_equations``), the JAX package's normal
equations and a float64 truth.

The twin adds each slot's products to the grams one slot after another,
in f32, over slices of ``cuda_normal_eq.SLICE`` slots, and adds the slices
in order: the kernel's blocking and order (the kernel fuses each product
and add into one FMA, so the twin is its model, not its bits). The
kernel itself is held to the plain body on the card
(``tests/test_torch_cuda.py``).

Bars: every pair within 1e-5 of the largest |entry| of the float64
truth's A (or b), a few times the f32 sums' rounding over these lists
(slots of up to 2,100 rows of N(0, 0.3^2) factors); the JAX package's
own bar between two ALS paths is 2e-4 on the tables.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from matrix_factorization_tpu.ops import ials as jials
from matrix_factorization_tpu_torch.core.config import SGDConfig
from matrix_factorization_tpu_torch.ops import _build
from matrix_factorization_tpu_torch.ops import cuda_normal_eq as cne
from matrix_factorization_tpu_torch.ops import ials
from matrix_factorization_tpu_torch.ops import segment_sgd as sgd

CU = (Path(cne.__file__).resolve().parent.parent / "csrc" / "als_normal_eq.cu").read_text()


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the twin's thousands of small products
    otherwise wait on the thread pool whenever test workers share the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_constants_are_the_kernels():
    for name, value in (("kMT", cne.TILE), ("kBand", BAND),
                        ("kStages", cne.STAGES), ("kSlice", cne.SLICE),
                        ("kMaxThreads", cne.MAX_THREADS), ("kMaxSmem", _build.SMEM_LIMIT)):
        assert re.search(rf"constexpr int {name} = {value};", CU), name
    assert "int smem_bytes(int work) { return (work + 4 * kSlice + 34) * 4; }" in CU
    assert cne._SLOT_FLOATS == 4 * cne.SLICE + 34


# (d, L, slices): short lists, both sides of the slice threshold, the
# cell's longest bucket, widths whose factors are not a multiple of 4
@pytest.mark.parametrize("d,L,slices", [
    (201, 0, 1), (201, 8, 1), (201, 256, 1), (201, 1024, 1), (201, 1025, 2),
    (201, 2048, 2), (201, 32_768, 32), (201, 131_072, 128), (9, 8, 1),
    (65, 3000, 3), (2, 1, 1), (12, 40, 1), (1001, 4096, 4), (4001, 16, 1)])
def test_plan_covers_the_call(d, L, slices):
    p = cne.normal_eq_plan(d, L)
    assert p.slices == slices
    assert (p.slices - 1) * cne.SLICE < max(L, 1) <= p.slices * cne.SLICE
    # every upper microtile of the augmented row (the factors rounded up to
    # 4, the constant, the target) has a thread
    kc = -(-(d - 1) // 4) * 4
    assert p.tiles * cne.TILE >= kc + 2 > (p.tiles - 1) * cne.TILE
    assert p.width == p.tiles * cne.TILE
    assert p.microtiles == p.tiles * (p.tiles + 1) // 2
    assert p.groups == -(-p.microtiles // p.per_group)
    assert p.per_group <= p.threads <= cne.MAX_THREADS
    assert p.threads % 32 == 0 and p.threads - p.per_group < 32
    assert 1 <= p.rows <= cne.MAX_ROWS
    # A's staged rows: odd stride, room for a pad word after every 8 columns
    assert p.stride % 2 == 1 and p.stride >= d + (d - 1) // 8
    assert 1 <= p.band <= d
    work = max(cne.STAGES * p.rows * p.width, 4 * cne.SLICE, p.band * p.stride)
    assert p.smem_bytes == (work + 4 * cne.SLICE + 34) * 4 <= _build.SMEM_LIMIT


def test_plan_at_the_cells_width():
    """MovieLens-25M at k = 200: one block of 352 threads an entity, 64
    staged rows, all of A staged for its write in one band."""
    p = cne.normal_eq_plan(201, 256)
    assert p == cne.NormalEqPlan(tiles=26, microtiles=351, groups=1,
                                 per_group=351, threads=352, rows=64, width=208,
                                 band=201, stride=227, slices=1,
                                 smem_bytes=199_028)
    assert cne.normal_eq_plan(1001, 8)[5:9] == (16, 1008, 47, 1127)
    with pytest.raises(ValueError):
        cne.normal_eq_plan(1, 8)
    with pytest.raises(ValueError):
        cne.normal_eq_plan(20_000, 8)


# The kernel's microtile order, modelled in Python: ``tile_of`` of
# ``csrc/als_normal_eq.cu``, whose statements
# ``test_tile_order_model_is_the_sources`` holds to ``TILE_OF_SOURCE``.
BAND = 4  # kBand: microtile rows a band of the order holds
TILE_OF_SOURCE = (
    "int r0 = 0; for (;;) { const int h = min(kBand, t - r0); "
    "const int cnt = h * (h + 1) / 2 + (t - r0 - h) * h; if (p < cnt) break; "
    "p -= cnt; r0 += kBand; } const int h = min(kBand, t - r0); "
    "const int head = h * (h + 1) / 2; if (p < head) { int c = 0; "
    "while ((c + 1) * (c + 2) / 2 <= p) ++c; ti = r0 + p - c * (c + 1) / 2; "
    "tj = r0 + c; } else { p -= head; tj = r0 + h + p / h; ti = r0 + p % h; }")


def _tile_of(p, t):
    """(tile row, tile column) of microtile ``p`` of a side of ``t``."""
    r0 = 0
    while True:
        h = min(BAND, t - r0)
        cnt = h * (h + 1) // 2 + (t - r0 - h) * h
        if p < cnt:
            break
        p -= cnt
        r0 += BAND
    h = min(BAND, t - r0)
    head = h * (h + 1) // 2
    if p < head:
        c = 0
        while (c + 1) * (c + 2) // 2 <= p:
            c += 1
        return r0 + p - c * (c + 1) // 2, r0 + c
    p -= head
    return r0 + p % h, r0 + h + p // h


def test_tile_order_model_is_the_sources():
    """``TILE_OF_SOURCE`` is what ``tile_of`` in ``csrc/als_normal_eq.cu``
    says, statement for statement (comments and spacing aside): a change to
    the kernel's order fails here until ``_tile_of`` follows it."""
    m = re.search(r"void tile_of\([^)]*\) \{\n(.*?)\n\}", CU, re.S)
    assert m, "no tile_of in als_normal_eq.cu"
    assert " ".join(re.sub(r"//[^\n]*", "", m.group(1)).split()) == TILE_OF_SOURCE


@pytest.mark.parametrize("t", [1, 2, 3, 4, 5, 9, 26, 65])
def test_tile_order_covers_the_upper_triangle_once(t):
    M = t * (t + 1) // 2
    tiles = [_tile_of(p, t) for p in range(M)]
    assert sorted(tiles) == [(i, j) for i in range(t) for j in range(i, t)]
    # bands of BAND tile rows, in band order
    bands = [ti // BAND for ti, _ in tiles]
    assert bands == sorted(bands)
    if t == 26:
        # a warp reads few distinct row and column offsets of a staged row
        for w in range(0, M, 32):
            rows = {ti for ti, _ in tiles[w:w + 32]}
            cols = {tj for _, tj in tiles[w:w + 32]}
            assert len(rows) <= 10 and len(cols) <= 10


def test_wrapper_takes_only_cuda_tensors():
    cfg = SGDConfig(n_factors=8)
    other = torch.zeros(5, cfg.padded_factors)
    ids = torch.zeros((2, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        cne.cuda_normal_equations(other, ids, torch.zeros(2, 8), torch.zeros(2, 8),
                                  torch.tensor(3.0), 8, 9, 8, 0.1)


# ---------------------------------------------------------------------------
# The twin of the kernel's sums
# ---------------------------------------------------------------------------


def _slots(d, side, holes, seed):
    """A table and E entities' (E, L) slots: counts from L / 2 to L filled
    from the left (one entity with none), ids of real rows, pads id 0; with
    ``holes`` every odd slot masked (the ``half`` fault's shape)."""
    rng = np.random.default_rng(seed)
    k = d - 1
    cfg = SGDConfig(n_factors=k, reg=0.1)
    o_side = "item" if side == "user" else "user"
    o_bias, o_const = sgd.bias_col(cfg, o_side), sgd.const_col(cfg, o_side)
    n_other = 300
    T = np.zeros((n_other, cfg.padded_factors), np.float32)
    T[:, :k] = rng.normal(0, 0.3, (n_other, k))
    T[:, o_bias] = rng.normal(0, 0.2, n_other)
    T[:, o_const] = 1.0
    E, L = (2, 1100) if d > 100 else (4, 2100)
    counts = rng.integers(L // 2, L + 1, E)
    counts[-1] = 0
    mask = (np.arange(L)[None] < counts[:, None]).astype(np.float32)
    if holes:
        mask[:, 1::2] = 0.0
    ids = np.where(mask > 0, rng.integers(0, n_other, (E, L)), 0).astype(np.int32)
    r = np.where(mask > 0, np.round(rng.uniform(0.5, 5, (E, L)) * 2) / 2, 0)
    return cfg, k, o_bias, o_const, T, ids, r.astype(np.float32), mask


def _twin(T, ids, r, mask, mu, k, o_bias, o_const, ridge, bf16):
    """The kernel's sums in f32: per slice of SLICE slots, one slot's
    products after another (a masked slot adds zeros, as skipping it
    does), the slices added in slice order, then the ridge."""
    rows = T[ids.long()]
    X = torch.cat([rows[..., :k], rows[..., o_const:o_const + 1]], -1) * mask[..., None]
    y = ((r - mu) - rows[..., o_bias]) * mask
    Xg = X.to(torch.bfloat16).to(torch.float32) if bf16 else X
    E, L = ids.shape
    A = b = None
    for s0 in range(0, max(L, 1), cne.SLICE):
        sA = torch.zeros(E, k + 1, k + 1)
        sb = torch.zeros(E, k + 1)
        for slot in range(s0, min(s0 + cne.SLICE, L)):
            sA += Xg[:, slot, :, None] * Xg[:, slot, None, :]
            sb += X[:, slot] * y[:, slot, None]
        A, b = (sA, sb) if A is None else (A + sA, b + sb)
    A.diagonal(dim1=-2, dim2=-1).add_(ridge)
    return A, b


def _jax(T, ids, r, mask, mu, k, o_bias, o_const, reg, reg_scale, gram):
    """The JAX package's normal equations, the steps of its bucket sweep
    (``ops/ials.py::_jit_bucket_sweep``)."""
    rows = jnp.asarray(T)[jnp.asarray(ids)]
    X = jnp.concatenate([rows[..., :k], rows[..., o_const:o_const + 1]], axis=-1)
    m = jnp.asarray(mask)
    y = (jnp.asarray(r) - mu - rows[..., o_bias]) * m
    Xm = X * m[..., None]
    A = jials._gram(Xm, gram) + jials._reg_diag(reg, m, k + 1, reg_scale)
    b = jnp.einsum("eld,el->ed", Xm, y, preferred_element_type=jnp.float32)
    return np.asarray(A), np.asarray(b)


def _f64(T, ids, r, mask, mu, k, o_bias, o_const, ridge, bf16):
    T = T.astype(np.float64)
    rows = T[ids]
    X = np.concatenate([rows[..., :k], rows[..., o_const:o_const + 1]], -1)
    X = X * mask[..., None]
    y = ((r - mu) - rows[..., o_bias]) * mask
    Xg = X
    if bf16:
        Xg = torch.from_numpy(X.astype(np.float32)).to(torch.bfloat16).double().numpy()
    A = Xg.transpose(0, 2, 1) @ Xg
    A[:, np.arange(k + 1), np.arange(k + 1)] += np.asarray(ridge, np.float64).reshape(-1, 1)
    return A, (X.transpose(0, 2, 1) @ y[..., None])[..., 0]


@pytest.mark.parametrize("holes", [False, True], ids=["prefix", "holes"])
@pytest.mark.parametrize("gram", ["f32", "bf16"])
@pytest.mark.parametrize("reg_scale", ["absolute", "per_obs"])
@pytest.mark.parametrize("side", ["user", "item"])
@pytest.mark.parametrize("d", [9, 65, 201])
def test_kernel_order_twin_matches_the_plain_body_and_jax(d, side, reg_scale, gram,
                                                          holes):
    cfg, k, o_bias, o_const, T, ids, r, mask = _slots(
        d, side, holes, seed=d + 7 * (side == "item"))
    mu = 3.4
    Tt, it, rt, mt = (torch.from_numpy(x) for x in (T, ids, r, mask))
    mu_t = torch.tensor(mu, dtype=torch.float32)
    assert ids.shape[1] > cne.SLICE  # the list takes the slices
    ridge = ials._reg_diag(cfg.reg, mt, reg_scale)
    twin = _twin(Tt, it, rt, mt, mu_t, k, o_bias, o_const, ridge, gram == "bf16")
    body = ials.normal_equations(Tt, it, rt, mt, mu_t, cfg, side, gram, reg_scale)
    jx = _jax(T, ids, r, mask, mu, k, o_bias, o_const, cfg.reg, reg_scale, gram)
    truth = _f64(T, ids, r, mask, np.float32(mu), k, o_bias, o_const,
                 ridge.numpy() if isinstance(ridge, torch.Tensor) else ridge,
                 gram == "bf16")
    for i, name in enumerate("Ab"):
        bar = 1e-5 * np.abs(truth[i]).max()
        got = {"twin": twin[i].numpy(), "body": body[i].numpy(), "jax": jx[i]}
        for key, val in got.items():
            assert np.abs(val - truth[i]).max() <= bar, (name, key)
        assert np.abs(got["twin"] - got["body"]).max() <= bar, name
        assert np.abs(got["twin"] - got["jax"]).max() <= bar, name
    # the entity without a rating: the ridge alone, no right-hand side
    want = ridge[-1].item() if isinstance(ridge, torch.Tensor) else ridge
    torch.testing.assert_close(twin[0][-1], want * torch.eye(d), rtol=0, atol=0)
    assert not twin[1][-1].any()


def test_normal_equations_off_cuda_are_the_plain_body(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("the kernel was called for a CPU table")

    monkeypatch.setattr(cne, "cuda_normal_equations", refuse)
    cfg, k, o_bias, o_const, T, ids, r, mask = _slots(9, "item", False, 3)
    args = [torch.from_numpy(x) for x in (T, ids, r, mask)]
    mu = torch.tensor(3.0)
    A, b = ials.normal_equations(*args, mu, cfg, "item", "f32", "per_obs")
    A2, b2 = ials.plain_normal_equations(*args, mu, k, o_bias, o_const, cfg.reg,
                                         "f32", "per_obs")
    assert torch.equal(A, A2) and torch.equal(b, b2)
