"""The port's CUDA kernels on the card, against their plain versions: the
catalog scorer, the SGD step, the secondary-side apply, the Gauss-Jordan
SPD leaf and the segment sum; the models that the segment sum carries
(bias, neighbourhood and content models, the sweep) on the card against
the CPU; and an epoch of BPR, SVD++ and NMF through the apply and the
segment sum against their plain versions, and those models' lifecycles.

Marked ``cuda``: each test skips without a CUDA GPU (the kernel has no
CPU mode; the CPU tests hold the plain version against the JAX package).
Run on a machine with a GPU and ``nvcc``:

    python -m pytest -m cuda tests/test_torch_cuda.py -q
"""

import numpy as np
import pandas as pd
import pytest
import torch

from chip_smoke import run_cli
from matrix_factorization_tpu_torch import ImplicitALS, KernelMF, params_from_numpy
from matrix_factorization_tpu_torch.core.config import SGDConfig
from matrix_factorization_tpu_torch.core.ids import IdVocab
from matrix_factorization_tpu_torch.ops import cuda_scores, cuda_sgd, cuda_spd, ials, spd
from matrix_factorization_tpu_torch.ops import segment_sum as ss
from matrix_factorization_tpu_torch.ops import segment_sgd as sgd

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rows(cfg, n, rng, side):
    m = np.zeros((n, cfg.padded_factors), np.float32)
    m[:, : cfg.n_factors] = rng.normal(0, 0.3, (n, cfg.n_factors))
    if cfg.kernel != "rbf":
        m[:, sgd.bias_col(cfg, side)] = rng.normal(0, 0.2, n)
        m[:, sgd.const_col(cfg, side)] = 1.0
    return m


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kernel", ["linear", "sigmoid", "rbf"])
@pytest.mark.parametrize("shape", [(1, 300, 100), (5, 1000, 100),
                                   (17, 2000, 200), (40, 257, 12)])
def test_kernel_matches_plain(cuda, shape, kernel, dtype):
    """Both tile shapes (B <= 16 and larger), ragged B and I; atol = rtol
    = 1e-4 (both sum in f32, in different orders)."""
    B, I, n_factors = shape
    cfg = SGDConfig(kernel=kernel, n_factors=n_factors, gamma=1 / n_factors,
                    min_rating=0.5, max_rating=5.0)
    rng = np.random.default_rng(B)
    pu = torch.from_numpy(_rows(cfg, B, rng, "user")).to(cuda, dtype)
    Q = torch.from_numpy(_rows(cfg, I, rng, "item")).to(cuda, dtype)
    mu = torch.tensor(3.5, device=cuda)
    before = cuda_scores.launches
    got = cuda_scores.cuda_score_catalog(cfg, mu, pu, Q)
    assert cuda_scores.launches == before + 1
    want = cuda_scores.plain_score_catalog(cfg, mu, pu, Q)
    torch.cuda.synchronize()
    assert got.shape == (B, I) and got.dtype == torch.float32
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
    # a score does not depend on the batch it came in
    row = cuda_scores.cuda_score_catalog(cfg, mu, pu[B - 1:].contiguous(), Q)
    assert torch.equal(row[0], got[B - 1])


B_S = cuda_scores.STREAM_MAX_B  # the last batch size that streams


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kernel", ["linear", "sigmoid", "rbf"])
@pytest.mark.parametrize("shape", [(1, 3001, 200), (B_S, 3001, 200),
                                   (B_S + 1, 3001, 200), (256, 1000, 200),
                                   (3, 777, 1000), (70, 1000, 1000),
                                   (65, 129, 126)])
def test_kernel_matches_plain_at_path_boundaries(cuda, shape, kernel, dtype):
    """Both sides of the streaming/tiled boundary B_s, one and several
    64-row blocks, I not a multiple of any tile, Kp = 1024 (n_factors
    1000) and Kp = 128 with no spare lane (126); within 1e-4 of the plain
    version."""
    B, I, n_factors = shape
    cfg = SGDConfig(kernel=kernel, n_factors=n_factors, gamma=1 / n_factors,
                    min_rating=0.5, max_rating=5.0)
    rng = np.random.default_rng(B + I)
    pu = torch.from_numpy(_rows(cfg, B, rng, "user")).to(cuda, dtype)
    Q = torch.from_numpy(_rows(cfg, I, rng, "item")).to(cuda, dtype)
    mu = torch.tensor(3.5, device=cuda)
    got = cuda_scores.cuda_score_catalog(cfg, mu, pu, Q)
    want = cuda_scores.plain_score_catalog(cfg, mu, pu, Q)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kernel", ["linear", "sigmoid", "rbf"])
def test_scores_are_equal_across_paths(cuda, kernel, dtype):
    """Each row of a B=256 call (tiled) equals, by torch.equal, the same
    user scored alone (B=1, streaming) and inside a batch of B_s: every
    score is the same k-ordered f32 FMA chain on every path."""
    cfg = SGDConfig(kernel=kernel, n_factors=200, gamma=1 / 200,
                    min_rating=0.5, max_rating=5.0)
    rng = np.random.default_rng(7)
    pu = torch.from_numpy(_rows(cfg, 256, rng, "user")).to(cuda, dtype)
    Q = torch.from_numpy(_rows(cfg, 2999, rng, "item")).to(cuda, dtype)
    mu = torch.tensor(3.5, device=cuda)
    whole = cuda_scores.cuda_score_catalog(cfg, mu, pu, Q)
    for r in range(256):
        assert torch.equal(cuda_scores.cuda_score_catalog(cfg, mu, pu[r:r + 1], Q)[0],
                           whole[r]), r
    for g in range(0, 256, B_S):
        assert torch.equal(cuda_scores.cuda_score_catalog(cfg, mu, pu[g:g + B_S], Q),
                           whole[g:g + B_S]), g


def test_score_kernel_refuses_a_plan_that_does_not_cover_the_call(cuda):
    cfg = SGDConfig(n_factors=12)
    mu = torch.tensor(3.0, device=cuda)
    pu = torch.zeros(20, 128, device=cuda)
    Q = torch.zeros(300, 128, device=cuda)
    short = cuda_scores.score_plan(4, 300, 128, 4)._replace(tile=4)  # 4 < 20 users
    before = cuda_scores.launches
    with pytest.raises(RuntimeError):
        cuda_scores.score_with_plan(cfg, mu, pu, Q, short)
    assert cuda_scores.launches == before


def test_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    cfg = SGDConfig(n_factors=12)
    mu = torch.tensor(3.0, device=cuda)
    pu = torch.zeros(4, 128, device=cuda)
    Q = torch.zeros(9, 128, device=cuda)
    for bad in (
        (mu, pu[:, :64].contiguous(), Q[:, :64].contiguous()),  # Kp % 128
        (mu, pu.T.contiguous().T, Q),  # not contiguous
        (mu, pu.half(), Q.half()),  # dtype
        (mu, pu, Q.to(torch.bfloat16)),  # mixed dtypes
        (mu.cpu(), pu, Q),  # device
        (mu.double(), pu, Q),  # mu type
    ):
        with pytest.raises(ValueError):
            cuda_scores.cuda_score_catalog(cfg, *bad)


@pytest.mark.parametrize("kernel", ["linear", "sigmoid", "rbf"])
def test_model_on_cuda_matches_cpu(cuda, kernel):
    rng = np.random.default_rng(3)
    cfg = SGDConfig(kernel=kernel, n_factors=20, gamma=0.05)
    P, Q = _rows(cfg, 64, rng, "user"), _rows(cfg, 400, rng, "item")
    models = []
    for dev in ("cpu", "cuda"):
        m = KernelMF(n_factors=20, kernel=kernel, gamma=0.05, device=dev)
        m.user_vocab, m.item_vocab = IdVocab(range(64)), IdVocab(range(400))
        m.global_mean = 3.0
        m._params = params_from_numpy(P, Q, 3.0, device=dev, cfg=cfg)
        models.append(m)
    cpu, gpu = models
    before = cuda_scores.launches
    a = gpu.recommend_batch(list(range(40)), amount=7)
    assert cuda_scores.launches > before
    b = cpu.recommend_batch(list(range(40)), amount=7)
    assert list(a.item_id) == list(b.item_id)
    np.testing.assert_allclose(a.rating_pred, b.rating_pred, atol=1e-5)
    np.testing.assert_allclose(gpu.predict(b), cpu.predict(b), atol=1e-5)


def _batch(rng, n, n_prim, n_sec, cuda):
    """A primary-sorted batch with runs and weight-0 pads."""
    prim = np.sort(rng.integers(0, n_prim, n)).astype(np.int32)
    sec = rng.integers(0, n_sec, n).astype(np.int32)
    r = rng.uniform(0.5, 5, n).astype(np.float32)
    w = (rng.uniform(size=n) > 0.1).astype(np.float32)
    sp = np.argsort(sec, kind="stable").astype(np.int32)
    return [torch.from_numpy(a).to(cuda) for a in (prim, sec, r, w, sp, sec[sp])]


@pytest.mark.parametrize("kernel", ["linear", "sigmoid", "rbf"])
@pytest.mark.parametrize("n_factors", [12, 126, 200, 500])
@pytest.mark.parametrize("prim_side", ["user", "item"])
def test_sgd_step_and_apply_match_plain(cuda, kernel, n_factors, prim_side):
    """One step (kernel + apply) against the plain step on the same
    tables and batch; atol = rtol = 1e-5 (both sum in f32, in different
    orders). n_factors=126 fills Kp=128 with no spare lane."""
    cfg = SGDConfig(kernel=kernel, n_factors=n_factors, gamma=1 / n_factors,
                    min_rating=0.5, max_rating=5.0, reg=0.01)
    rng = np.random.default_rng(n_factors)
    sec_side = "item" if prim_side == "user" else "user"
    n_prim, n_sec = 300, 700
    P = torch.from_numpy(_rows(cfg, n_prim, rng, prim_side)).to(cuda)
    S = torch.from_numpy(_rows(cfg, n_sec, rng, sec_side)).to(cuda)
    prim, sec, r, w, sp, ss = _batch(rng, 5000, n_prim, n_sec, cuda)
    pm = torch.from_numpy(sgd.update_mask(cfg, prim_side)).to(cuda)
    sm = torch.from_numpy(sgd.update_mask(cfg, sec_side)).to(cuda)
    mu = torch.tensor(3.5, device=cuda)
    Pk, Sk, Pp, Sp = P.clone(), S.clone(), P.clone(), S.clone()
    before = (cuda_sgd.step_launches, cuda_sgd.apply_launches)
    dq = cuda_sgd.cuda_sgd_step(cfg, mu, Pk, Sk, prim, sec, r, w, pm, sm,
                                0.05, cfg.reg)
    cuda_sgd.cuda_segment_apply(Sk, dq, sp, ss)
    assert (cuda_sgd.step_launches, cuda_sgd.apply_launches) == (
        before[0] + 1, before[1] + 1)
    dq_plain = cuda_sgd.plain_sgd_step(cfg, mu, Pp, Sp, prim, sec, r, w, pm,
                                       sm, 0.05, cfg.reg)
    cuda_sgd.plain_segment_apply(Sp, dq_plain, sp, ss)
    torch.cuda.synchronize()
    torch.testing.assert_close(dq, dq_plain, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(Pk, Pp, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(Sk, Sp, atol=1e-5, rtol=1e-5)
    assert not torch.equal(Pk, P) and not torch.equal(Sk, S)
    # frozen primary: the table is not written, dq is the same
    P2 = P.clone()
    dq2 = cuda_sgd.cuda_sgd_step(cfg, mu, P2, S, prim, sec, r, w, pm, sm,
                                 0.05, cfg.reg, update_prim=False)
    assert torch.equal(P2, P) and torch.equal(dq2, dq)
    assert cuda_sgd.cuda_sgd_step(cfg, mu, P2, S, prim, sec, r, w, pm, sm,
                                  0.05, cfg.reg, write_dq=False) is None


def test_sgd_step_is_deterministic(cuda):
    """Long runs and many collisions; the same step twice gives the same
    bits (no float atomics)."""
    cfg = SGDConfig(kernel="sigmoid", n_factors=200, gamma=0.005,
                    min_rating=0.5, max_rating=5.0, reg=0.01)
    rng = np.random.default_rng(0)
    P = torch.from_numpy(_rows(cfg, 50, rng, "user")).to(cuda)
    S = torch.from_numpy(_rows(cfg, 40, rng, "item")).to(cuda)
    prim, sec, r, w, sp, ss = _batch(rng, 200_000, 50, 40, cuda)
    pm = torch.from_numpy(sgd.update_mask(cfg, "user")).to(cuda)
    sm = torch.from_numpy(sgd.update_mask(cfg, "item")).to(cuda)
    mu = torch.tensor(3.5, device=cuda)
    outs = []
    for _ in range(2):
        Pk, Sk = P.clone(), S.clone()
        dq = cuda_sgd.cuda_sgd_step(cfg, mu, Pk, Sk, prim, sec, r, w, pm, sm,
                                    1e-4, cfg.reg)
        cuda_sgd.cuda_segment_apply(Sk, dq, sp, ss)
        outs.append((Pk, Sk))
    torch.cuda.synchronize()
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])


def _step_inputs(cfg, prim, n_prim, n_sec, rng, cuda, pad_tail=0):
    """Tables, a batch over the given sorted primary ids (numpy), masks
    and mu on the card."""
    n = len(prim)
    sec = rng.integers(0, n_sec, n).astype(np.int32)
    r = rng.uniform(0.5, 5, n).astype(np.float32)
    w = np.ones(n, np.float32)
    if pad_tail:
        w[-pad_tail:] = 0.0
    P = torch.from_numpy(_rows(cfg, n_prim, rng, "user")).to(cuda)
    S = torch.from_numpy(_rows(cfg, n_sec, rng, "item")).to(cuda)
    batch = [torch.from_numpy(a).to(cuda)
             for a in (prim.astype(np.int32), sec, r, w)]
    pm = torch.from_numpy(sgd.update_mask(cfg, "user")).to(cuda)
    sm = torch.from_numpy(sgd.update_mask(cfg, "item")).to(cuda)
    return P, S, batch, pm, sm, torch.tensor(3.5, device=cuda)


def _boundary_ids(case, rng):
    """Sorted primary ids that put runs where the step's segments (of
    ``cuda_sgd.SEG_LEN`` entries) have to decide; (ids, weight-0 tail)."""
    L = cuda_sgd.SEG_LEN
    if case == "run_ends_at_boundary":
        return np.r_[np.full(L, 0), np.full(L // 2, 1), np.full(L // 2, 2),
                     np.full(L - 1, 3), [4], np.full(L // 2, 5)], 0
    if case == "run_over_three_segments":
        return np.r_[np.full(L // 2, 0), np.full(L // 2 + 3 * L + 1, 1),
                     np.full(L - 1, 2), np.full(3 * L, 3), [4, 5]], 0
    if case == "single_run":
        return np.full(2 * L + L // 2, 3), 0
    if case == "one_run_of_40_segments":  # past one 32-segment look-up
        return np.r_[[0, 1], np.full(40 * L + 5, 2), [3]], 0
    if case == "ragged":
        return np.sort(rng.integers(0, 9, 5 * L + 3)), 0
    if case == "pad_tail":
        ids = np.sort(rng.integers(0, 9, 4 * L))
        return np.r_[ids, np.full(L + 1, ids[-1])], L + 1
    if case == "skewed":  # floor(rows * U^2): id 0 holds ~4% of 60,000
        return np.sort((600 * rng.random(60_000) ** 2).astype(np.int64)), 0
    raise ValueError(case)


@pytest.mark.parametrize("case", ["run_ends_at_boundary",
                                  "run_over_three_segments", "single_run",
                                  "one_run_of_40_segments", "ragged",
                                  "pad_tail", "skewed"])
@pytest.mark.parametrize("kernel", ["linear", "sigmoid", "rbf"])
def test_sgd_step_where_runs_meet_segment_boundaries(cuda, kernel, case):
    """The step kernel against the plain step (atol = rtol = 1e-5) on
    batches whose runs end at, cross and cover its fixed segments, and on
    a skewed batch; a second run gives the same bits; a frozen primary
    side leaves the table as it was though runs cross; without dq the
    table comes out the same."""
    cfg = SGDConfig(kernel=kernel, n_factors=200, gamma=1 / 200,
                    min_rating=0.5, max_rating=5.0, reg=0.01)
    rng = np.random.default_rng(len(case))
    prim, pad = _boundary_ids(case, rng)
    P, S, batch, pm, sm, mu = _step_inputs(cfg, prim, 600, 700, rng, cuda, pad)
    lr = 1e-3  # a run of thousands of entries sums within the tolerance
    args = (cfg, mu)
    tail = (S, *batch, pm, sm, lr, cfg.reg)
    Pk, Pk2, Pp = P.clone(), P.clone(), P.clone()
    dq = cuda_sgd.cuda_sgd_step(*args, Pk, *tail)
    dq2 = cuda_sgd.cuda_sgd_step(*args, Pk2, *tail)
    dq_plain = cuda_sgd.plain_sgd_step(*args, Pp, *tail)
    torch.cuda.synchronize()
    assert torch.isfinite(Pk).all() and torch.isfinite(dq).all()
    torch.testing.assert_close(dq, dq_plain, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(Pk, Pp, atol=1e-5, rtol=1e-5)
    assert torch.equal(Pk, Pk2) and torch.equal(dq, dq2)
    assert not torch.equal(Pk, P)
    frozen = P.clone()
    dq3 = cuda_sgd.cuda_sgd_step(*args, frozen, *tail, update_prim=False)
    assert torch.equal(frozen, P) and torch.equal(dq3, dq)
    no_dq = P.clone()
    assert cuda_sgd.cuda_sgd_step(*args, no_dq, *tail, write_dq=False) is None
    assert torch.equal(no_dq, Pk)


def test_sgd_step_kernel_refuses_a_plan_it_is_not_compiled_for(cuda,
                                                               monkeypatch):
    cfg = SGDConfig(n_factors=12)
    rng = np.random.default_rng(3)
    prim = np.sort(rng.integers(0, 9, 300))
    P, S, batch, pm, sm, mu = _step_inputs(cfg, prim, 16, 16, rng, cuda)
    plan = cuda_sgd.step_plan
    for change in ({"seg_len": cuda_sgd.SEG_LEN // 2},
                   {"stages": cuda_sgd.STEP_STAGES - 1},
                   {"n_segments": 1}, {"grid": 1000}, {"smem_bytes": 1024}):
        monkeypatch.setattr(cuda_sgd, "step_plan",
                            lambda *a, **k: plan(*a, **k)._replace(**change))
        before, P0 = cuda_sgd.step_launches, P.clone()
        with pytest.raises(RuntimeError):
            cuda_sgd.cuda_sgd_step(cfg, mu, P, S, *batch, pm, sm, 0.05, 0.0)
        torch.cuda.synchronize()
        assert cuda_sgd.step_launches == before and torch.equal(P, P0)


def test_sgd_wrappers_reject_what_the_kernels_do_not_take(cuda):
    cfg = SGDConfig(n_factors=12)
    mu = torch.tensor(3.0, device=cuda)
    P = torch.zeros(8, 128, device=cuda)
    ids = torch.zeros(4, dtype=torch.int32, device=cuda)
    v = torch.ones(4, device=cuda)
    m = torch.ones(128, device=cuda)
    good = [mu, P, P.clone(), ids, ids, v, v, m, m]
    for k, bad in ((3, ids.long()), (5, v.double()), (1, P[:, :64].contiguous()),
                   (2, P.T.contiguous().T), (0, mu.cpu()), (7, m[:64]),
                   (1, torch.zeros(8, 1152, device=cuda))):
        args = list(good)
        args[k] = bad
        with pytest.raises(ValueError):
            cuda_sgd.cuda_sgd_step(cfg, *args, 0.1, 0.0)
    rows = torch.zeros(4, 128, device=cuda)
    with pytest.raises(ValueError):
        cuda_sgd.cuda_segment_apply(P, rows[:, :64].contiguous(), ids, ids)
    with pytest.raises(ValueError):
        cuda_sgd.cuda_segment_apply(P, rows, ids.long(), ids)


@pytest.mark.parametrize("kp", [128, 256, 1024])
@pytest.mark.parametrize("case", ["run_ends_at_boundary",
                                  "run_over_three_segments", "single_run",
                                  "one_run_of_40_segments", "ragged",
                                  "skewed"])
def test_segment_apply_matches_its_order_model(cuda, case, kp):
    """The apply kernel on secondary streams whose runs end at, cross and
    cover its fixed chunks: bitwise its plain order model
    ``segmented_segment_sum`` (chunks of ``APPLY_CHUNK``) and a second run,
    and within atol = rtol = 1e-5 of ``plain_segment_apply``."""
    rng = np.random.default_rng(len(case) + kp)
    ids, _ = _boundary_ids(case, rng)
    n, n_rows = len(ids), int(ids.max()) + 2
    rows = torch.from_numpy(
        (1e-3 * rng.normal(size=(n, kp))).astype(np.float32)).to(cuda)
    table = torch.from_numpy(
        rng.normal(size=(n_rows, kp)).astype(np.float32)).to(cuda)
    perm = torch.from_numpy(rng.permutation(n).astype(np.int32)).to(cuda)
    srt = torch.from_numpy(ids.astype(np.int32)).to(cuda)
    before = cuda_sgd.apply_launches
    got, again, model, want = (table.clone() for _ in range(4))
    cuda_sgd.cuda_segment_apply(got, rows, perm, srt)
    cuda_sgd.cuda_segment_apply(again, rows, perm, srt)
    assert cuda_sgd.apply_launches == before + 2
    ss.segmented_segment_sum(model, rows, perm, srt,
                             chunk=cuda_sgd.APPLY_CHUNK, layout="columns")
    cuda_sgd.plain_segment_apply(want, rows, perm, srt)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert torch.equal(got, model)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


def test_segment_apply_refuses_a_plan_it_is_not_compiled_for(cuda,
                                                             monkeypatch):
    table = torch.zeros(8, 128, device=cuda)
    rows = torch.ones(100, 128, device=cuda)
    perm, srt = ss.sorted_order(torch.arange(100, device=cuda) % 8)
    plan = cuda_sgd.apply_plan
    for change in ({"chunk": cuda_sgd.APPLY_CHUNK * 2}, {"n_chunks": 1},
                   {"grid": 9}, {"finish_grid": 0}):
        monkeypatch.setattr(cuda_sgd, "apply_plan",
                            lambda *a, **k: plan(*a, **k)._replace(**change))
        before = cuda_sgd.apply_launches
        with pytest.raises(RuntimeError):
            cuda_sgd.cuda_segment_apply(table, rows, perm, srt)
        torch.cuda.synchronize()
        assert cuda_sgd.apply_launches == before
        assert torch.equal(table, torch.zeros_like(table))


@pytest.mark.parametrize("kernel", ["linear", "sigmoid", "rbf"])
def test_fit_on_cuda_matches_cpu(cuda, kernel):
    """The same fit on the card and on the CPU: the same initial tables
    would need one generator on both, so the CUDA tables are loaded from
    the CPU model's start and trained with the same batch orders."""
    rng = np.random.default_rng(1)
    u = rng.integers(0, 300, 6000).astype(np.int32)
    i = rng.integers(0, 200, 6000).astype(np.int32)
    r = (np.round(rng.uniform(0.5, 5, 6000) * 2) / 2).astype(np.float32)
    cfg = SGDConfig(kernel=kernel, n_factors=20, lr=0.05, reg=0.02,
                    gamma=0.05, min_rating=0.5, max_rating=5.0, batch_size=512)
    p0 = sgd.init_params(torch.Generator().manual_seed(0), 300, 200, cfg, 2.75)
    orders = [torch.randperm(12, generator=torch.Generator().manual_seed(e))
              for e in range(3)]
    out = {}
    for dev in ("cpu", "cuda"):
        data = sgd.pack_ratings(u, i, r, 512, order="user", device=dev)
        start = p0._replace(**{k: getattr(p0, k).to(dev) for k in p0._fields})
        before = cuda_sgd.step_launches
        out[dev] = sgd.sgd_train(start, data, None, cfg, 3, cfg.lr,
                                 batch_orders=orders)
        if dev == "cuda":
            assert cuda_sgd.step_launches == before + 3 * data.n_batches
    (pc, hc), (pg, hg) = out["cpu"], out["cuda"]
    torch.testing.assert_close(pg.user_features.cpu(), pc.user_features,
                               atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(pg.item_features.cpu(), pc.item_features,
                               atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(hg.cpu(), hc, atol=1e-5, rtol=1e-5)
    m = KernelMF(n_factors=20, kernel=kernel, n_epochs=2, lr=0.05, reg=0.02,
                 batch_size=512, device="cuda")
    X = pd.DataFrame({"user_id": u, "item_id": i}).drop_duplicates()
    before = cuda_sgd.step_launches
    m.fit(X, pd.Series(r[X.index]))
    assert m._params.user_features.device.type == "cuda"
    assert len(m.train_rmse) == 2 and np.isfinite(m.train_rmse).all()
    assert cuda_sgd.step_launches == before + 2 * -(-len(X) // 512)


def _scaled_grams(rng, E, d, device, L=64):
    """Ridged grams Jacobi-scaled to a unit diagonal, as ``spd_solve``
    hands them to the leaf."""
    X = rng.standard_normal((E, L, d)).astype(np.float32) * 0.3
    A = np.einsum("eld,elf->edf", X, X) + 0.5 * np.eye(d, dtype=np.float32)
    A = torch.from_numpy(A.astype(np.float32)).to(device)
    ds = torch.rsqrt(torch.diagonal(A, dim1=-2, dim2=-1))
    return (A * ds[:, :, None] * ds[:, None, :]).contiguous()


@pytest.mark.parametrize("E,d", [(5, 1), (3, 8), (130, 33), (257, 64),
                                 (64, 97), (64, 104), (40, 111), (50, 128)])
def test_gj_kernel_matches_plain(cuda, E, d):
    """Every column count a lane can own (1-4), d = 111 and 128 past the
    48 KB shared-memory opt-in; atol = rtol = 1e-4 between kernel and plain
    (f32, FMA-contracted in the kernel), |A A^-1 - I| < 5e-3 (the JAX
    bar) and the same bits twice."""
    A = _scaled_grams(np.random.default_rng(d), E, d, cuda)
    before = cuda_spd.launches
    got = cuda_spd.cuda_gj_inverse(A)
    assert cuda_spd.launches == before + 1
    want = cuda_spd.plain_gj_inverse(A)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
    eye = torch.eye(d, dtype=torch.float64, device=cuda)
    assert float((A.double() @ got.double() - eye).abs().max()) < 5e-3
    assert torch.equal(cuda_spd.cuda_gj_inverse(A), got)


@pytest.mark.parametrize("max_d", [t[0] for t in cuda_spd._GJ_TILES])
def test_gj_kernel_matches_plain_at_every_d(cuda, max_d):
    """Every d in [1, 128], grouped by the register tile that takes it;
    E = 7 leaves the last block of four small matrices part empty.
    Within 1e-4 of the plain version and |A A^-1 - I| < 5e-3."""
    lo = max([t[0] for t in cuda_spd._GJ_TILES if t[0] < max_d], default=0) + 1
    for d in range(lo, max_d + 1):
        A = _scaled_grams(np.random.default_rng(d), 7, d, cuda)
        got = cuda_spd.cuda_gj_inverse(A)
        want = cuda_spd.plain_gj_inverse(A)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4, msg=f"d={d}")
        eye = torch.eye(d, dtype=torch.float64, device=cuda)
        assert float((A.double() @ got.double() - eye).abs().max()) < 5e-3, d


@pytest.mark.parametrize("d", [1, 7, 64, 97, 104, 128])
def test_gj_kernel_in_place_and_unaligned(cuda, d):
    """``mf_gj_inverse`` with ``out`` the same tensor as ``A`` (the C
    interface allows it), and a batch that starts 1-3 floats past a
    16-byte boundary: the same bits as the out-of-place call."""
    A = _scaled_grams(np.random.default_rng(d), 9, d, cuda)
    want = cuda_spd.cuda_gj_inverse(A)
    X = A.clone()
    plan = cuda_spd.gj_plan(d)
    lib = cuda_spd._library()
    rc = lib.mf_gj_inverse(X.data_ptr(), X.data_ptr(), 9, d, plan.side,
                           plan.regs, plan.per_block, plan.smem_bytes,
                           torch.cuda.current_stream().cuda_stream)
    assert rc == 0
    torch.cuda.synchronize()
    assert torch.equal(X, want)
    for shift in (1, 2, 3):
        buf = torch.zeros(A.numel() + shift, device=cuda)
        view = buf[shift:].view(A.shape)
        view.copy_(A)
        assert torch.equal(cuda_spd.cuda_gj_inverse(view), want)


def test_gj_on_cuda_never_takes_the_plain_path(cuda, monkeypatch):
    def refuse(A):
        raise AssertionError("the plain leaf ran on a CUDA tensor")

    monkeypatch.setattr(cuda_spd, "plain_gj_inverse", refuse)
    A = _scaled_grams(np.random.default_rng(0), 9, 201, cuda, L=256)
    before = cuda_spd.launches
    cuda_spd.gj_inverse(A[:, :100, :100].contiguous())
    inv = spd.spd_inverse(A)  # d = 201: two leaves, 104 and 97
    torch.cuda.synchronize()
    assert cuda_spd.launches == before + 3
    torch.testing.assert_close(inv, torch.linalg.inv(A), atol=1e-3, rtol=1e-3)


def test_gj_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    A = torch.eye(6, device=cuda)[None].repeat(3, 1, 1)
    for bad in (torch.eye(129, device=cuda)[None], A.double(), A.cpu(),
                A.transpose(1, 2), A[0]):
        with pytest.raises(ValueError):
            cuda_spd.cuda_gj_inverse(bad)
    assert cuda_spd.cuda_gj_inverse(A[:0]).shape == (0, 6, 6)


def test_als_on_cuda_matches_cpu_and_launches(cuda):
    """The same ALS sweeps on the card and on the CPU from the same
    tables (atol 2e-4, the JAX bar between two ALS paths); the models'
    fits on the card launch the leaf."""
    rng = np.random.default_rng(2)
    flat = rng.choice(300 * 200, 6000, replace=False)
    u, i = (flat // 200).astype(np.int32), (flat % 200).astype(np.int32)
    r = (np.round(rng.uniform(0.5, 5, 6000) * 2) / 2).astype(np.float32)
    cfg = SGDConfig(n_factors=100, reg=0.1, batch_size=512)
    p0 = sgd.init_params(torch.Generator().manual_seed(0), 300, 200, cfg, 2.75)
    out = {}
    for dev in ("cpu", "cuda"):
        start = p0._replace(**{k: getattr(p0, k).to(dev) for k in p0._fields})
        bu, bi = ials.group_both_sides_bucketed(u, i, r, 300, 200,
                                                max_block_rows=2000, device=dev)
        data = sgd.pack_ratings(u, i, r, 512, device=dev)
        before = cuda_spd.launches
        out[dev] = ials.ials_train_bucketed(start, bu, bi, data, cfg, 2,
                                            reg_scale="per_obs")
        if dev == "cuda":
            assert cuda_spd.launches == before + 2 * (len(bu) + len(bi))
    (pc, hc), (pg, hg) = out["cpu"], out["cuda"]
    torch.testing.assert_close(pg.user_features.cpu(), pc.user_features,
                               atol=2e-4, rtol=0)
    torch.testing.assert_close(pg.item_features.cpu(), pc.item_features,
                               atol=2e-4, rtol=0)
    torch.testing.assert_close(hg.cpu(), hc, atol=1e-4, rtol=0)
    X = pd.DataFrame({"user_id": u, "item_id": i})
    before = cuda_spd.launches
    m = KernelMF(n_factors=20, n_epochs=2, method="als", reg=0.1,
                 device="cuda").fit(X, pd.Series(r))
    assert cuda_spd.launches > before and np.isfinite(m.train_rmse).all()
    before = cuda_spd.launches
    ImplicitALS(n_factors=16, n_epochs=2, device="cuda").fit(X, pd.Series(r))
    assert cuda_spd.launches == before + 4


# ---------------------------------------------------------------------------
# The segment sum and the models it carries
# ---------------------------------------------------------------------------


def _segsum_stream(case, rng):
    """(ids, n_rows, d) at the shapes of ``chip_smoke.py``'s compare phase
    (MovieLens-1M: 1M ratings, 6,040 users, 3,706 items; item ids skewed
    towards the head), a batch, and a long segment beside 300,000 others
    (three columns here)."""
    if case == "by_user":
        return rng.integers(0, 6040, 1_000_000), 6040, 1
    if case == "by_item":
        return (3706 * rng.random(1_000_000) ** 2).astype(np.int64), 3706, 1
    if case == "profiles":
        return rng.integers(0, 6040, 1_000_000), 6040, 18
    if case == "batch":
        return rng.integers(0, 6040, 4096), 6040, 1
    if case == "long":
        ids = np.concatenate([np.full(200_000, 3020),
                              rng.integers(0, 6040, 300_000)])
        return ids, 6040, 3
    if case == "straddle":  # runs of 1-19 across the lanes' slices of 8
        ids = np.repeat(np.arange(50_000), rng.integers(1, 20, 50_000))
        return ids, 50_000, 1
    if case == "unaligned":  # n = 2 * 256 + 13, ids and perm at offset 1
        return np.sort(rng.integers(0, 40, 2 * 256 + 13)), 40, 1
    return np.array([2, 2, 0]), 4, 33  # tiny, d past one warp's columns


@pytest.mark.parametrize("case", ["by_user", "by_item", "profiles", "batch",
                                  "long", "tiny", "straddle", "unaligned"])
def test_segment_sum_kernel_matches_plain(cuda, case):
    """Against ``index_add_`` (rtol 1e-5, atol 1e-5 x the row's absolute
    sum), bitwise against its plain model ``segmented_segment_sum`` (the
    same adds in the same order) and against a second run."""
    rng = np.random.default_rng(4)
    ids, n_rows, d = _segsum_stream(case, rng)
    ids_t = torch.from_numpy(ids.astype(np.int32)).to(cuda)
    vals = torch.from_numpy(
        rng.normal(size=(len(ids), d)).astype(np.float32)).to(cuda)
    base = torch.from_numpy(
        rng.normal(size=(n_rows, d)).astype(np.float32)).to(cuda)
    order = ss.sorted_order(ids_t)
    if case == "unaligned":  # views 4 bytes into their storage
        order = tuple(torch.cat([t[:1], t])[1:] for t in order)
        assert order[0].data_ptr() % 16 == 4
    before = ss.launches
    got = base.clone()
    ss.cuda_segment_sum(got, vals, *order)
    assert ss.launches == before + 1
    again = base.clone()
    ss.cuda_segment_sum(again, vals, *order)
    model = base.clone()
    ss.segmented_segment_sum(model, vals, *order)
    want = base.clone()
    ss.plain_segment_sum(want, vals, *order)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert torch.equal(got, model)
    scale = base.abs().clone()
    ss.plain_segment_sum(scale, vals.abs(), *order)
    assert torch.all((got - want).abs() <= 1e-5 * (want.abs() + scale))


def test_segment_sum_refuses_what_it_does_not_take(cuda, monkeypatch):
    out = torch.zeros(8, 2, device=cuda)
    vals = torch.ones(5, 2, device=cuda)
    perm, ids = ss.sorted_order(torch.tensor([1, 1, 3, 0, 7], device=cuda))
    for bad in ((out.double(), vals, perm, ids), (out, vals, perm.long(), ids),
                (out, vals[:, :1], perm, ids), (out, vals.T.contiguous().T,
                                                perm, ids),
                (out.cpu(), vals, perm, ids)):
        with pytest.raises(ValueError):
            ss.cuda_segment_sum(*bad)
    ss.cuda_segment_sum(out, vals[:0], perm[:0], ids[:0])  # nothing to add
    assert torch.equal(out, torch.zeros_like(out))
    plan = ss.segsum_plan
    for change in ({"chunk": ss.CHUNK // 2}, {"n_chunks": 5}, {"grid": 9},
                   {"finish_grid": 7}, {"layout": "entries"}):
        monkeypatch.setattr(ss, "segsum_plan",
                            lambda *a, **k: plan(*a, **k)._replace(**change))
        with pytest.raises(RuntimeError):
            ss.cuda_segment_sum(out, vals, perm, ids)
        torch.cuda.synchronize()
        assert torch.equal(out, torch.zeros_like(out))


def _ml_shaped(n=8000, n_users=400, n_items=250, seed=3):
    rng = np.random.default_rng(seed)
    flat = rng.choice(n_users * n_items, n, replace=False)
    X = pd.DataFrame({"user_id": flat // n_items, "item_id": flat % n_items})
    y = pd.Series(np.round(rng.uniform(0.5, 5, n) * 2) / 2)
    return X, y


@pytest.mark.parametrize("method", ["als", "sgd"])
def test_baseline_on_cuda_matches_cpu_and_repeats(cuda, method):
    """ALS: the same sweeps on both devices (atol 1e-5); SGD: the card's
    fit from its own generator twice, bitwise, and the CPU's trained from
    the card's permutations (atol 1e-5). The segment sum launches."""
    from matrix_factorization_tpu_torch import BaselineModel
    from matrix_factorization_tpu_torch.ops import als

    X, y = _ml_shaped()
    kw = dict(method=method, n_epochs=5, reg=0.5 if method == "als" else 0.02,
              lr=0.02, min_rating=0.5, batch_size=512)
    before = ss.launches
    a = BaselineModel(device="cuda", **kw).fit(X, y)
    assert ss.launches > before
    b = BaselineModel(device="cuda", **kw).fit(X, y)
    assert torch.equal(a._params.user_biases, b._params.user_biases)
    assert torch.equal(a._params.item_biases, b._params.item_biases)
    if method == "als":
        c = BaselineModel(device="cpu", **kw).fit(X, y)
        np.testing.assert_allclose(a.user_biases, c.user_biases, atol=1e-5)
        np.testing.assert_allclose(a.item_biases, c.item_biases, atol=1e-5)
        return
    data = {d: sgd.pack_ratings(*a._preprocess_fit(X, y), 512, device=d)
            for d in ("cpu", "cuda")}
    orders = [torch.randperm(data["cpu"].user_ids.numel(),
                             generator=torch.Generator().manual_seed(e))
              for e in range(3)]
    out = {}
    for d in ("cpu", "cuda"):
        p0 = als.init_bias_params(1024, a.n_items, 3.0, device=d)
        out[d], _ = als.bias_sgd_train(p0, data[d], None, 0.02, 0.02, 3, 512,
                                       orders=orders)
    for f in ("user_biases", "item_biases"):
        np.testing.assert_allclose(getattr(out["cuda"], f).cpu().numpy(),
                                   getattr(out["cpu"], f).numpy(), atol=1e-5)


@pytest.mark.parametrize("cls", ["UserUserCF", "ItemItemCF"])
def test_cf_on_cuda_matches_cpu(cuda, cls):
    """Predictions atol 1e-4 (TF32 off, the similarity product in other
    orders), two fits bitwise equal."""
    import matrix_factorization_tpu_torch as mf

    X, y = _ml_shaped()
    a = getattr(mf, cls)(n_neighbors=20, device="cuda").fit(X, y)
    b = getattr(mf, cls)(n_neighbors=20, device="cuda").fit(X, y)
    c = getattr(mf, cls)(n_neighbors=20, device="cpu").fit(X, y)
    assert torch.equal(a._state.sim, b._state.sim)
    pairs = X.sample(2000, random_state=0)
    np.testing.assert_allclose(a.predict(pairs), c.predict(pairs), atol=1e-4)
    assert a.predict(pairs) == b.predict(pairs)


def test_content_and_sweep_on_cuda_match_cpu(cuda):
    import matrix_factorization_tpu_torch as mf

    X, y = _ml_shaped()
    rng = np.random.default_rng(5)
    feats = pd.DataFrame(rng.integers(0, 2, (250, 18)).astype(float),
                         columns=[f"g{j}" for j in range(18)])
    feats.insert(0, "item_id", np.arange(250))
    before = ss.launches
    got = {d: mf.ContentBasedRecommender(device=d, min_rating=0.5).fit(
        X, y, item_features=feats) for d in ("cuda", "cpu")}
    assert ss.launches == before + 2  # the profile and its weight
    np.testing.assert_allclose(got["cuda"]._profiles.cpu().numpy(),
                               got["cpu"]._profiles.numpy(), atol=1e-5)
    cut = 6000
    args = (X.iloc[:cut], y.iloc[:cut], X.iloc[cut:], y.iloc[cut:])
    kw = dict(lrs=[0.005, 0.02], regs=[0.01, 0.1], n_epochs=3, n_factors=16,
              batch_size=512)
    before = cuda_sgd.step_launches
    m, res = mf.grid_search_kernel_mf(*args, device="cuda", **kw)
    assert cuda_sgd.step_launches == before + 4 * 3 * -(-cut // 512)
    m2, res2 = mf.grid_search_kernel_mf(*args, device="cuda", **kw)
    assert torch.equal(m._params.user_features, m2._params.user_features)
    assert res == res2 and np.isfinite(res[0]["val_rmse"])
    # the sweep on both devices from one start and one set of orders
    from matrix_factorization_tpu_torch.ops import sweep

    cfg = m._cfg()
    u, i, r = m._preprocess_fit(X, y)
    p0 = sgd.init_params(torch.Generator().manual_seed(0), m.n_users,
                         m.n_items, cfg, float(r.mean()))
    orders = [torch.randperm(-(-len(r) // 512),
                             generator=torch.Generator().manual_seed(e))
              for e in range(3)]
    out = {}
    for d in ("cpu", "cuda"):
        data = sgd.pack_ratings(u, i, r, 512, device=d)
        start = p0._replace(**{k: getattr(p0, k).to(d) for k in p0._fields})
        out[d], _ = sweep.grid_train(data, m.n_users, m.n_items, cfg, 3,
                                     kw["lrs"], kw["regs"][:1] * 2,
                                     float(r.mean()), init=start,
                                     batch_orders=orders)
    torch.testing.assert_close(out["cuda"].user_features.cpu(),
                               out["cpu"].user_features, atol=1e-4, rtol=1e-4)


def test_similarity_topk_on_cuda_matches_cpu(cuda):
    """Half-star ratings: the gram is exact in any order, so the two
    devices agree to the cosine's last bits; ids equal where the values
    are separated by more than 1e-5, and a second run is bitwise equal."""
    from matrix_factorization_tpu_torch.ops import sparse_gram

    rng = np.random.default_rng(9)
    n_users, n_items = 900, 700
    flat = rng.choice(n_users * n_items, 30_000, replace=False)
    u = (flat // n_items).astype(np.int32)
    i = (flat % n_items).astype(np.int32)
    r = (rng.integers(1, 11, len(u)) * 0.5).astype(np.float32)
    kw = dict(k=20, user_block=256, item_tile=128)
    got = sparse_gram.similarity_topk(u, i, r, n_users, n_items, device="cuda", **kw)
    again = sparse_gram.similarity_topk(u, i, r, n_users, n_items, device="cuda", **kw)
    want = sparse_gram.similarity_topk(u, i, r, n_users, n_items, device="cpu", **kw)
    for a, b in zip(got, again):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(got[0], want[0], atol=1e-5)
    np.testing.assert_array_equal(got[2], want[2])
    sep = np.ones_like(got[0], bool)
    gaps = np.abs(np.diff(want[0], axis=1)) > 1e-5
    sep[:, 1:] &= gaps
    sep[:, :-1] &= gaps
    np.testing.assert_array_equal(got[1][sep], want[1][sep])
    # user-user: the axes swapped
    got_u = sparse_gram.similarity_topk(i, u, r, n_items, n_users, device="cuda", **kw)
    want_u = sparse_gram.similarity_topk(i, u, r, n_items, n_users, device="cpu", **kw)
    np.testing.assert_allclose(got_u[0], want_u[0], atol=1e-5)


@pytest.mark.parametrize("cls", ["TopKItemItemCF", "TopKUserUserCF"])
def test_topk_cf_on_cuda_matches_cpu(cuda, cls):
    import matrix_factorization_tpu_torch as mf

    X, y = _ml_shaped()
    a = getattr(mf, cls)(n_neighbors=20, device="cuda").fit(X, y)
    c = getattr(mf, cls)(n_neighbors=20, device="cpu").fit(X, y)
    pairs = X.sample(3000, random_state=1)
    np.testing.assert_allclose(a.predict(pairs), c.predict(pairs), atol=1e-4)
    assert torch.equal(a._flat_q.cpu(), c._flat_q)


def test_ease_on_cuda_matches_cpu_and_launches_the_leaf(cuda, tmp_path):
    """B atol 1e-4 against the CPU fit (the gram is exact; the inverse
    sums in other orders), the GJ leaf launched by the fit, a checkpoint
    round trip on the card."""
    import matrix_factorization_tpu_torch as mf

    X, y = _ml_shaped()
    before = cuda_spd.launches
    a = mf.EASE(reg=50.0, device="cuda").fit(X, y)
    assert cuda_spd.launches > before
    c = mf.EASE(reg=50.0, device="cpu").fit(X, y)
    np.testing.assert_allclose(a._params.item_weights.cpu().numpy(),
                               c._params.item_weights.numpy(), atol=1e-4)
    users = X["user_id"].unique()[:16].tolist()
    np.testing.assert_allclose(
        a.recommend_batch(users, amount=10)["rating_pred"],
        c.recommend_batch(users, amount=10)["rating_pred"], atol=1e-4)
    mf.save_model(a, tmp_path / "ease")
    back = mf.load_model(tmp_path / "ease")
    assert torch.equal(back._params.item_weights, a._params.item_weights)


def test_native_packs_on_cuda_equal_numpy(cuda):
    """The native pack and ALS pack land on the card byte-equal to the
    numpy versions."""
    rng = np.random.default_rng(2)
    u = rng.integers(0, 3000, 200_000).astype(np.int32)
    i = rng.integers(0, 1000, 200_000).astype(np.int32)
    r = (rng.integers(1, 11, 200_000) * 0.5).astype(np.float32)
    a = sgd.pack_ratings(u, i, r, 16_384, order="auto", device="cuda")
    b = sgd.pack_ratings(u, i, r, 16_384, order="auto", device="cuda", native=False)
    for name in ("user_ids", "item_ids", "ratings", "weights", "sec_perm",
                 "sec_ids_sorted"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    for x, y in zip(ials.group_both_sides_bucketed(u, i, r, 3000, 1000, device="cuda"),
                    ials.group_both_sides_bucketed(u, i, r, 3000, 1000, device="cuda",
                                                   native=False)):
        for bx, by in zip(x, y):
            assert all(torch.equal(s, t) for s, t in zip(bx, by))


# -- BPR, SVD++ and NMF: every training scatter on the segment-sum kernels --

FAMILY_TOL = {"bpr": 1e-4, "svdpp": 2e-4, "nmf": 1e-4}


def _family_epoch(family, data, tables, n_items, seed):
    """One epoch of ``family`` on ``data`` from ``tables`` (host numpy)
    with draws made from ``seed`` on the host: the tables it returns."""
    from matrix_factorization_tpu_torch.ops import bpr, nmf, svdpp

    dev = data.user_ids.device
    rng = np.random.default_rng(seed)
    order = [rng.permutation(data.n_batches)]
    cfg = SGDConfig(kernel="linear", n_factors=64, lr=0.01, reg=0.02,
                    min_rating=0.5, max_rating=5.0)
    u = data.user_ids.reshape(-1).cpu().numpy()[data.weights.reshape(-1).cpu().numpy() > 0]
    if family == "bpr":
        negs = [rng.integers(0, n_items, (data.n_batches, data.batch_size))]
        p = params_from_numpy(tables[0], tables[1], 0.0, device=dev)
        out, _ = bpr.bpr_train_tiled(p, data, None, cfg, 1, 0.05, n_items,
                                     batch_orders=order, negatives=negs)
        return out.user_features, out.item_features
    if family == "svdpp":
        p = svdpp.svdpp_params_from_numpy(*tables, 3.0, device=dev)
        wvec = svdpp._neighbor_weights(u, 3000, tables[0].shape[0])
        deg = np.ones(tables[1].shape[0], np.float32)
        out, _ = svdpp.svdpp_train_batched(
            p, data, torch.from_numpy(wvec).to(dev),
            torch.from_numpy(deg).to(dev), None, cfg, 1, 0.01, 0.02,
            batch_orders=order)
        return (out.user_features, out.item_features, out.implicit_features,
                out.user_implicit_sums)
    p = params_from_numpy(np.abs(tables[0]), np.abs(tables[1]), 0.0, device=dev)
    cnt = [torch.from_numpy(np.bincount(
        ids, minlength=t.shape[0]).astype(np.float32)).to(dev)
        for ids, t in ((u, tables[0]), (np.arange(n_items), tables[1]))]
    out, _ = nmf.nmf_train(p, data, *cnt, cfg, 1, 0.06, 0.06)
    return out.user_features, out.item_features


@pytest.mark.parametrize("family", ["bpr", "svdpp", "nmf"])
def test_family_epoch_on_cuda_matches_plain_and_repeats(cuda, family,
                                                        monkeypatch):
    """One epoch through the kernels twice (bitwise equal), and through the
    plain versions (``index_add_``) on the card from the same tables and
    draws: atol 1e-4 (BPR, NMF), 2e-4 (SVD++)."""
    rng = np.random.default_rng(6)
    flat = rng.choice(3000 * 2000, 60_000, replace=False)
    u = (flat // 2000).astype(np.int32)
    i = (flat % 2000).astype(np.int32)
    r = (rng.integers(1, 11, len(u)) * 0.5).astype(np.float32)
    data = sgd.pack_ratings(u, i, r, 8192, order="user", device=cuda)
    tables = [rng.normal(0, 0.1, (n, 128)).astype(np.float32)
              for n in (3000, 2000, 2000, 3000)]
    for t in tables[:2]:
        t[:, 64:] = 0.0
        t[:, 65 if t is tables[0] else 64] = 1.0
    tables[2][:, 64:] = 0.0
    tables[3][:, 64:] = 0.0
    tables = tables if family == "svdpp" else tables[:2]
    counts = (cuda_sgd.apply_launches, ss.launches)
    got = _family_epoch(family, data, tables, 2000, 1)
    again = _family_epoch(family, data, tables, 2000, 1)
    launched = (cuda_sgd.apply_launches - counts[0], ss.launches - counts[1])
    assert launched[1 if family == "nmf" else 0] > 0
    monkeypatch.setattr(cuda_sgd, "segment_apply", cuda_sgd.plain_segment_apply)
    monkeypatch.setattr(ss, "segment_sum", lambda out, *a: (
        ss.plain_segment_sum(out, *a), out)[1])
    plain = _family_epoch(family, data, tables, 2000, 1)
    torch.cuda.synchronize()
    for a, b, c in zip(got, again, plain):
        assert torch.equal(a, b)
        np.testing.assert_allclose(a.cpu().numpy(), c.cpu().numpy(),
                                   atol=FAMILY_TOL[family])


@pytest.mark.parametrize("family", ["BPR", "SVDpp", "NMF"])
def test_family_models_on_cuda(cuda, family, tmp_path):
    """fit twice (bitwise), ``update_users`` with the item side bitwise
    unchanged, ``recommend_batch`` on the scorer, a checkpoint round trip
    on the card (bitwise)."""
    import matrix_factorization_tpu_torch as mf

    X, y = _ml_shaped()
    kw = dict(n_factors=16, n_epochs=3, batch_size=1024)
    cls = getattr(mf, family)
    a = cls(device="cuda", **kw).fit(X, y)
    b = cls(device="cuda", **kw).fit(X, y)
    for s, t in zip(a._params, b._params):
        assert torch.equal(s, t)
    Q = a._params.item_features.clone()
    upd = X.iloc[:40].assign(user_id=10_000 + np.arange(40) // 2)
    a.update_users(upd, y.iloc[:40], n_epochs=2)
    assert torch.equal(a._params.item_features, Q)
    before = cuda_scores.launches
    rec = a.recommend_batch(X.user_id.unique()[:8].tolist(), amount=5)
    assert cuda_scores.launches > before and len(rec) == 40
    mf.save_model(a, tmp_path / family)
    back = mf.load_model(tmp_path / family)
    for s, t in zip(a._params, back._params):
        assert torch.equal(s, t)


def _f64_topk(emb, q, k):
    """Host float64 scores and their top-k positions under the port's tie
    rule (score descending, then position ascending)."""
    s = emb.astype(np.float64) @ q.astype(np.float64)
    return s, np.lexsort((np.arange(len(s)), -s))[:k]


@pytest.mark.parametrize("B", [1, 64])
def test_dense_search_on_cuda_matches_host_f64(cuda, B):
    """``search_topk_batch`` / ``search_topk_pos`` on the card against a
    float64 numpy top-k on the host: values within 1e-5, positions equal
    except where the f64 scores tie within 1e-6 at the cut."""
    from matrix_factorization_tpu_torch.retrieval import index, search

    rng = np.random.default_rng(B)
    emb = rng.standard_normal((200_003, 128), dtype=np.float32)
    ix = index.build_dense_index(list(range(len(emb))), [""] * len(emb), emb)
    Q = ix.embeddings[rng.integers(0, len(emb), B)] + 0.01
    vals, pos = search.search_topk_batch(ix, Q, 50, device="cuda")
    for r in range(B):
        s, want = _f64_topk(ix.embeddings, Q[r], 51)
        np.testing.assert_allclose(vals[r], s[pos[r]], atol=1e-5)
        np.testing.assert_allclose(vals[r], s[want[:50]], atol=1e-5)
        gap = np.abs(np.diff(s[want])) > 1e-6
        sep = (np.concatenate([[True], gap[:-1]]) & gap)
        assert (pos[r] == want[:50])[sep].all()
    # exact ties (small dyadic values: every sum exact in any order) keep
    # the lower positions, at the cut too
    tied = rng.integers(-4, 5, (1_000, 16)).astype(np.float32) / 8
    tied[[7, 500, 999]] = tied[3]
    tix = index.build_dense_index(list(range(1_000)), [""] * 1_000, tied,
                                  normalize=False)
    rows = search.search_topk_pos(tix, tied[3], 3, device="cuda")
    assert [r[0] for r in rows] == [3, 7, 500]


@pytest.mark.parametrize("body", ["_sort_topk", "_select_topk",
                                  "_select_topk_sorting_ties"])
@pytest.mark.parametrize("scores", ["small_ints", "signed_zeros", "nans",
                                    "steps_wide"])
def test_stable_topk_bodies_on_cuda_are_the_tie_rule(cuda, scores, body,
                                                     monkeypatch):
    """Both bodies of ``ops/scoring.py::stable_topk`` on the card against
    ``np.lexsort`` (score descending, then position ascending, a NaN
    first), exactly: ties inside the k and at the cut, ``-0.0`` beside
    ``0.0``, NaNs, and rows wider than a sort's small-segment path."""
    from matrix_factorization_tpu_torch.ops import scoring

    rng = np.random.default_rng(["small_ints", "signed_zeros", "nans",
                                 "steps_wide"].index(scores))
    B, n = (6, 300_001) if scores == "steps_wide" else (9, 4_099)
    s = rng.integers(-3, 4, (B, n)).astype(np.float32)
    if scores == "steps_wide":
        s = (np.round(rng.standard_normal((B, n)) * 64) / 64).astype(np.float32)
    if scores == "signed_zeros":
        s[(s == 0) & (rng.random((B, n)) < 0.5)] = -0.0
    if scores == "nans":
        s[rng.random((B, n)) < 0.01] = np.nan
    if body == "_select_topk_sorting_ties":
        monkeypatch.setattr(scoring, "SELECT_MAX_TIED", 0)
        body = "_select_topk"
    key = np.where(np.isnan(s), -np.inf, -(s + 0.0))
    for k in (1, 10, 50):
        v, i = getattr(scoring, body)(torch.from_numpy(s).cuda(), k)
        want = np.stack([np.lexsort((np.arange(n), row))[:k] for row in key])
        np.testing.assert_array_equal(i.cpu().numpy(), want)
        np.testing.assert_array_equal(v.cpu().numpy(),
                                      np.take_along_axis(s, want, 1))


def test_tfidf_blocks_on_cuda_match_scipy(cuda):
    """The batched TF-IDF path on the card (non-accumulating block writes,
    f32 block products) against scipy's CSR product: within 1e-5."""
    import scipy.sparse as sp

    from matrix_factorization_tpu_torch.retrieval import index, sparse_scoring

    rng = np.random.default_rng(0)
    n, vocab, per_row = 30_011, 5_000, 16
    start = rng.integers(0, vocab, n)
    step = rng.integers(1, vocab // per_row, n)
    cols = (start[:, None] + step[:, None] * np.arange(per_row)) % vocab
    M = sp.csr_matrix((rng.uniform(0.1, 1.0, n * per_row).astype(np.float32),
                       cols.ravel(), np.arange(0, n * per_row + 1, per_row)),
                      shape=(n, vocab))
    M = sp.csr_matrix(M.multiply(1.0 / np.sqrt(M.multiply(M).sum(1))))

    class Vec:
        def transform(self, queries):
            return M[[int(q) for q in queries]]

    ix = index.TfidfItemIndex(item_ids=list(range(n)), texts=[""] * n,
                              vectorizer=Vec(), matrix=M)
    queries = [str(q) for q in rng.integers(0, n, 24)]
    got = sparse_scoring.tfidf_batch_scores(ix, queries, vocab_block=512,
                                            device="cuda")
    want = (M @ Vec().transform(queries).T).toarray().T
    np.testing.assert_allclose(got, want, atol=1e-5)
    vals, pos = sparse_scoring.tfidf_batch_topk(ix, queries, 5, vocab_block=512,
                                                device="cuda")
    assert [pos[r, 0] for r in range(24)] == [int(q) for q in queries]
    np.testing.assert_allclose(vals[:, 0], 1.0, atol=1e-5)


def test_pipeline_train_and_evaluate_default_to_cuda(cuda, tmp_path):
    """The pipeline's ``train`` then ``evaluate`` with no ``--platform``:
    the model trains on the card, ``model.pkl`` loads back onto it, and
    ``evaluate``'s recommendations launch the catalog scorer."""
    import json

    from matrix_factorization_tpu_torch.core.artifacts import load_pickle
    from matrix_factorization_tpu_torch.pipeline import evaluate, train

    X, y = _ml_shaped()
    (tmp_path / "data").mkdir()
    X.assign(item_id=X["item_id"].astype(str), rating=y).to_parquet(
        tmp_path / "data" / "ratings.parquet", index=False)

    def run(module, argv):
        return run_cli(module, ["--root", str(tmp_path)] + argv)

    run(train, ["--model", "kernel_mf", "--kernel", "sigmoid", "--factors", "16",
                "--epochs", "3", "--lr", "0.01", "--batch-size", "2048"])
    model = load_pickle(tmp_path / "artifacts" / "model.pkl")
    assert model._params.item_features.device.type == "cuda"
    assert model.train_rmse[-1] < model.train_rmse[0]
    before = cuda_scores.launches
    res = json.loads(run(evaluate, ["--k", "10", "--positive-threshold", "3.0",
                                    "--max-users", "50"]).strip().splitlines()[-1])
    assert res["n_users"] > 0
    assert cuda_scores.launches - before >= res["n_users"]
