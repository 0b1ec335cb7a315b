"""The port's CUDA kernels on the card, against their plain versions: the
catalog scorer, the SGD step, the secondary-side apply, the Gauss-Jordan
SPD leaf, the SPD block solve's split and back-solve and the segment sum;
the models that the segment sum carries
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
from matrix_factorization_tpu_torch.ops import _build, cuda_normal_eq, cuda_scores, cuda_sgd, cuda_spd
from matrix_factorization_tpu_torch.ops import cuda_spd_solve as css
from matrix_factorization_tpu_torch.ops import ials, spd
from matrix_factorization_tpu_torch.ops import segment_sum as ss
from matrix_factorization_tpu_torch.ops import segment_sgd as sgd

pytestmark = pytest.mark.cuda
STEP = ("mf_sgd_step", "mf_sgd_step_acc")  # the SGD step's entry points


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
    before = _build.launches("mf_score_catalog")
    got = cuda_scores.cuda_score_catalog(cfg, mu, pu, Q)
    assert _build.launches("mf_score_catalog") == before + 1
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
    before = _build.launches("mf_score_catalog")
    with pytest.raises(RuntimeError):
        cuda_scores.score_with_plan(cfg, mu, pu, Q, short)
    assert _build.launches("mf_score_catalog") == before


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
    before = _build.launches("mf_score_catalog")
    a = gpu.recommend_batch(list(range(40)), amount=7)
    assert _build.launches("mf_score_catalog") > before
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
    prim, sec, r, w, sp, srt = _batch(rng, 5000, n_prim, n_sec, cuda)
    pm = torch.from_numpy(sgd.update_mask(cfg, prim_side)).to(cuda)
    sm = torch.from_numpy(sgd.update_mask(cfg, sec_side)).to(cuda)
    mu = torch.tensor(3.5, device=cuda)
    Pk, Sk, Pp, Sp = P.clone(), S.clone(), P.clone(), S.clone()
    before = (_build.launches(*STEP), _build.launches("mf_segment_apply"))
    dq = cuda_sgd.cuda_sgd_step(cfg, mu, Pk, Sk, prim, sec, r, w, pm, sm,
                                0.05, cfg.reg)
    ss.cuda_segment_apply(Sk, dq, sp, srt)
    assert (_build.launches(*STEP), _build.launches("mf_segment_apply")) == (
        before[0] + 1, before[1] + 1)
    dq_plain = cuda_sgd.plain_sgd_step(cfg, mu, Pp, Sp, prim, sec, r, w, pm,
                                       sm, 0.05, cfg.reg)
    ss.plain_segment_apply(Sp, dq_plain, sp, srt)
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
    prim, sec, r, w, sp, srt = _batch(rng, 200_000, 50, 40, cuda)
    pm = torch.from_numpy(sgd.update_mask(cfg, "user")).to(cuda)
    sm = torch.from_numpy(sgd.update_mask(cfg, "item")).to(cuda)
    mu = torch.tensor(3.5, device=cuda)
    outs = []
    for _ in range(2):
        Pk, Sk = P.clone(), S.clone()
        dq = cuda_sgd.cuda_sgd_step(cfg, mu, Pk, Sk, prim, sec, r, w, pm, sm,
                                    1e-4, cfg.reg)
        ss.cuda_segment_apply(Sk, dq, sp, srt)
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
        before, P0 = _build.launches(*STEP), P.clone()
        with pytest.raises(RuntimeError):
            cuda_sgd.cuda_sgd_step(cfg, mu, P, S, *batch, pm, sm, 0.05, 0.0)
        torch.cuda.synchronize()
        assert _build.launches(*STEP) == before and torch.equal(P, P0)


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
        ss.cuda_segment_apply(P, rows[:, :64].contiguous(), ids, ids)
    with pytest.raises(ValueError):
        ss.cuda_segment_apply(P, rows, ids.long(), ids)


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
    before = _build.launches("mf_segment_apply")
    got, again, model, want = (table.clone() for _ in range(4))
    ss.cuda_segment_apply(got, rows, perm, srt)
    ss.cuda_segment_apply(again, rows, perm, srt)
    assert _build.launches("mf_segment_apply") == before + 2
    ss.segmented_segment_sum(model, rows, perm, srt,
                             chunk=ss.APPLY_CHUNK, layout="columns")
    ss.plain_segment_apply(want, rows, perm, srt)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert torch.equal(got, model)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


def test_segment_apply_refuses_a_plan_it_is_not_compiled_for(cuda,
                                                             monkeypatch):
    table = torch.zeros(8, 128, device=cuda)
    rows = torch.ones(100, 128, device=cuda)
    perm, srt = ss.sorted_order(torch.arange(100, device=cuda) % 8)
    plan = ss.apply_plan
    for change in ({"chunk": ss.APPLY_CHUNK * 2}, {"n_chunks": 1},
                   {"grid": 9}, {"finish_grid": 0}):
        monkeypatch.setattr(ss, "apply_plan",
                            lambda *a, **k: plan(*a, **k)._replace(**change))
        before = _build.launches("mf_segment_apply")
        with pytest.raises(RuntimeError):
            ss.cuda_segment_apply(table, rows, perm, srt)
        torch.cuda.synchronize()
        assert _build.launches("mf_segment_apply") == before
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
        before = _build.launches(*STEP)
        out[dev] = sgd.sgd_train(start, data, None, cfg, 3, cfg.lr,
                                 batch_orders=orders)
        if dev == "cuda":
            assert _build.launches(*STEP) == before + 3 * data.n_batches
    (pc, hc), (pg, hg) = out["cpu"], out["cuda"]
    torch.testing.assert_close(pg.user_features.cpu(), pc.user_features,
                               atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(pg.item_features.cpu(), pc.item_features,
                               atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(hg.cpu(), hc, atol=1e-5, rtol=1e-5)
    m = KernelMF(n_factors=20, kernel=kernel, n_epochs=2, lr=0.05, reg=0.02,
                 batch_size=512, device="cuda")
    X = pd.DataFrame({"user_id": u, "item_id": i}).drop_duplicates()
    before = _build.launches(*STEP)
    m.fit(X, pd.Series(r[X.index]))
    assert m._params.user_features.device.type == "cuda"
    assert len(m.train_rmse) == 2 and np.isfinite(m.train_rmse).all()
    assert _build.launches(*STEP) == before + 2 * -(-len(X) // 512)


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
    before = _build.launches("mf_gj_inverse")
    got = cuda_spd.cuda_gj_inverse(A)
    assert _build.launches("mf_gj_inverse") == before + 1
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
    cuda_spd.LIB("mf_gj_inverse", X.data_ptr(), X.data_ptr(), 9, d, plan.side,
                 plan.regs, plan.per_block, plan.smem_bytes,
                 torch.cuda.current_stream().cuda_stream)
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
    before = _build.launches("mf_gj_inverse")
    cuda_spd.gj_inverse(A[:, :100, :100].contiguous())
    inv = spd.spd_inverse(A)  # d = 201: two leaves, 104 and 97
    torch.cuda.synchronize()
    assert _build.launches("mf_gj_inverse") == before + 3
    torch.testing.assert_close(inv, torch.linalg.inv(A), atol=1e-3, rtol=1e-3)


def test_gj_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    A = torch.eye(6, device=cuda)[None].repeat(3, 1, 1)
    for bad in (torch.eye(129, device=cuda)[None], A.double(), A.cpu(),
                A.transpose(1, 2), A[0]):
        with pytest.raises(ValueError):
            cuda_spd.cuda_gj_inverse(bad)
    assert cuda_spd.cuda_gj_inverse(A[:0]).shape == (0, 6, 6)


# ---------------------------------------------------------------------------
# The Schur block solve (128 < d <= 232)
# ---------------------------------------------------------------------------


def _ridged_systems(E, d, device, seed, L=256, ridge=0.1):
    """E ridged grams (E, d, d) of L N(0, 0.3^2) rows, each scaled by a
    weight from 1 to 1,000 (as rating counts spread an ALS chunk's
    diagonals), and right-hand sides (E, d), made on the device."""
    g = torch.Generator(device=device).manual_seed(seed)
    X = torch.randn(E, L, d, generator=g, device=device) * 0.3
    w = torch.rand(E, 1, 1, generator=g, device=device) * 999.0 + 1.0
    A = torch.bmm(X.transpose(1, 2), X * w)
    A.diagonal(dim1=1, dim2=2).add_(ridge)
    return A, torch.randn(E, d, generator=g, device=device)


@pytest.mark.parametrize("E,d", [(15_625, 201), (7, 129), (13, 136), (5, 232)])
def test_spd_split_kernel_is_plain_bit_for_bit(cuda, E, d):
    """``mf_spd_split`` against ``plain_spd_split`` on the card: ds, As11,
    As12 and As22 the same bits (correctly rounded square root and
    reciprocal, two f32 products), one launch a call, the same bits twice,
    and a zero diagonal clamped as the plain version clamps it."""
    A, _ = _ridged_systems(E, d, cuda, seed=d)
    A[E // 2, 3, 3] = 0.0
    before = _build.launches("mf_spd_split")
    got = css.cuda_spd_split(A)
    assert _build.launches("mf_spd_split") == before + 1
    want = css.plain_spd_split(A)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.shape == w.shape and torch.equal(g, w)
    assert all(torch.equal(g, h) for g, h in zip(got, css.cuda_spd_split(A)))


@pytest.mark.parametrize("E,d", [(15_625, 201), (7, 136), (5, 232), (9, 129)])
def test_block_solve_kernel_matches_plain(cuda, E, d):
    """``mf_spd_block_solve`` against ``plain_block_solve`` at refine 1
    and 2: within 1e-6 of it (relative to the largest |x|; the kernel sums
    in its own fixed order) and as close to the float64 solution (within
    1e-6 of the largest |x| beyond it); at refine 0, where the two orders
    of the f32 sums part by the systems' conditioning, within 1e-4 of the
    float64 solution (the JAX bar is 1e-3). One launch a call, the same
    bits twice."""
    A, b = _ridged_systems(E, d, cuda, seed=100 + d)
    blocks = spd._schur_blocks(A)
    exact = torch.linalg.solve(A.double(), b.double())
    scale = float(exact.abs().max())
    for refine in (0, 1, 2):
        before = _build.launches("mf_spd_block_solve")
        got = css.cuda_block_solve(*blocks, A, b, refine)
        assert _build.launches("mf_spd_block_solve") == before + 1
        want = css.plain_block_solve(*blocks, A, b, refine)
        torch.cuda.synchronize()
        err_k = float((got.double() - exact).abs().max()) / scale
        err_p = float((want.double() - exact).abs().max()) / scale
        if refine:
            gap = float((got - want).abs().max()) / float(want.abs().max())
            assert gap < 1e-6, (refine, gap)
            assert err_k <= err_p + 1e-6, (refine, err_k, err_p)
        else:
            assert err_k < 1e-4, err_k
        assert torch.equal(css.cuda_block_solve(*blocks, A, b, refine), got)


@pytest.mark.parametrize("refine", [-1, 17])
def test_block_solve_kernel_takes_any_refine(cuda, refine):
    """The back-solve refines as often as the plain version does: none
    below 0 (the bits of refine 0), and 17 steps within 1e-6 of the plain
    version's (relative to its largest |x|)."""
    A, b = _ridged_systems(9, 201, cuda, seed=7)
    args = (*spd._schur_blocks(A), A, b)
    got = css.cuda_block_solve(*args, refine)
    if refine < 0:
        assert torch.equal(got, css.cuda_block_solve(*args, 0))
    want = css.plain_block_solve(*args, refine)
    assert float((got - want).abs().max()) / float(want.abs().max()) < 1e-6


@pytest.mark.parametrize("shift", [1, 2, 3])
def test_block_solve_kernel_takes_unaligned_blocks(cuda, shift):
    """Every input of the back-solve 1-3 floats past a 16-byte boundary:
    the same bits as the aligned call. (Within a tensor, entity e's invS
    starts e n^2 floats in, off a boundary at odd n, as at d = 201.)"""
    A, b = _ridged_systems(11, 201, cuda, seed=shift)
    args = (*spd._schur_blocks(A), A, b)
    want = css.cuda_block_solve(*args)
    moved = []
    for t in args:
        buf = torch.zeros(t.numel() + shift, device=cuda)
        view = buf[shift:].view(t.shape)
        view.copy_(t)
        moved.append(view)
    assert torch.equal(css.cuda_block_solve(*moved), want)


def test_solve_spd_on_cuda_takes_the_block_solve(cuda, monkeypatch):
    """``solve_spd`` on the card at d = 201: one split, two leaves and one
    back-solve a call, no plain version, no explicit inverse; within 1e-5
    of the float64 solution (relative to its largest entry)."""
    def refuse(*args, **kwargs):
        raise AssertionError("a plain version ran on CUDA tensors")

    for name in ("plain_spd_split", "plain_block_solve"):
        monkeypatch.setattr(css, name, refuse)
    monkeypatch.setattr(cuda_spd, "plain_gj_inverse", refuse)
    monkeypatch.setattr(spd, "_inverse", refuse)
    A, b = _ridged_systems(300, 201, cuda, seed=5)
    entries = ("mf_spd_split", "mf_gj_inverse", "mf_spd_block_solve")
    before = [_build.launches(e) for e in entries]
    x = spd.solve_spd(A, b)
    assert [_build.launches(e) - c for e, c in zip(entries, before)] == [1, 2, 1]
    exact = torch.linalg.solve(A.double(), b.double())
    assert float((x.double() - exact).abs().max() / exact.abs().max()) < 1e-5


def test_block_solve_wrappers_reject_what_the_kernels_do_not_take(cuda):
    A, b = _ridged_systems(3, 201, cuda, seed=0)
    args = [*spd._schur_blocks(A), A, b]
    for bad in (A[:, :128, :128].contiguous(), A.double(), A.cpu(), A.transpose(1, 2),
                torch.zeros(3, 233, 233, device=cuda)):
        with pytest.raises(ValueError):
            css.cuda_spd_split(bad)
    for i, t in enumerate(args):
        for bad in (t.double(), t[:2], t.cpu()):
            with pytest.raises(ValueError):
                css.cuda_block_solve(*args[:i], bad, *args[i + 1:])
    before = _build.launches("mf_spd_block_solve")
    empty = css.cuda_block_solve(*(t[:0] for t in args))
    assert empty.shape == (0, 201) and _build.launches("mf_spd_block_solve") == before
    assert [t.shape for t in css.cuda_spd_split(A[:0])] == [(0, 104, 104), (0, 104, 97),
                                                          (0, 97, 97), (0, 201)]


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
        before, ne_before = _build.launches("mf_gj_inverse"), _build.launches("mf_normal_eq")
        out[dev] = ials.ials_train_bucketed(start, bu, bi, data, cfg, 2,
                                            reg_scale="per_obs")
        if dev == "cuda":
            assert _build.launches("mf_gj_inverse") == before + 2 * (len(bu) + len(bi))
            assert _build.launches("mf_normal_eq") == ne_before + 2 * (len(bu) + len(bi))
    (pc, hc), (pg, hg) = out["cpu"], out["cuda"]
    torch.testing.assert_close(pg.user_features.cpu(), pc.user_features,
                               atol=2e-4, rtol=0)
    torch.testing.assert_close(pg.item_features.cpu(), pc.item_features,
                               atol=2e-4, rtol=0)
    torch.testing.assert_close(hg.cpu(), hc, atol=1e-4, rtol=0)
    X = pd.DataFrame({"user_id": u, "item_id": i})
    before = _build.launches("mf_gj_inverse")
    m = KernelMF(n_factors=20, n_epochs=2, method="als", reg=0.1,
                 device="cuda").fit(X, pd.Series(r))
    assert _build.launches("mf_gj_inverse") > before and np.isfinite(m.train_rmse).all()
    before = _build.launches("mf_gj_inverse")
    ImplicitALS(n_factors=16, n_epochs=2, device="cuda").fit(X, pd.Series(r))
    assert _build.launches("mf_gj_inverse") == before + 4


# ---------------------------------------------------------------------------
# The normal-equation kernel
# ---------------------------------------------------------------------------


def _ne_slots(k, side, E, L, variant, seed, device):
    """A table of N(0, 0.3^2) factors and E entities' (E, L) slots, counts
    from L / 2 to L filled from the left (the last entity none), the pads
    id 0; ``holes`` masks every odd slot (the ``half`` fault's shape)."""
    rng = np.random.default_rng(seed)
    cfg = SGDConfig(n_factors=k, reg=0.1)
    o_side = "item" if side == "user" else "user"
    T = _rows(cfg, 70_000, rng, o_side)
    counts = rng.integers(L // 2, L + 1, E)
    counts[-1] = 0
    mask = (np.arange(L)[None] < counts[:, None]).astype(np.float32)
    if variant == "holes":
        mask[:, 1::2] = 0.0
    ids = np.where(mask > 0, rng.integers(0, len(T), (E, L)), 0).astype(np.int32)
    r = np.where(mask > 0, np.round(rng.uniform(0.5, 5, (E, L)) * 2) / 2, 0)
    put = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(device)  # noqa: E731
    return cfg, put(T), put(ids), put(r.astype(np.float32)), put(mask)


# (k, E, L): a short bucket, the cell's user chunk cut to 400 entities,
# lists that cross the slice, the cell's longest bucket, factors not a
# multiple of 4, and a width whose microtiles take two blocks an entity
NE_SHAPES = [(8, 50, 8), (64, 300, 256), (200, 400, 256), (200, 5, 4096),
             (200, 2, 131_072), (13, 70, 40), (256, 40, 256), (256, 3, 2048)]


@pytest.mark.parametrize("variant", ["per_obs", "absolute", "bf16", "holes"])
@pytest.mark.parametrize("side", ["user", "item"])
@pytest.mark.parametrize("k,E,L", NE_SHAPES)
def test_normal_eq_kernel_matches_plain(cuda, k, E, L, side, variant):
    """The kernel against the plain body on the card, within 1e-5 of the
    largest |entry| (the CPU tests' bar between the kernel's order and the
    batched product); A exactly symmetric, an empty list the ridge alone,
    the same bits twice, one call counted."""
    cfg, T, ids, r, m = _ne_slots(k, side, E, L, variant, k + L, cuda)
    mu = torch.tensor(3.4, device=cuda)
    gram = "bf16" if variant == "bf16" else "f32"
    reg_scale = "absolute" if variant == "absolute" else "per_obs"
    o_side = "item" if side == "user" else "user"
    before = _build.launches("mf_normal_eq")
    A, b = ials.normal_equations(T, ids, r, m, mu, cfg, side, gram, reg_scale)
    assert _build.launches("mf_normal_eq") == before + 1
    wA, wb = ials.plain_normal_equations(
        T, ids, r, m, mu, k, sgd.bias_col(cfg, o_side), sgd.const_col(cfg, o_side),
        cfg.reg, gram, reg_scale)
    torch.cuda.synchronize()
    assert float((A - wA).abs().max()) <= 1e-5 * float(wA.abs().max())
    assert float((b - wb).abs().max()) <= 1e-5 * float(wb.abs().max())
    assert torch.equal(A, A.transpose(1, 2))
    assert torch.equal(A[-1], wA[-1]) and not b[-1].any()
    A2, b2 = ials.normal_equations(T, ids, r, m, mu, cfg, side, gram, reg_scale)
    assert torch.equal(A2, A) and torch.equal(b2, b)


def test_normal_eq_on_cuda_never_takes_the_plain_path(cuda, monkeypatch):
    """A bucketed ALS epoch on the card: one kernel call and one
    ``als.gram_kernel`` span a bucket chunk, and no gather or batched
    product under ``als.normal_eq``."""
    def refuse(*a, **k):
        raise AssertionError("the plain normal equations ran on a CUDA table")

    monkeypatch.setattr(ials, "plain_normal_equations", refuse)
    rng = np.random.default_rng(5)
    flat = rng.choice(400 * 300, 20_000, replace=False)
    u, i = (flat // 300).astype(np.int32), (flat % 300).astype(np.int32)
    r = rng.uniform(0.5, 5, 20_000).astype(np.float32)
    cfg = SGDConfig(n_factors=200, reg=0.1, batch_size=4096, compute_epoch_rmse=False)
    p0 = sgd.init_params(torch.Generator(device="cuda").manual_seed(0), 400, 300,
                         cfg, float(r.mean()))
    bu, bi = ials.group_both_sides_bucketed(u, i, r, 400, 300, max_block_rows=4096,
                                            device=cuda)
    before = _build.launches("mf_normal_eq")
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        ials.ials_train_bucketed(p0, bu, bi, None, cfg, 1, reg_scale="per_obs")
        torch.cuda.synchronize()
    assert _build.launches("mf_normal_eq") == before + len(bu) + len(bi)
    names = [e.name for e in prof.events()]
    assert names.count("mf:als.gram_kernel") == len(bu) + len(bi)
    inside = [e for e in prof.events() if e.name.startswith("aten::")
              and any(p.name == "mf:als.normal_eq" for p in _parents(e))]
    assert not [e.name for e in inside
                if e.name in ("aten::index", "aten::bmm", "aten::matmul", "aten::cat")]


def _parents(event):
    while event.cpu_parent is not None:
        event = event.cpu_parent
        yield event


def test_normal_eq_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    cfg, T, ids, r, m = _ne_slots(8, "user", 4, 16, "per_obs", 0, cuda)
    mu = torch.tensor(3.0, device=cuda)
    good = dict(other=T, other_ids=ids, ratings=r, mask=m, mu=mu, k=8, o_bias=9,
                o_const=8, ridge=0.1)
    for bad in ({"other": T[:, 1:]}, {"other": T.double()}, {"other": T.cpu()},
                {"other_ids": ids.long()}, {"ratings": r[:, :8]}, {"o_bias": 7},
                {"ridge": torch.ones(3, device=cuda)}):
        with pytest.raises(ValueError):
            cuda_normal_eq.cuda_normal_equations(**{**good, **bad})
    A, b = cuda_normal_eq.cuda_normal_equations(**{**good, "other_ids": ids[:0],
                                                   "ratings": r[:0], "mask": m[:0]})
    assert A.shape == (0, 9, 9) and b.shape == (0, 9)


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
    before = _build.launches("mf_segment_sum")
    got = base.clone()
    ss.cuda_segment_sum(got, vals, *order)
    assert _build.launches("mf_segment_sum") == before + 1
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
    before = _build.launches("mf_segment_sum")
    a = BaselineModel(device="cuda", **kw).fit(X, y)
    assert _build.launches("mf_segment_sum") > before
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
    before = _build.launches("mf_segment_sum")
    got = {d: mf.ContentBasedRecommender(device=d, min_rating=0.5).fit(
        X, y, item_features=feats) for d in ("cuda", "cpu")}
    assert _build.launches("mf_segment_sum") == before + 2  # the profile and its weight
    np.testing.assert_allclose(got["cuda"]._profiles.cpu().numpy(),
                               got["cpu"]._profiles.numpy(), atol=1e-5)
    cut = 6000
    args = (X.iloc[:cut], y.iloc[:cut], X.iloc[cut:], y.iloc[cut:])
    kw = dict(lrs=[0.005, 0.02], regs=[0.01, 0.1], n_epochs=3, n_factors=16,
              batch_size=512)
    before = _build.launches(*STEP)
    m, res = mf.grid_search_kernel_mf(*args, device="cuda", **kw)
    assert _build.launches(*STEP) == before + 4 * 3 * -(-cut // 512)
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
    before = _build.launches("mf_gj_inverse")
    a = mf.EASE(reg=50.0, device="cuda").fit(X, y)
    assert _build.launches("mf_gj_inverse") > before
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
    entries = ("mf_segment_apply", "mf_segment_sum")
    counts = [_build.launches(e) for e in entries]
    got = _family_epoch(family, data, tables, 2000, 1)
    again = _family_epoch(family, data, tables, 2000, 1)
    launched = [_build.launches(e) - c for e, c in zip(entries, counts)]
    assert launched[1 if family == "nmf" else 0] > 0
    monkeypatch.setattr(ss, "segment_apply", ss.plain_segment_apply)
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
    before = _build.launches("mf_score_catalog")
    rec = a.recommend_batch(X.user_id.unique()[:8].tolist(), amount=5)
    assert _build.launches("mf_score_catalog") > before and len(rec) == 40
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


def _rule_positions(s, k):
    """Each row's first k positions under the tie rule, by ``np.lexsort``:
    a NaN first (above ``+inf``), then score descending (``-0.0`` as
    ``0.0``), then position ascending."""
    nan = np.isnan(s)
    neg = np.where(nan, 0.0, -(s.astype(np.float64) + 0.0))
    pos = np.arange(s.shape[1])
    return np.stack([np.lexsort((pos, neg[r], ~nan[r]))[:k]
                     for r in range(len(s))])


TIE_CASES = ["small_ints", "signed_zeros", "nans", "steps_wide", "infs",
             "all_equal"]


@pytest.mark.parametrize("body", ["_sort_topk", "_plain_select_topk",
                                  "_plain_select_topk_sorting_ties",
                                  "_select_topk"])
@pytest.mark.parametrize("scores", TIE_CASES)
def test_stable_topk_bodies_on_cuda_are_the_tie_rule(cuda, scores, body,
                                                     monkeypatch):
    """The bodies of ``ops/scoring.py::stable_topk`` on the card against
    ``np.lexsort`` (score descending, then position ascending, a NaN
    first), exactly: the sort, the torch selection (with its tie branch's
    wider top-k, and its whole-row sort) and ``_select_topk``, which on
    the card is the hand-written kernel of ``ops/cuda_topk.py``. Ties
    inside the k and at the cut, ``-0.0`` beside ``0.0``, NaNs, ``+inf``
    and ``-inf`` beside NaNs, rows whose every score is equal, and rows
    wider than a sort's small-segment path."""
    from matrix_factorization_tpu_torch.ops import scoring

    rng = np.random.default_rng(TIE_CASES.index(scores))
    B, n = (6, 300_001) if scores == "steps_wide" else (9, 4_099)
    s = rng.integers(-3, 4, (B, n)).astype(np.float32)
    if scores == "steps_wide":
        s = (np.round(rng.standard_normal((B, n)) * 64) / 64).astype(np.float32)
    if scores == "signed_zeros":
        s[(s == 0) & (rng.random((B, n)) < 0.5)] = -0.0
    if scores == "nans":
        s[rng.random((B, n)) < 0.01] = np.nan
    if scores == "infs":
        r = rng.random((B, n))
        s[r < 0.004] = np.inf
        s[(r >= 0.004) & (r < 0.3)] = -np.inf
        s[r > 0.997] = np.nan
        s[1] = -np.inf  # a row of -inf alone
    if scores == "all_equal":
        s[:] = 0.25
        s[2] = -0.0
        s[3] = np.nan
    if body == "_plain_select_topk_sorting_ties":
        monkeypatch.setattr(scoring, "SELECT_MAX_TIED", 0)
        body = "_plain_select_topk"
    before = _build.launches("mf_topk_select")
    for k in (1, 10, 50):
        v, i = getattr(scoring, body)(torch.from_numpy(s).cuda(), k)
        want = _rule_positions(s, k)
        np.testing.assert_array_equal(i.cpu().numpy(), want)
        np.testing.assert_array_equal(v.cpu().numpy(),
                                      np.take_along_axis(s, want, 1))
    launched = _build.launches("mf_topk_select") - before
    assert launched == (3 if body == "_select_topk" else 0)


# (rows, n, k, scores): the selection body's blocks on the main paths
# (dense_topk's 60-row blocks and 16-row tail over RecipeNLG's 2,231,142
# items, at k 100 and the service's candidate_k cap 500), one row block
# past an int32 of scores' worth of chunking, k = n, k = 1, and the
# kernel's largest k and one past it (which takes the torch body)
SELECT_SHAPES = [
    (60, 2_231_142, 100, "normal"), (60, 2_231_142, 100, "steps"),
    (60, 2_231_142, 500, "normal"), (16, 2_231_142, 100, "normal"),
    (16, 2_231_142, 500, "steps"), (2, 2_500_000, 100, "normal"),
    (8_192, 1_024, 1_024, "normal"), (60, 2_231_142, 1, "steps"),
    (16, 2_231_142, 1_024, "normal"), (16, 2_231_142, 1_025, "normal"),
]


@pytest.mark.parametrize("rows,n,k,scores", SELECT_SHAPES)
def test_select_kernel_is_the_plain_body_bit_for_bit(cuda, rows, n, k, scores):
    """``_select_topk`` on the card (the kernel for k up to
    ``cuda_topk.MAX_K``, the torch body itself past it) against the torch selection
    body on the same scores: values and positions bitwise equal, a second
    run bitwise equal to the first, one launch of the pair a call, and no
    host sync inside the call (``set_sync_debug_mode("error")``). "steps"
    rounds the scores to 1/64, so that ties straddle the cuts."""
    from matrix_factorization_tpu_torch.ops import cuda_topk, scoring

    g = torch.Generator(device="cuda").manual_seed(rows * 7 + k)
    s = torch.randn((rows, n), generator=g, device="cuda")
    if scores == "steps":
        s = torch.round(s * 64) / 64
    want = scoring._plain_select_topk(s, k)
    fits = k <= cuda_topk.MAX_K
    before = _build.launches("mf_topk_select")
    torch.cuda.synchronize()
    # the kernel's call never syncs; the torch body past MAX_K does (its
    # tie test)
    torch.cuda.set_sync_debug_mode("error" if fits else "default")
    try:
        got = scoring._select_topk(s, k)
        again = scoring._select_topk(s, k)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert _build.launches("mf_topk_select") == before + (2 if fits else 0)
    for a, b in ((got, want), (again, got)):
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
        assert a[0].dtype == torch.float32 and a[1].dtype == torch.int64


def test_select_kernel_wrapper_refuses_what_it_does_not_take(cuda):
    """``cuda_select_topk`` launches the kernel or raises: a non-f32, a
    non-contiguous, a CPU or a 1-D tensor, and a k past ``MAX_K`` or the
    row, are refused before any launch."""
    from matrix_factorization_tpu_torch.ops import cuda_topk, scoring

    s = torch.randn((8, 5_000), device="cuda")
    before = _build.launches("mf_topk_select")
    for bad, k in ((s.double(), 5), (s.half(), 5), (s[:, ::2], 5),
                   (s.t(), 5), (s.cpu(), 5), (s[0], 5),
                   (s, cuda_topk.MAX_K + 1), (s[:, :10].contiguous(), 11)):
        with pytest.raises(ValueError):
            cuda_topk.cuda_select_topk(bad, k)
    assert _build.launches("mf_topk_select") == before
    v, i = cuda_topk.cuda_select_topk(s, 0)
    assert v.shape == i.shape == (8, 0) and _build.launches("mf_topk_select") == before
    v, i = cuda_topk.cuda_select_topk(s, 5)
    assert _build.launches("mf_topk_select") == before + 1
    want = scoring._plain_select_topk(s, 5)
    assert torch.equal(v, want[0]) and torch.equal(i, want[1])


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
    before = _build.launches("mf_score_catalog")
    res = json.loads(run(evaluate, ["--k", "10", "--positive-threshold", "3.0",
                                    "--max-users", "50"]).strip().splitlines()[-1])
    assert res["n_users"] > 0
    assert _build.launches("mf_score_catalog") - before >= res["n_users"]


@pytest.mark.parametrize("case", ["run_ends_at_boundary",
                                  "run_over_three_segments",
                                  "one_run_of_40_segments", "ragged",
                                  "skewed"])
@pytest.mark.parametrize("kernel", ["linear", "sigmoid", "rbf"])
def test_sgd_step_accumulator_mode(cuda, kernel, case):
    """``prim_out``: the kernel leaves the primary table as it was, adds
    the same deltas as the plain accumulator (atol = rtol = 1e-5) and, into
    a copy of the pre-step table, gives the in-place step's bits; ``dq``
    is the in-place step's."""
    cfg = SGDConfig(kernel=kernel, n_factors=200, gamma=1 / 200,
                    min_rating=0.5, max_rating=5.0, reg=0.01)
    rng = np.random.default_rng(len(case))
    prim, pad = _boundary_ids(case, rng)
    P, S, batch, pm, sm, mu = _step_inputs(cfg, prim, 600, 700, rng, cuda, pad)
    lr = 1e-3
    tail = (S, *batch, pm, sm, lr, cfg.reg)
    Pk = P.clone()
    dq = cuda_sgd.cuda_sgd_step(cfg, mu, Pk, *tail)
    frozen, acc, acc_plain = P.clone(), torch.zeros_like(P), torch.zeros_like(P)
    dq_acc = cuda_sgd.cuda_sgd_step(cfg, mu, frozen, *tail, prim_out=acc)
    cuda_sgd.plain_sgd_step(cfg, mu, P.clone(), *tail, prim_out=acc_plain)
    onto = P.clone()
    cuda_sgd.cuda_sgd_step(cfg, mu, P.clone(), *tail, prim_out=onto)
    torch.cuda.synchronize()
    assert torch.equal(frozen, P) and torch.equal(dq_acc, dq)
    torch.testing.assert_close(acc, acc_plain, atol=1e-5, rtol=1e-5)
    assert torch.equal(onto, Pk)
    with pytest.raises(ValueError, match="another tensor"):
        cuda_sgd.cuda_sgd_step(cfg, mu, frozen, *tail, prim_out=frozen)


def test_gloo_world_on_one_gpu(cuda):
    """Two gloo ranks share the card (NCCL refuses two ranks on one GPU):
    the dry run's data-parallel, 2D and sharded top-k paths on CUDA
    tensors."""
    from matrix_factorization_tpu_torch.parallel.dryrun import dryrun_multichip

    res = dryrun_multichip(2, "gloo", "cuda:0")
    assert res["device"] == "cuda:0"
    assert np.isfinite(res["flat"]).all() and np.isfinite(res["2d"]).all()


def test_dp_als_sweep_at_world_one_is_bucket_sweep(cuda):
    """At world size 1 the data-parallel ALS sweep solves each bucket's
    chunk as ``ials_train_bucketed`` does, through the normal-equation
    kernel and the GJ kernel, and ends with its bits; it launches both as
    often."""
    import tempfile

    import torch.distributed as dist

    from matrix_factorization_tpu_torch.parallel.mesh import make_mesh

    rng = np.random.default_rng(4)
    n_users, n_items, n = 400, 300, 20_000
    flat = rng.choice(n_users * n_items, n, replace=False)
    u = (flat // n_items).astype(np.int32)
    i = (flat % n_items).astype(np.int32)
    r = rng.uniform(0.5, 5, n).astype(np.float32)
    cfg = SGDConfig(kernel="linear", n_factors=150, reg=0.1, min_rating=0.5,
                    max_rating=5.0, batch_size=4096)
    p0 = sgd.init_params(torch.Generator(device="cuda").manual_seed(0),
                         n_users, n_items, cfg, float(r.mean()))
    bu, bi = ials.group_both_sides_bucketed(u, i, r, n_users, n_items,
                                            max_block_rows=4096, device=cuda)
    data = sgd.pack_ratings(u, i, r, 4096, aggregate=False, device=cuda)
    _build.reset_launches("mf_gj_inverse")
    _build.reset_launches("mf_normal_eq")
    ref, href = ials.ials_train_bucketed(p0, bu, bi, data, cfg, 2,
                                         reg_scale="per_obs")
    torch.cuda.synchronize()
    single, single_ne = _build.launches("mf_gj_inverse"), _build.launches("mf_normal_eq")
    with tempfile.TemporaryDirectory() as d:
        dist.init_process_group("gloo", init_method=f"file://{d}/store",
                                rank=0, world_size=1)
        try:
            _build.reset_launches("mf_gj_inverse")
            _build.reset_launches("mf_normal_eq")
            got, hist = ials.dp_ials_train_bucketed(p0, bu, bi, data, cfg, 2,
                                                    make_mesh(1),
                                                    reg_scale="per_obs")
            torch.cuda.synchronize()
        finally:
            dist.destroy_process_group()
    assert single > 0 and _build.launches("mf_gj_inverse") == single
    assert single_ne == 2 * (len(bu) + len(bi)) == _build.launches("mf_normal_eq")
    assert torch.equal(got.user_features, ref.user_features)
    assert torch.equal(got.item_features, ref.item_features)
    assert torch.equal(hist, href)


def test_dp_families_at_nccl_world_one_are_the_single_device_trainers(cuda):
    """At NCCL world size 1 ``dp_bpr_train_tiled`` and
    ``dp_svdpp_train_batched`` walk the single-device trainers' batches
    with the same draws through ``mf_segment_apply``, as often; their Q
    deltas go through a delta table, so they hold JAX's bars (BPR tables
    2e-5 and loss rtol 1e-5, SVD++ 1e-5), not bits."""
    import tempfile

    import torch.distributed as dist

    from matrix_factorization_tpu_torch.ops import bpr, svdpp
    from matrix_factorization_tpu_torch.parallel import distributed as pdist
    from matrix_factorization_tpu_torch.parallel.mesh import make_mesh

    rng = np.random.default_rng(6)
    n_users, n_items, n, bs, E = 400, 300, 20_000, 4096, 3
    flat = rng.choice(n_users * n_items, n, replace=False)
    u = (flat // n_items).astype(np.int32)
    i = (flat % n_items).astype(np.int32)
    r = rng.uniform(0.5, 5, n).astype(np.float32)
    bcfg = SGDConfig(kernel="linear", n_factors=64, reg=0.002, min_rating=0.0,
                     max_rating=1.0)
    scfg = SGDConfig(kernel="linear", n_factors=64, lr=0.005, reg=0.02,
                     min_rating=0.5, max_rating=5.0)
    pack = sgd.pack_ratings(u, i, r, bs, order="user", device=cuda)
    gen = torch.Generator(device="cuda").manual_seed(0)
    orders = [torch.randperm(pack.n_batches, generator=gen, device="cuda")
              for _ in range(E)]
    negs = [torch.randint(0, n_items, (pack.n_batches, bs), generator=gen,
                          device="cuda", dtype=torch.int32) for _ in range(E)]
    b0 = sgd.init_params(gen, n_users, n_items, bcfg, 0.0)
    s0 = svdpp.init_params(gen, n_users, n_items, scfg, float(r.mean()))
    Y = torch.zeros_like(s0.implicit_features)
    Y[:, :64] = 0.05 * torch.randn((Y.shape[0], 64), generator=gen, device="cuda")
    s0 = s0._replace(implicit_features=Y)
    wvec = torch.from_numpy(svdpp._neighbor_weights(
        u, n_users, s0.user_features.shape[0])).to(cuda)
    deg = torch.from_numpy(np.bincount(i, minlength=Y.shape[0]).astype(
        np.float32)).to(cuda)
    runs, launches = {}, {}
    for tag, fn in (
            ("bpr", lambda: bpr.bpr_train_tiled(b0, pack, None, bcfg, E, 0.05,
                                                n_items, batch_orders=orders,
                                                negatives=negs)),
            ("svdpp", lambda: svdpp.svdpp_train_batched(
                s0, pack, wvec, deg, None, scfg, E, 0.005, 0.02,
                batch_orders=orders))):
        _build.reset_launches("mf_sgd_step", "mf_sgd_step_acc", "mf_segment_apply")
        runs[tag] = fn()
        torch.cuda.synchronize()
        launches[tag] = _build.launches("mf_segment_apply")
    given = [[o] for o in orders], [[x] for x in negs]
    with tempfile.TemporaryDirectory() as d:
        dist.init_process_group("nccl", init_method=f"file://{d}/store",
                                rank=0, world_size=1,
                                device_id=torch.device("cuda:0"))
        try:
            mesh = make_mesh(1)
            _build.reset_launches("mf_sgd_step", "mf_sgd_step_acc", "mf_segment_apply")
            got_b = bpr.dp_bpr_train_tiled(pdist.place_params(b0, mesh), pack,
                                           bcfg, E, 0.05, n_items, mesh,
                                           batch_orders=given[0],
                                           negatives=given[1])
            torch.cuda.synchronize()
            dp_b = _build.launches("mf_segment_apply")
            _build.reset_launches("mf_sgd_step", "mf_sgd_step_acc", "mf_segment_apply")
            got_s = svdpp.dp_svdpp_train_batched(s0, pack, wvec, deg, scfg, E,
                                                 0.005, 0.02, mesh,
                                                 batch_orders=given[0])
            torch.cuda.synchronize()
            dp_s = _build.launches("mf_segment_apply")
        finally:
            dist.destroy_process_group()
    assert launches["bpr"] > 0 and dp_b == launches["bpr"]
    assert launches["svdpp"] > 0 and dp_s == launches["svdpp"]
    want_p, want_h = runs["bpr"]
    for a, b in ((got_b[0].user_features, want_p.user_features),
                 (got_b[0].item_features, want_p.item_features)):
        torch.testing.assert_close(a, b, atol=2e-5, rtol=0)
    torch.testing.assert_close(got_b[1], want_h, rtol=1e-5, atol=0)
    want_p, want_h = runs["svdpp"]
    for a, b in zip(list(got_s[0]) + [got_s[1]], list(want_p) + [want_h]):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=0)


def _gloo_ease_rank(rank, world, X, y):
    """``EASE(mesh=)`` on one gloo rank of the card: its GJ launches, its
    rows of ``B`` and the first 16 users' catalog scores."""
    from matrix_factorization_tpu_torch import EASE
    from matrix_factorization_tpu_torch.parallel.mesh import make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    _build.reset_launches("mf_gj_inverse")
    m = EASE(reg=10.0, mesh=make_mesh(world)).fit(X, y)
    torch.cuda.synchronize()
    return {"launches": _build.launches("mf_gj_inverse"),
            "rows": tuple(m._params.item_weights.shape),
            "device": str(m._params.item_weights.device),
            "scores": m._catalog_scores_batch(np.arange(16))}


def test_ease_mesh_on_gloo_ranks_sharing_the_gpu(cuda):
    """A gloo world of 2 on cuda:0 fits ``EASE(mesh=)``: the data-parallel
    gram, then on each rank the Schur recursion whose leaves are the
    hand-written GJ kernel (launched on every rank), each rank keeping
    its rows of ``B``; the summed partial scores within 5e-4 of the
    single-device fit on the card."""
    from matrix_factorization_tpu_torch import EASE
    from matrix_factorization_tpu_torch.parallel.launch import spawn_world

    rng = np.random.default_rng(9)
    flat = rng.choice(300 * 200, 4000, replace=False)
    X = pd.DataFrame({"user_id": flat // 200, "item_id": flat % 200})
    y = pd.Series(np.ones(len(flat), np.float32))
    ranks = spawn_world(_gloo_ease_rank, 2, "gloo", "cuda:0", args=(X, y),
                        timeout=600)
    want = EASE(reg=10.0).fit(X, y)._catalog_scores_batch(np.arange(16))
    # 200 items padded to 208 for 2 ranks: 104 rows, then the 96 left
    assert [rk["rows"] for rk in ranks] == [(104, 200), (96, 200)]
    for rk in ranks:
        assert rk["launches"] > 0 and rk["device"] == "cuda:0"
        np.testing.assert_allclose(rk["scores"], want, atol=5e-4)


def _gloo_retrieval_rank(rank, world, emb, q, tix, queries):
    """The row-sharded dense and TF-IDF top-k on one gloo rank of the card."""
    from matrix_factorization_tpu_torch.parallel.mesh import make_mesh
    from matrix_factorization_tpu_torch.retrieval import index as rindex
    from matrix_factorization_tpu_torch.retrieval import search, sparse_scoring

    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_mesh(world)
    dix = rindex.build_dense_index(list(range(len(emb))), [""] * len(emb), emb,
                                   normalize=False)
    dense = search.dense_topk_mesh(dix, q, 10, mesh)
    rows = search._mesh_cache[dix][(mesh, torch.device("cuda"))]
    return {"dense": dense, "rows_device": str(rows.device),
            "rows": rows.shape[0],
            "tfidf": sparse_scoring.tfidf_csr_topk(
                tix, tix.vectorizer.transform(queries), 10, mesh, vocab_block=64)}


def test_retrieval_mesh_on_gloo_ranks_sharing_the_gpu(cuda):
    """A gloo world of 2 on cuda:0: ``dense_topk_mesh`` (each rank its
    rows on the card) and ``tfidf_csr_topk`` against the mesh-free calls on
    the card at JAX's bars (values 1e-5, positions where the gap to the
    next value is at least 1e-6); 1,003 items, so rank 1 holds 499 real
    rows of its 504."""
    import scipy.sparse as sp

    from matrix_factorization_tpu_torch.parallel.launch import spawn_world
    from matrix_factorization_tpu_torch.retrieval import index as rindex
    from matrix_factorization_tpu_torch.retrieval import search, sparse_scoring

    from chip_smoke import HashVectorizer

    rng = np.random.default_rng(5)
    emb = rng.normal(size=(1003, 64)).astype(np.float32)
    q = rng.normal(size=(6, 64)).astype(np.float32)
    vocab = 300
    M = sp.random(1003, vocab, density=0.05, random_state=3, format="csr",
                  dtype=np.float32)
    tix = rindex.TfidfItemIndex(item_ids=list(range(1003)), texts=[""] * 1003,
                                vectorizer=HashVectorizer(vocab), matrix=M)
    queries = [" ".join(f"w{w}" for w in rng.choice(vocab, 5, replace=False))
               for _ in range(4)]
    ranks = spawn_world(_gloo_retrieval_rank, 2, "gloo", "cuda:0",
                        args=(emb, q, tix, queries), timeout=600)
    dix = rindex.build_dense_index(list(range(1003)), [""] * 1003, emb,
                                   normalize=False)
    wants = {"dense": search.search_topk_batch(dix, q, 10),
             "tfidf": sparse_scoring.tfidf_batch_topk(tix, queries, 10,
                                                      vocab_block=64)}
    assert [rk["rows"] for rk in ranks] == [504, 499]
    for rk in ranks:
        assert rk["rows_device"] == "cuda:0"
        for name, (wv, wp) in wants.items():
            vals, pos = rk[name]
            np.testing.assert_allclose(vals, wv, atol=1e-5)
            gap = wv[:, :-1] - wv[:, 1:]
            tied = np.concatenate([gap < 1e-6, np.ones((len(wv), 1), bool)], 1)
            assert (pos == wp)[~tied].all() and pos.max() < 1003


def _gloo_checkpoint_rank(rank, world, X, y, path):
    """A ``keep_sharded`` KernelMF on one gloo rank of the card, written by
    ``save_model_sharded``, read back onto the mesh and served: the
    scorer's launches in that ``recommend``."""
    from matrix_factorization_tpu_torch import (
        KernelMF,
        load_model_sharded,
        save_model_sharded,
    )
    from matrix_factorization_tpu_torch.parallel.mesh import make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_mesh(world)
    m = KernelMF(n_factors=16, n_epochs=3, lr=0.05, batch_size=256, mesh=mesh,
                 keep_sharded=True).fit(X, y)
    save_model_sharded(m, path)
    m2 = load_model_sharded(path, mesh=mesh)
    uid = X["user_id"].iloc[0]
    before = _build.launches("mf_score_catalog")
    recs = m2.recommend(user=uid, amount=5)
    torch.cuda.synchronize()
    return {"launches": _build.launches("mf_score_catalog") - before,
            "equal": [torch.equal(a, b) for a, b in zip(m._params, m2._params)],
            "device": str(m2._params.user_features.device),
            "rows": m2._params.user_features.shape[0],
            "recs": (recs, m.recommend(user=uid, amount=5))}


def test_sharded_checkpoint_on_gloo_ranks_sharing_the_gpu(cuda, tmp_path):
    """``save_model_sharded`` / ``load_model_sharded(mesh=)`` on a gloo world
    of 2 on cuda:0: each rank's shards restored equal onto the card, and
    the restored model's ``recommend`` launches the scorer on both ranks
    and equals the fitted model's."""
    from matrix_factorization_tpu_torch.data.synthetic import lowrank_ratings
    from matrix_factorization_tpu_torch.parallel.launch import spawn_world

    X, y = lowrank_ratings(n_users=300, n_items=200, density=0.2, seed=4)
    ranks = spawn_world(_gloo_checkpoint_rank, 2, "gloo", "cuda:0",
                        args=(X, y, str(tmp_path / "ck")), timeout=600)
    for rk in ranks:
        assert rk["launches"] > 0 and all(rk["equal"])
        assert rk["device"].startswith("cuda") and rk["rows"] < 300
        pd.testing.assert_frame_equal(*rk["recs"])


def _gram_case(n_users, n_items, n_pairs, seed, weights="binary"):
    rng = np.random.default_rng(seed)
    key = np.unique(rng.integers(0, n_users * n_items, n_pairs))
    u, i = (key // n_items).astype(np.int64), (key % n_items).astype(np.int64)
    w = {"binary": np.ones(len(u), np.float32),
         "small": rng.integers(-7, 8, len(u)).astype(np.float32),
         "real": rng.uniform(0.5, 5.0, len(u)).astype(np.float32)}[weights]
    return u, i, w


@pytest.mark.parametrize("n_users,n_items,n_pairs,weights", [
    (300, 40, 3_000, "binary"), (5_000, 1_500, 200_000, "binary"),
    (40_000, 3_000, 600_000, "small"), (20_001, 4_100, 400_000, "binary")])
def test_int8_gram_is_the_f32_gram_bit_for_bit(cuda, n_users, n_items, n_pairs,
                                               weights):
    """The int8 tensor-core gram (ragged items and users, several chunks,
    negative weights) against the exact-f32 scan of the same pairs."""
    from matrix_factorization_tpu_torch.ops import cuda_gram
    from matrix_factorization_tpu_torch.ops import ease as ease_ops

    u, i, w = _gram_case(n_users, n_items, n_pairs, n_users, weights)
    pack = ease_ops.gram_pack(u, i, w, n_users, n_items, device="cuda")
    assert pack.tiles is not None
    _build.reset_launches("mf_ease_gram_tiles")
    G8 = ease_ops.gram_scan(pack)
    torch.cuda.synchronize()
    assert _build.launches("mf_ease_gram_tiles") == len(pack.bounds) - 1
    ip = ease_ops.round8(n_items)
    cu = min(2048, ease_ops.round8(n_users))
    lu, ii, ww, bounds = ease_ops._gram_chunks(u, i, w, n_users, cu)
    f32 = ease_ops.GramPack(*(torch.from_numpy(a).cuda() for a in (lu, ii, ww)),
                            tuple(int(b) for b in bounds), ip, cu, None)
    Gf = ease_ops.gram_scan(f32)
    assert G8.dtype == torch.float32 and G8.shape == (ip, ip)
    assert torch.equal(G8, Gf)
    # the plain versions of the kernels' steps give the same gram
    plain = cuda_gram.int8_gram(pack.lu.cpu(), pack.ii.cpu(), pack.ww.cpu(), pack.bounds,
                                ip, pack.cu, pack.tiles.cpu()) if n_items <= 1_500 else None
    if plain is not None:
        assert torch.equal(plain, Gf.cpu())


def test_int8_gram_leaves_other_weights_to_the_f32_path(cuda):
    from matrix_factorization_tpu_torch.ops import ease as ease_ops

    u, i, w = _gram_case(3_000, 500, 50_000, 5, "real")
    assert ease_ops.gram_pack(u, i, w, 3_000, 500, device="cuda").tiles is None
    u2 = np.concatenate([u, u[:1]])  # a repeated pair
    i2 = np.concatenate([i, i[:1]])
    w2 = np.ones(len(u2), np.float32)
    assert ease_ops.gram_pack(u2, i2, w2, 3_000, 500, device="cuda").tiles is None
    w3 = np.full(len(u), 128.0, np.float32)
    assert ease_ops.gram_pack(u, i, w3, 3_000, 500, device="cuda").tiles is None


def _cat_inverse(A, base=32):
    """``ops/spd.py``'s recursion as it was with the blocks joined by
    ``torch.cat`` (the in-place writes must give the same bits)."""
    d = A.shape[-1]
    if d <= cuda_spd.MAX_D:
        flat = A.reshape((-1,) + tuple(A.shape[-2:])).contiguous()
        return cuda_spd.gj_inverse(flat).reshape(A.shape)
    m = ((d // 2 + 7) // 8) * 8
    A11, A12, A22 = A[..., :m, :m], A[..., :m, m:], A[..., m:, m:]
    inv11 = _cat_inverse(A11, base)
    W = spd._mm(inv11, A12)
    S = A22 - spd._mm(spd._t(A12), W)
    invS = _cat_inverse(S, base)
    B12 = -spd._mm(W, invS)
    B11 = inv11 - spd._mm(B12, spd._t(W))
    return torch.cat([torch.cat([B11, B12], -1), torch.cat([spd._t(B12), invS], -1)], -2)


@pytest.mark.parametrize("shape", [(2_000, 201, 201), (3, 1_000, 1_000), (4_100, 4_100)])
def test_inplace_schur_recursion_is_the_cat_recursion_bit_for_bit(cuda, shape):
    """ALS's batched d = 201 and EASE-like single systems: the inverse of
    the Jacobi-scaled system (what the main paths invert) and the scaled
    inverse with its refinement, on the card."""
    g = torch.Generator(device="cuda").manual_seed(shape[-1])
    d = shape[-1]
    X = torch.randn(shape[:-2] + (2 * d, d), device="cuda", generator=g)
    A = spd._mm(spd._t(X), X) + torch.eye(d, device="cuda")
    ds = spd._jacobi(A)
    As = A * ds[..., :, None] * ds[..., None, :]
    want = _cat_inverse(As)
    assert torch.isfinite(want).all()
    assert torch.equal(spd.spd_inverse(As), want)
    P = want * ds[..., :, None] * ds[..., None, :]
    P = 2.0 * P - spd._mm(P, spd._mm(A, P))
    assert torch.equal(spd.spd_inverse_scaled(A.clone()), P)
