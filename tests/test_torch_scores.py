"""The PyTorch port's catalog scoring against the JAX package's.

The port's scorer on CPU tensors is the plain PyTorch version of the CUDA
kernel (``ops/cuda_scores.py``); it is held against the JAX package's XLA
scorer and its Pallas kernel (interpret mode, as the JAX tests run it).
Tolerances: f32 at atol = rtol = 1e-4 (the three sum in different
orders), bf16 tables at atol 1e-3 (both sides upcast the same bf16 values
and sum in f32)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from matrix_factorization_tpu.core.config import SGDConfig as JaxConfig
from matrix_factorization_tpu.ops import kernels as jax_kernels
from matrix_factorization_tpu.ops import scoring as jax_scoring
from matrix_factorization_tpu.ops.pallas_scores import (
    pallas_score_catalog,
    recommend_topk as jax_recommend_topk,
)
from matrix_factorization_tpu_torch.core.config import SGDConfig
from matrix_factorization_tpu_torch.ops import _build, cuda_scores, scoring
from matrix_factorization_tpu_torch.ops import kernels as torch_kernels
from matrix_factorization_tpu_torch.ops import segment_sgd as sgd

CFG_KW = dict(n_factors=12, gamma=0.05, min_rating=1.0, max_rating=5.0)


def _rows(cfg, n, rng, side):
    m = np.zeros((n, cfg.padded_factors), np.float32)
    m[:, : cfg.n_factors] = rng.normal(0, 0.4, (n, cfg.n_factors))
    if cfg.kernel != "rbf":
        m[:, sgd.bias_col(cfg, side)] = rng.normal(0, 0.2, n)
        m[:, sgd.const_col(cfg, side)] = 1.0
    return m


def _cfgs(kernel, **kw):
    kw = {**CFG_KW, **kw}
    return SGDConfig(kernel=kernel, **kw), JaxConfig(kernel=kernel, **kw)


class _Params:
    """A stand-in with the three ``MFParams`` fields, for either package."""

    def __init__(self, P, Q, mu):
        self.user_features, self.item_features, self.global_mean = P, Q, mu


@pytest.mark.parametrize("kernel", ["linear", "sigmoid", "rbf"])
@pytest.mark.parametrize("shape", [(5, 37), (16, 512), (3, 1000)])
def test_plain_scorer_matches_jax(kernel, shape):
    rng = np.random.default_rng(1)
    cfg, jcfg = _cfgs(kernel)
    B, I = shape
    pu, Q = _rows(cfg, B, rng, "user"), _rows(cfg, I, rng, "item")
    got = scoring.score_catalog(cfg, torch.tensor(3.4), torch.from_numpy(pu),
                                torch.from_numpy(Q))
    assert got.dtype == torch.float32 and got.shape == (B, I)
    want = np.asarray(jax_scoring.score_catalog(
        jcfg, jnp.float32(3.4), jnp.asarray(pu), jnp.asarray(Q)))
    pallas = np.asarray(pallas_score_catalog(
        jcfg, jnp.float32(3.4), jnp.asarray(pu), jnp.asarray(Q),
        item_tile=256, interpret=True))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(got.numpy(), pallas, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("kernel", ["linear", "sigmoid", "rbf"])
def test_bf16_tables_match_jax(kernel):
    rng = np.random.default_rng(2)
    cfg, jcfg = _cfgs(kernel)
    pu, Q = _rows(cfg, 6, rng, "user"), _rows(cfg, 300, rng, "item")
    got = scoring.score_catalog(
        cfg, torch.tensor(3.4), torch.from_numpy(pu).to(torch.bfloat16),
        torch.from_numpy(Q).to(torch.bfloat16))
    want = np.asarray(jax_scoring.score_catalog(
        jcfg, jnp.float32(3.4), jnp.asarray(pu, jnp.bfloat16),
        jnp.asarray(Q, jnp.bfloat16)))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-3)


@pytest.mark.parametrize("kernel", ["linear", "sigmoid", "rbf"])
def test_catalog_topk_matches_jax(kernel):
    rng = np.random.default_rng(3)
    cfg, jcfg = _cfgs(kernel)
    P = _rows(cfg, 24, rng, "user")
    # capacity-padded item table: 300 items in 304 rows, zero padding
    Q = np.zeros((304, cfg.padded_factors), np.float32)
    Q[:300] = _rows(cfg, 300, rng, "item")
    u = np.array([0, 5, 7, 23], np.int32)
    got_v, got_i = scoring.catalog_topk(
        cfg, _Params(torch.from_numpy(P), torch.from_numpy(Q),
                     torch.tensor(3.1)), 300, u, 7)
    want_v, want_i = jax_scoring.catalog_topk(
        jcfg, _Params(jnp.asarray(P), jnp.asarray(Q), jnp.float32(3.1)),
        300, u, 7)
    assert got_i.shape == (4, 7) and got_i.max() < 300
    np.testing.assert_array_equal(got_i, want_i)
    np.testing.assert_allclose(got_v, want_v, atol=1e-5)
    # the (B, n_items) bulk scorer agrees with the top-k
    bulk = scoring.catalog_scores(
        cfg, _Params(torch.from_numpy(P), torch.from_numpy(Q),
                     torch.tensor(3.1)), 300, u)
    assert bulk.shape == (4, 300)
    np.testing.assert_allclose(np.take_along_axis(bulk, got_i, 1), got_v,
                               atol=1e-6)


@pytest.mark.parametrize("kernel", ["linear", "rbf"])
def test_streaming_topk_matches_jax(kernel):
    rng = np.random.default_rng(4)
    cfg, jcfg = _cfgs(kernel)
    pu, Q = _rows(cfg, 5, rng, "user"), _rows(cfg, 1024, rng, "item")
    valid = (rng.random(1024) > 0.2).astype(np.float32)
    got_v, got_i = scoring.streaming_topk(
        cfg, torch.tensor(3.0), torch.from_numpy(pu), torch.from_numpy(Q),
        torch.from_numpy(valid), k=9, tile=256)
    want_v, want_i = jax_scoring.streaming_topk(
        jcfg, jnp.float32(3.0), jnp.asarray(pu), jnp.asarray(Q),
        jnp.asarray(valid), k=9, tile=256)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v), atol=1e-5)
    assert valid[got_i.numpy()].all()
    with pytest.raises(ValueError):
        scoring.streaming_topk(cfg, torch.tensor(3.0), torch.from_numpy(pu),
                               torch.from_numpy(Q[:1000]),
                               torch.from_numpy(valid[:1000]), k=9, tile=256)


def test_recommend_topk_matches_jax():
    rng = np.random.default_rng(2)
    cfg, jcfg = _cfgs("sigmoid")
    pu, Q = _rows(cfg, 4, rng, "user"), _rows(cfg, 40, rng, "item")
    valid = (np.arange(40) < 30).astype(np.float32)
    got_v, got_i = cuda_scores.recommend_topk(
        cfg, torch.tensor(3.0), torch.from_numpy(pu), torch.from_numpy(Q),
        torch.from_numpy(valid), k=5)
    want_v, want_i = jax_recommend_topk(
        jcfg, jnp.float32(3.0), jnp.asarray(pu), jnp.asarray(Q),
        jnp.asarray(valid), k=5, use_pallas=True, interpret=True)
    assert got_i.max() < 30
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v), atol=1e-4)


def test_ties_break_to_the_lower_index():
    """Duplicate item rows score identically; the top-k lists them in
    index order, like ``lax.top_k`` — in one block and across the
    streaming tiles."""
    rng = np.random.default_rng(5)
    cfg, jcfg = _cfgs("linear")
    pu = _rows(cfg, 2, rng, "user")
    Q = _rows(cfg, 512, rng, "item") * 0.1
    best = _rows(cfg, 1, rng, "item")[0] * 0
    best[: cfg.n_factors] = pu[0, : cfg.n_factors] * 5  # wins for user 0
    dup = [300, 7, 129, 450]  # the same row in both streaming tiles
    Q[dup] = best
    want = sorted(dup)
    v, i = scoring.catalog_topk(
        cfg, _Params(torch.from_numpy(pu), torch.from_numpy(Q),
                     torch.tensor(3.0)), 512, np.array([0, 1]), 6)
    assert list(i[0, :4]) == want
    assert np.all(v[0, :4] == v[0, 0])
    sv, si = scoring.streaming_topk(
        cfg, torch.tensor(3.0), torch.from_numpy(pu), torch.from_numpy(Q),
        torch.ones(512), k=6, tile=256)
    assert list(si[0, :4].numpy()) == want
    _, ji = jax_scoring.catalog_topk(
        jcfg, _Params(jnp.asarray(pu), jnp.asarray(Q), jnp.float32(3.0)),
        512, np.array([0, 1]), 6)
    np.testing.assert_array_equal(i, ji)
    ties = torch.tensor([[1.0, 2.0, 2.0, 0.5, 2.0, 1.0]])
    tv, ti = scoring.stable_topk(ties, 5)
    assert ti.tolist() == [[1, 2, 4, 0, 5]]


@pytest.mark.parametrize("body", ["stable_topk", "_sort_topk", "_select_topk",
                                  "_select_topk_sorting_ties"])
@pytest.mark.parametrize("scores", ["normal", "small_ints", "masked",
                                    "signed_zeros", "nans"])
def test_stable_topk_is_the_tie_rule(scores, body, monkeypatch):
    """``stable_topk`` and both its bodies against ``np.lexsort`` (score
    descending, then position ascending; a NaN first), exactly, for every k
    from 0 past the row length: rows with and without a tie at the cut in
    one batch (the selection body keeps the library top-k's pick on the
    first, takes every score at or above the cut on the second, by a wider
    top-k or, past ``SELECT_MAX_TIED``, a sort), ``-inf`` masks, ``-0.0``
    beside ``0.0``, NaNs, and a 1-D row."""
    rng = np.random.default_rng(["normal", "small_ints", "masked",
                                 "signed_zeros", "nans"].index(scores))
    B, n = 7, 33
    if scores == "normal":
        s = rng.normal(size=(B, n)).astype(np.float32)
        s[1, 5:9] = s[1, 20]  # a run of ties somewhere in one row
    else:
        s = rng.integers(-3, 4, (B, n)).astype(np.float32)
    if scores == "masked":
        s[rng.random((B, n)) < 0.5] = -np.inf
    if scores == "signed_zeros":
        s[(s == 0) & (rng.random((B, n)) < 0.5)] = -0.0
    if scores == "nans":
        s[rng.random((B, n)) < 0.2] = np.nan
        s[2] = np.nan  # a row whose cut falls among NaNs
    if body == "_select_topk_sorting_ties":
        monkeypatch.setattr(scoring, "SELECT_MAX_TIED", 0)
        body = "_select_topk"
    fn = getattr(scoring, body)
    t = torch.from_numpy(s)
    key = np.where(np.isnan(s), -np.inf, -(s + 0.0))  # NaN first
    for k in range(n + 2):
        kk = min(k, n)
        v, i = (fn(t, k) if body == "stable_topk" else fn(t, kk))
        want = np.stack([np.lexsort((np.arange(n), row))[:kk] for row in key])
        np.testing.assert_array_equal(i.numpy(), want)
        np.testing.assert_array_equal(v.numpy(), np.take_along_axis(s, want, 1))
        if body == "stable_topk":
            v1, i1 = fn(t[3], k)
            assert torch.equal(i1, i[3])
            np.testing.assert_array_equal(v1.numpy(), v[3].numpy())
    with pytest.raises(TypeError):
        scoring.stable_topk(t.double(), 3)


# The CUDA selection kernel's 64-bit key (``ops/cuda_topk.py``), modelled
# in plain PyTorch: ``order_bits`` and ``make_key`` of
# ``csrc/topk_select.cu``, whose statements
# ``test_select_kernel_key_model_is_the_sources`` holds to these.
KEY_SOURCE = {
    "order_bits": "const uint32_t b = __float_as_uint(f); "
                  "if ((b & 0x7fffffffu) > 0x7f800000u) return 0xffffffffu; "
                  "if (b == 0x80000000u) return 0x80000000u; "
                  "return (b & 0x80000000u) ? ~b : (b | 0x80000000u);",
    "make_key": "return (static_cast<Key>(order_bits(f)) << 32) | "
                "(0xffffffffu - static_cast<uint32_t>(pos));",
}


def _kernel_keys(s):
    """The kernel's keys of (rows, n) f32 scores: the order-preserving
    integer of the score (every NaN ``0xffffffff``, ``-0.0`` as ``0.0``)
    above ``0xffffffff`` less the position. Returned as int64 less 2^63,
    so that int64 order is the kernel's unsigned order."""
    n = s.shape[-1]
    b = s.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    hi = torch.where(b >= 0x80000000, b ^ 0xFFFFFFFF, b | 0x80000000)
    hi = torch.where(b == 0x80000000, 0x80000000, hi)
    hi = torch.where((b & 0x7FFFFFFF) > 0x7F800000, 0xFFFFFFFF, hi)
    lo = 0xFFFFFFFF - torch.arange(n, dtype=torch.int64)
    return (hi - 2**31) * 2**32 + lo


def _kernel_key_topk(s, k):
    """The k largest keys of each row, decoded: the rule's (values,
    positions) by the kernel's arithmetic."""
    top = torch.topk(_kernel_keys(s), k, dim=-1, sorted=True).values
    idx = 0xFFFFFFFF - (top & 0xFFFFFFFF)
    return s.gather(-1, idx), idx


def test_select_kernel_key_model_is_the_sources():
    """``KEY_SOURCE`` is what ``order_bits`` and ``make_key`` in
    ``csrc/topk_select.cu`` say, statement for statement (comments and
    spacing aside): a change to the kernel's key fails here until the
    model follows it."""
    import re
    from pathlib import Path

    src = (Path(scoring.__file__).resolve().parent.parent / "csrc"
           / "topk_select.cu").read_text()
    for name, want in KEY_SOURCE.items():
        m = re.search(name + r"\([^)]*\) \{\n(.*?)\n\}", src, re.S)
        assert m, f"no {name} in topk_select.cu"
        body = " ".join(re.sub(r"//[^\n]*", "", m.group(1)).split())
        assert body == want, f"{name}: {body}"


def _rule_positions(s, k):
    """Each row's first k positions under the tie rule by ``np.lexsort``: a
    NaN first (above ``+inf``), then score descending (``-0.0`` as
    ``0.0``), then position ascending."""
    nan = np.isnan(s)
    neg = np.where(nan, 0.0, -(s.astype(np.float64) + 0.0))
    pos = np.arange(s.shape[1])
    return np.stack([np.lexsort((pos, neg[r], ~nan[r]))[:k]
                     for r in range(len(s))])


@pytest.mark.parametrize("scores", ["normal_ties", "small_ints", "signed_zeros",
                                    "nans", "infs", "all_equal"])
def test_select_kernel_key_is_the_tie_rule(scores):
    """The plain model of the CUDA selection kernel's 64-bit key
    (``_kernel_keys``, decoded by ``_kernel_key_topk``)
    against ``np.lexsort`` and against the torch selection body on the
    same scores, for every k from 0 to the row: ties inside the k and at
    the cut, ``-0.0`` beside ``0.0``, NaNs of both signs above ``+inf``,
    ``-inf``, and rows whose every score is equal. The keys of a row are
    unique, so their order is total."""
    rng = np.random.default_rng(["normal_ties", "small_ints", "signed_zeros",
                                 "nans", "infs", "all_equal"].index(scores))
    B, n = 6, 41
    s = rng.integers(-3, 4, (B, n)).astype(np.float32)
    if scores == "normal_ties":
        s = rng.normal(size=(B, n)).astype(np.float32)
        s[1, 5:9] = s[1, 20]
    if scores == "signed_zeros":
        s[(s == 0) & (rng.random((B, n)) < 0.5)] = -0.0
    if scores in ("nans", "infs"):
        s[rng.random((B, n)) < 0.2] = np.nan
        s[2] = -np.float32(np.nan)  # NaNs with the sign bit set
    if scores == "infs":
        r = rng.random((B, n))
        s[(r < 0.2) & ~np.isnan(s)] = np.inf
        s[(r > 0.7) & ~np.isnan(s)] = -np.inf
        s[4] = -np.inf
    if scores == "all_equal":
        s[:] = 1.5
        s[1] = -0.0
        s[2] = -np.inf
    t = torch.from_numpy(s)
    keys = _kernel_keys(t)
    assert keys.dtype == torch.int64
    assert all(len(set(row)) == n for row in keys.tolist())
    for k in range(n + 1):
        v, i = _kernel_key_topk(t, k)
        want = _rule_positions(s, k)
        np.testing.assert_array_equal(i.numpy(), want)
        np.testing.assert_array_equal(v.numpy(), np.take_along_axis(s, want, 1))
        pv, pi = scoring._select_topk(t, k)
        assert torch.equal(pi, i)
        np.testing.assert_array_equal(pv.numpy(), v.numpy())


def test_select_on_cpu_never_launches_the_kernel():
    """A CPU tensor takes the torch selection body: ``stable_topk`` of a
    block just past ``SORT_MAX_SCORES`` and ``_select_topk`` itself count
    no launch of the CUDA kernel, and its wrapper refuses a CPU tensor."""
    from matrix_factorization_tpu_torch.ops import cuda_topk

    rng = np.random.default_rng(7)
    n = scoring.SORT_MAX_SCORES // 2 + 1
    s = torch.from_numpy(rng.standard_normal((2, n), dtype=np.float32))
    before = _build.launches("mf_topk_select")
    v, i = scoring.stable_topk(s, 10)
    assert _build.launches("mf_topk_select") == before
    want = _kernel_key_topk(s, 10)
    assert torch.equal(i, want[1]) and torch.equal(v, want[0])
    scoring._select_topk(s[:, :100], 5)
    assert _build.launches("mf_topk_select") == before
    with pytest.raises(ValueError):
        cuda_topk.cuda_select_topk(s, 5)
    assert _build.launches("mf_topk_select") == before


@pytest.mark.parametrize("kernel", ["linear", "sigmoid", "rbf"])
def test_kernel_forwards_match_jax(kernel):
    rng = np.random.default_rng(6)
    pu = rng.normal(0, 0.5, (64, 16)).astype(np.float32)
    qi = rng.normal(0, 0.5, (64, 16)).astype(np.float32)
    bu, bi = rng.normal(0, 0.3, (2, 64)).astype(np.float32)
    args = (3.2, bu, bi, pu, qi, 0.07, 1.0, 4.0)
    got = torch_kernels.forward(kernel, *(
        torch.from_numpy(x) if isinstance(x, np.ndarray) else x for x in args))
    want = jax_kernels.forward(kernel, *(
        jnp.asarray(x) if isinstance(x, np.ndarray) else x for x in args))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    with pytest.raises(ValueError):
        torch_kernels.forward("cubic", *args)


def test_scorer_device_rules():
    """CPU tensors take the plain version; the CUDA wrapper takes CUDA
    tensors only, and an unknown device has no scorer."""
    cfg, _ = _cfgs("linear")
    pu = torch.zeros(2, cfg.padded_factors)
    Q = torch.zeros(3, cfg.padded_factors)
    before = _build.launches("mf_score_catalog")
    scoring.score_catalog(cfg, torch.tensor(1.0), pu, Q)
    assert _build.launches("mf_score_catalog") == before  # the plain version launches nothing
    with pytest.raises(ValueError, match="CUDA"):
        cuda_scores.cuda_score_catalog(cfg, torch.tensor(1.0), pu, Q)
    with pytest.raises(ValueError, match="no catalog scorer"):
        scoring.score_catalog(cfg, torch.tensor(1.0), pu.to("meta"),
                              Q.to("meta"))
