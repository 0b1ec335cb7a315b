"""One mini-batch SGD step of the PyTorch port against the JAX package.

The same numpy ratings are packed by both packages and one batch goes
through the port's ``minibatch_update`` on CPU tensors (the plain
versions of the CUDA step and apply kernels) and through the JAX
``_minibatch_update`` on its XLA path (``use_fused=False``), its fused
Pallas step in interpret mode (as ``tests/test_pallas_sgd.py`` runs it),
and ``sgd_minibatch_step``. Both tables after the step agree at atol
1e-6: every row reads the pre-step tables and deltas of one row sum, so
only the float summation order differs."""

import jax
import numpy as np
import pytest
import torch

from matrix_factorization_tpu.core.config import SGDConfig as JaxConfig
from matrix_factorization_tpu.ops import segment_sgd as jsgd
from matrix_factorization_tpu_torch.core.config import SGDConfig
from matrix_factorization_tpu_torch.ops import _build, cuda_sgd
from matrix_factorization_tpu_torch.ops import segment_sgd as sgd
from matrix_factorization_tpu_torch.ops import segment_sum as ss

ATOL = 1e-6
LR = 0.05


def _data(n=1500, n_users=200, n_items=120, seed=0):
    rng = np.random.default_rng(seed)
    u = rng.integers(0, n_users, n).astype(np.int32)
    i = rng.integers(0, n_items, n).astype(np.int32)
    r = rng.uniform(1, 5, n).astype(np.float32)
    return u, i, r


def _cfgs(kernel, **extra):
    kw = dict(kernel=kernel, n_factors=12, reg=0.02, gamma=0.05,
              min_rating=1.0, max_rating=5.0, shuffle="none", **extra)
    return SGDConfig(**kw), JaxConfig(**kw)


def _tables(jcfg, n_users=200, n_items=120):
    """JAX init tables with nonzero biases (so the bias columns move)."""
    p = jsgd.init_params(jax.random.PRNGKey(0), n_users, n_items, jcfg, 3.0)
    rng = np.random.default_rng(9)
    P, Q = np.array(p.user_features), np.array(p.item_features)
    if jcfg.kernel != "rbf":
        P[:, jsgd.bias_col(jcfg, "user")] = rng.normal(0, 0.1, len(P))
        Q[:, jsgd.bias_col(jcfg, "item")] = rng.normal(0, 0.1, len(Q))
    return P, Q


def _jax_params(P, Q):
    import jax.numpy as jnp

    return jsgd.MFParams(jnp.asarray(P), jnp.asarray(Q), jnp.float32(3.0))


def _port_step(P, Q, data, k, cfg):
    params = sgd.params_from_numpy(P, Q, 3.0, device="cpu")
    out = sgd.minibatch_update(params, sgd.batch_at(data, k), cfg, LR,
                               data.primary)
    assert out is params  # in place
    return out.user_features.numpy(), out.item_features.numpy()


def _jax_step(P, Q, jdata, k, jcfg, use_fused):
    xs, agg_prim, agg_sec, expand = jsgd.epoch_xs(jdata, jcfg)
    b = {name: v[k] for name, v in xs.items()}
    out = jsgd._minibatch_update(_jax_params(P, Q), b, jcfg, LR, agg_prim,
                                 agg_sec, jdata.primary, expand,
                                 use_fused=use_fused)
    return np.asarray(out.user_features), np.asarray(out.item_features)


def _assert_tables(got, want):
    np.testing.assert_allclose(got[0], want[0], atol=ATOL, rtol=0)
    np.testing.assert_allclose(got[1], want[1], atol=ATOL, rtol=0)


@pytest.mark.parametrize("order", ["user", "item"])
@pytest.mark.parametrize("kernel", ["linear", "sigmoid", "rbf"])
def test_step_matches_jax_xla_and_scatter_steps(kernel, order):
    cfg, jcfg = _cfgs(kernel)
    u, i, r = _data()
    jdata = jsgd.pack_ratings(u, i, r, 256, shuffle_seed=3, order=order,
                              agg_min_gain=-1.0)
    data = sgd.pack_ratings(u, i, r, 256, shuffle_seed=3, order=order,
                            device="cpu")
    assert data.primary == order
    P, Q = _tables(jcfg)
    for k in (0, data.n_batches - 1):  # a full batch and the padded one
        got = _port_step(P, Q, data, k, cfg)
        before = (P.copy(), Q.copy())
        _assert_tables(got, _jax_step(P, Q, jdata, k, jcfg, use_fused=False))
        out = jsgd.sgd_minibatch_step(
            _jax_params(P, Q), jdata.user_ids[k], jdata.item_ids[k],
            jdata.ratings[k], jdata.weights[k], jcfg, LR)
        _assert_tables(got, (np.asarray(out.user_features),
                             np.asarray(out.item_features)))
        # the step wrote its own copies, not the numpy tables
        np.testing.assert_array_equal(P, before[0])
        np.testing.assert_array_equal(Q, before[1])
        assert not np.array_equal(got[0], P) and not np.array_equal(got[1], Q)


@pytest.mark.parametrize("order", ["user", "item"])
@pytest.mark.parametrize("kernel", ["linear", "sigmoid", "rbf"])
def test_step_matches_jax_fused_pallas_step(kernel, order, monkeypatch):
    monkeypatch.setattr(jsgd, "FUSED_STEP", "interpret")
    monkeypatch.setattr(jsgd, "FUSED_SEC_BF16", False)
    cfg, jcfg = _cfgs(kernel)
    u, i, r = _data()
    jdata = jsgd.pack_ratings(u, i, r, 256, shuffle_seed=3, order=order,
                              agg_min_gain=-1.0)
    assert jdata.agg_prim[1] > 0 and jsgd._fused_step_enabled(jcfg, jdata)
    data = sgd.pack_ratings(u, i, r, 256, shuffle_seed=3, order=order,
                            device="cpu")
    P, Q = _tables(jcfg)
    _assert_tables(_port_step(P, Q, data, 1, cfg),
                   _jax_step(P, Q, jdata, 1, jcfg, use_fused=True))


@pytest.mark.parametrize("kernel", ["linear", "sigmoid", "rbf"])
@pytest.mark.parametrize("frozen", ["item", "user"])
def test_step_with_a_frozen_side(kernel, frozen):
    """The item-primary pack of ``update_users``: with the item side
    frozen the step kernel's primary side is the frozen one, and only
    the apply writes (the user table); the user side frozen is the
    mirror case. The frozen table stays bitwise unchanged."""
    flags = {"update_item_params": frozen != "item",
             "update_user_params": frozen != "user"}
    cfg, jcfg = _cfgs(kernel, **flags)
    u, i, r = _data()
    jdata = jsgd.pack_ratings(u, i, r, 256, shuffle_seed=3, order="item",
                              agg_min_gain=-1.0)
    data = sgd.pack_ratings(u, i, r, 256, shuffle_seed=3, order="item",
                            device="cpu")
    P, Q = _tables(jcfg)
    got = _port_step(P, Q, data, 2, cfg)
    _assert_tables(got, _jax_step(P, Q, jdata, 2, jcfg, use_fused=False))
    frozen_tbl, orig = (got[1], Q) if frozen == "item" else (got[0], P)
    np.testing.assert_array_equal(frozen_tbl, orig)


@pytest.mark.parametrize("kernel", ["linear", "sigmoid", "rbf"])
def test_unsorted_batch_is_sorted_on_the_device(kernel):
    """A batch without the pack's sort (``aggregate=False``) is sorted
    inside the step and gives the scatter step's result."""
    cfg, jcfg = _cfgs(kernel)
    u, i, r = _data()
    data = sgd.pack_ratings(u, i, r, 256, order="user", aggregate=False,
                            device="cpu")
    assert data.sec_perm is None
    P, Q = _tables(jcfg)
    got = _port_step(P, Q, data, 0, cfg)
    b = sgd.batch_at(data, 0)
    out = jsgd.sgd_minibatch_step(
        _jax_params(P, Q), b["u"].numpy(), b["i"].numpy(), b["r"].numpy(),
        b["w"].numpy(), jcfg, LR)
    _assert_tables(got, (np.asarray(out.user_features),
                         np.asarray(out.item_features)))
    port = sgd.sgd_minibatch_step(sgd.params_from_numpy(P, Q, 3.0, device="cpu"),
                                  b["u"], b["i"], b["r"], b["w"], cfg, LR)
    _assert_tables((port.user_features.numpy(), port.item_features.numpy()),
                   (np.asarray(out.user_features), np.asarray(out.item_features)))


@pytest.mark.parametrize("kernel", ["linear", "sigmoid", "rbf"])
def test_colliding_rows_sum(kernel):
    """Duplicate ids in one batch: each row gets the sum of its entries'
    deltas, all taken from the pre-step rows (a float64 numpy loop)."""
    cfg, jcfg = _cfgs(kernel)
    u = np.array([0, 0, 0, 1, 1, 2, 0, 1], np.int32)
    i = np.array([0, 1, 0, 1, 2, 2, 2, 0], np.int32)
    r = np.array([1, 2, 3, 4, 5, 1.5, 2.5, 3.5], np.float32)
    w = np.array([1, 1, 1, 1, 1, 1, 1, 0], np.float32)  # the last is a pad
    P, Q = _tables(jcfg, 8, 8)
    want_P, want_Q = P.astype(np.float64), Q.astype(np.float64)
    mu, a, c, g = 3.0, cfg.a, cfg.c, cfg.gamma
    pm = sgd.update_mask(cfg, "user")
    qm = sgd.update_mask(cfg, "item")
    for uu, ii, rr, ww in zip(u, i, r, w):
        p, q = P[uu].astype(np.float64), Q[ii].astype(np.float64)
        if kernel == "rbf":
            e = np.exp(-g * np.sum((p - q) ** 2))
            pred, dp = a + c * e, -(p - q) * 2 * g * e
            dq = -dp
        else:
            x = mu + p @ q
            s = 1 / (1 + np.exp(-x))
            pred = x if kernel == "linear" else a + c * s
            base = 1.0 if kernel == "linear" else s * (1 - s)
            dp, dq = q * base, p * base
        err = (pred - rr) * ww
        want_P[uu] -= LR * (err * dp + cfg.reg * ww * p) * pm
        want_Q[ii] -= LR * (err * dq + cfg.reg * ww * q) * qm
    for primary in ("user", "item"):
        prim, sec = (u, i) if primary == "user" else (i, u)
        srt = np.argsort(prim, kind="stable")
        b = {k: torch.from_numpy(v[srt]) for k, v in
             (("u", u), ("i", i), ("r", r), ("w", w))}
        sp = np.argsort(sec[srt], kind="stable")
        b["sp"] = torch.from_numpy(sp.astype(np.int32))
        b["ss"] = torch.from_numpy(sec[srt][sp])
        params = sgd.params_from_numpy(P, Q, mu, device="cpu")
        sgd.minibatch_update(params, b, cfg, LR, primary)
        np.testing.assert_allclose(params.user_features.numpy(), want_P,
                                   atol=ATOL, rtol=0)
        np.testing.assert_allclose(params.item_features.numpy(), want_Q,
                                   atol=ATOL, rtol=0)


def test_plain_versions_are_the_routed_cpu_path():
    """On CPU tensors the router takes the plain versions; a CUDA
    wrapper refuses CPU tensors instead of falling back."""
    cfg, jcfg = _cfgs("sigmoid")
    P, Q = _tables(jcfg, 16, 16)
    prim = torch.tensor([0, 0, 3, 5], dtype=torch.int32)
    sec = torch.tensor([2, 7, 2, 1], dtype=torch.int32)
    r = torch.tensor([1.0, 2.0, 3.0, 4.0])
    w = torch.ones(4)
    mu = torch.tensor(3.0)
    pm = torch.from_numpy(sgd.update_mask(cfg, "user"))
    sm = torch.from_numpy(sgd.update_mask(cfg, "item"))
    args = (cfg, mu)
    tabs = [torch.from_numpy(P.copy()), torch.from_numpy(Q.copy())]
    routed = cuda_sgd.sgd_step(*args, tabs[0], tabs[1], prim, sec, r, w, pm,
                               sm, LR, cfg.reg)
    t2 = [torch.from_numpy(P.copy()), torch.from_numpy(Q.copy())]
    plain = cuda_sgd.plain_sgd_step(*args, t2[0], t2[1], prim, sec, r, w, pm,
                                    sm, LR, cfg.reg)
    assert torch.equal(routed, plain) and torch.equal(tabs[0], t2[0])
    entries = ("mf_sgd_step", "mf_sgd_step_acc", "mf_segment_apply")
    before = [_build.launches(e) for e in entries]
    with pytest.raises(ValueError, match="CUDA"):
        cuda_sgd.cuda_sgd_step(*args, t2[0], t2[1], prim, sec, r, w, pm, sm,
                               LR, cfg.reg)
    with pytest.raises(ValueError, match="CUDA"):
        ss.cuda_segment_apply(t2[1], plain, prim, sec)
    assert [_build.launches(e) for e in entries] == before
    assert cuda_sgd.plain_sgd_step(*args, t2[0], t2[1], prim, sec, r, w, pm,
                                   sm, LR, cfg.reg, write_dq=False) is None


@pytest.mark.parametrize("kernel", ["linear", "sigmoid", "rbf"])
def test_forward_and_grads_match_jax(kernel):
    """``ops/kernels.py::forward_and_grads`` and the bias-folded
    ``ext_forward_and_rowgrads`` against the JAX functions, atol 1e-6."""
    from matrix_factorization_tpu.ops import kernels as jkernels
    from matrix_factorization_tpu_torch.ops import kernels

    rng = np.random.default_rng(4)
    pu, qi = (rng.normal(0, 0.3, (64, 12)).astype(np.float32) for _ in range(2))
    bu, bi = (rng.normal(0, 0.2, 64).astype(np.float32) for _ in range(2))
    args = (3.0, bu, bi, pu, qi, 0.07, 1.0, 4.0)
    pred, grads = kernels.forward_and_grads(
        kernel, *(torch.from_numpy(a) if isinstance(a, np.ndarray) else a
                  for a in args))
    jpred, jgrads = jkernels.forward_and_grads(kernel, *args)
    np.testing.assert_allclose(pred.numpy(), np.asarray(jpred), atol=ATOL)
    for got, want in zip(grads, jgrads):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    np.testing.assert_allclose(
        kernels.forward(kernel, 3.0, *(torch.from_numpy(a) for a in
                                       (bu, bi, pu, qi)), 0.07, 1.0, 4.0).numpy(),
        np.asarray(jpred), atol=ATOL)

    cfg, jcfg = _cfgs(kernel)
    P, Q = _tables(jcfg, 64, 64)
    got = sgd.ext_forward_and_rowgrads(cfg, torch.tensor(3.0),
                                       torch.from_numpy(P), torch.from_numpy(Q))
    want = jsgd.ext_forward_and_rowgrads(jcfg, 3.0, P, Q)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL)


# ---------------------------------------------------------------------------
# The summation of the CUDA step kernel (fixed segments, pieces of a run
# that crosses a segment boundary added in segment order), in plain PyTorch
# ---------------------------------------------------------------------------

SEG_ATOL = 1e-5  # segmented against plain: f32 sums in another order
JAX_ATOL = 2e-5  # against the JAX scatter step


def _boundary_ids(case, seg_len, rng):
    """Sorted primary ids (and the number of weight-0 pads at the tail)
    of a batch that puts runs where the segment logic has to decide."""
    L = seg_len
    if case == "run_ends_at_boundary":
        # runs of exactly L, L/2 + L/2 and one that stops at 3L - 1
        ids = np.r_[np.full(L, 0), np.full(L // 2, 1), np.full(L // 2, 2),
                    np.full(L - 1, 3), [4], np.full(L // 2, 5)]
        return ids, 0
    if case == "run_over_three_segments":
        # begins mid-segment, covers three whole segments, ends mid-segment;
        # then one that begins at a boundary and covers three exactly
        ids = np.r_[np.full(L // 2, 0), np.full(L // 2 + 3 * L + 1, 1),
                    np.full(L - 1, 2), np.full(3 * L, 3), [4, 5]]
        return ids, 0
    if case == "single_run":
        return np.full(2 * L + L // 2, 3), 0
    if case == "ragged":
        return np.sort(rng.integers(0, 9, 5 * L + 3)), 0
    if case == "pad_tail":
        ids = np.sort(rng.integers(0, 9, 4 * L))
        return np.r_[ids, np.full(L + 1, ids[-1])], L + 1
    raise ValueError(case)


BOUNDARY_CASES = ["run_ends_at_boundary", "run_over_three_segments",
                  "single_run", "ragged", "pad_tail"]


def _boundary_batch(case, seg_len, primary, n_sec=30):
    rng = np.random.default_rng(len(case) + seg_len)
    prim, n_pad = _boundary_ids(case, seg_len, rng)
    prim = prim.astype(np.int32)
    n = len(prim)
    sec = rng.integers(0, n_sec, n).astype(np.int32)
    r = rng.uniform(1, 5, n).astype(np.float32)
    w = np.ones(n, np.float32)
    if n_pad:
        w[-n_pad:] = 0.0
    u, i = (prim, sec) if primary == "user" else (sec, prim)
    sp = np.argsort(sec, kind="stable").astype(np.int32)
    return {"u": u, "i": i, "r": r, "w": w, "sp": sp, "ss": sec[sp]}


def _segmented_update(P, Q, b, cfg, primary, seg_len, step=None):
    """The port's mini-batch update on CPU tensors with the primary deltas
    summed by ``segmented_sgd_step`` (or by ``step``)."""
    step = step or (lambda *a, **k: cuda_sgd.segmented_sgd_step(
        *a, **k, seg_len=seg_len))
    tabs = {"user": torch.from_numpy(P.copy()), "item": torch.from_numpy(Q.copy())}
    prim, sec = ("user", "item") if primary == "user" else ("item", "user")
    t = {k: torch.from_numpy(v) for k, v in b.items()}
    ids = {"user": t["u"], "item": t["i"]}
    upd = {"user": cfg.update_user_params, "item": cfg.update_item_params}
    dq = step(cfg, torch.tensor(3.0), tabs[prim], tabs[sec], ids[prim],
              ids[sec], t["r"], t["w"],
              torch.from_numpy(sgd.update_mask(cfg, prim)),
              torch.from_numpy(sgd.update_mask(cfg, sec)), LR, cfg.reg,
              update_prim=upd[prim], write_dq=upd[sec])
    assert (dq is None) == (not upd[sec])
    if dq is not None:
        ss.plain_segment_apply(tabs[sec], dq, t["sp"], t["ss"])
    return tabs["user"].numpy(), tabs["item"].numpy(), dq


def _jax_scatter_update(P, Q, b, jcfg, primary):
    import jax.numpy as jnp

    jb = {k: jnp.asarray(b[k]) for k in ("u", "i", "r", "w")}
    out = jsgd._minibatch_update(_jax_params(P, Q), jb, jcfg, LR, (0, 0),
                                 (0, 0), primary, False, use_fused=False)
    return np.asarray(out.user_features), np.asarray(out.item_features)


@pytest.mark.parametrize("case", BOUNDARY_CASES)
@pytest.mark.parametrize("seg_len", [4, 32])
@pytest.mark.parametrize("primary", ["user", "item"])
@pytest.mark.parametrize("kernel", ["linear", "sigmoid", "rbf"])
def test_segmented_step_matches_plain_and_jax(kernel, primary, seg_len, case):
    """``segmented_sgd_step`` (the CUDA kernel's summation) against
    ``plain_sgd_step`` at 1e-5 and the JAX scatter step at 2e-5, on
    batches whose runs end at, cross and cover segment boundaries."""
    cfg, jcfg = _cfgs(kernel)
    b = _boundary_batch(case, seg_len, primary)
    P, Q = _tables(jcfg, 32, 32)
    got = _segmented_update(P, Q, b, cfg, primary, seg_len)
    want = _segmented_update(P, Q, b, cfg, primary, seg_len,
                             step=cuda_sgd.plain_sgd_step)
    for g, w_ in zip(got[:2], want[:2]):
        np.testing.assert_allclose(g, w_, atol=SEG_ATOL, rtol=SEG_ATOL)
    assert torch.equal(got[2], want[2])  # dq is per entry: the same bits
    jax_out = _jax_scatter_update(P, Q, b, jcfg, primary)
    np.testing.assert_allclose(got[0], jax_out[0], atol=JAX_ATOL, rtol=0)
    np.testing.assert_allclose(got[1], jax_out[1], atol=JAX_ATOL, rtol=0)
    assert not np.array_equal(got[0], P) and not np.array_equal(got[1], Q)


@pytest.mark.parametrize("frozen", ["user", "item"])
@pytest.mark.parametrize("seg_len", [4, 32])
@pytest.mark.parametrize("kernel", ["linear", "sigmoid", "rbf"])
def test_segmented_step_with_a_frozen_side(kernel, seg_len, frozen):
    """A frozen primary side is not written though runs cross segment
    boundaries; a frozen secondary side gets no deltas. Both agree with
    the JAX scatter step."""
    flags = {"update_item_params": frozen != "item",
             "update_user_params": frozen != "user"}
    cfg, jcfg = _cfgs(kernel, **flags)
    P, Q = _tables(jcfg, 32, 32)
    for primary in ("user", "item"):
        b = _boundary_batch("run_over_three_segments", seg_len, primary)
        got = _segmented_update(P, Q, b, cfg, primary, seg_len)
        frozen_tbl, orig = (got[0], P) if frozen == "user" else (got[1], Q)
        np.testing.assert_array_equal(frozen_tbl, orig)
        jax_out = _jax_scatter_update(P, Q, b, jcfg, primary)
        np.testing.assert_allclose(got[0], jax_out[0], atol=JAX_ATOL, rtol=0)
        np.testing.assert_allclose(got[1], jax_out[1], atol=JAX_ATOL, rtol=0)


def test_segmented_step_sums_pieces_in_segment_order():
    """The pieces of a run are each summed from zero in entry order and
    then added in segment order to the pre-step row: with deltas chosen
    so that f32 addition order shows, the result is that order's bits."""
    cfg = SGDConfig(kernel="linear", n_factors=4, reg=0.0, shuffle="none")
    kp = cfg.padded_factors
    n, seg_len = 10, 4
    P = torch.zeros(2, kp)
    P[1, 0] = 1.0
    S = torch.zeros(n, kp)
    S[:, 0] = torch.tensor([1e8, 1.0, -1e8, 1.0, 3.0, 1e-3, 1e8, -1e8, 5.0, 7.0])
    # pred = mu + <x, y> with mu = 0; r chosen so that err = -1: delta = lr * y
    ids = torch.ones(n, dtype=torch.int32)
    sec = torch.arange(n, dtype=torch.int32)
    y0 = S[:, 0]
    r = (P[1, 0] * y0) + 1.0
    mask = torch.zeros(kp)
    mask[0] = 1.0
    Pk = P.clone()
    cuda_sgd.segmented_sgd_step(cfg, torch.tensor(0.0), Pk, S, ids, sec, r,
                                torch.ones(n), mask, mask, 1.0, 0.0,
                                seg_len=seg_len)
    err = (P[1, 0] * y0) - r
    d = -(err * y0)
    pieces = []
    for lo in range(0, n, seg_len):
        acc = torch.tensor(0.0)
        for v in d[lo:lo + seg_len]:
            acc = acc + v
        pieces.append(acc)
    total = pieces[0]
    for p in pieces[1:]:
        total = total + p
    assert Pk[1, 0].item() == (P[1, 0] + total).item()
    assert torch.equal(Pk[0], P[0])
    with pytest.raises(ValueError):
        cuda_sgd.segmented_sgd_step(cfg, torch.tensor(0.0), Pk, S, ids, sec, r,
                                    torch.ones(n), mask, mask, 1.0, 0.0,
                                    seg_len=0)


def _acc_step(step, cfg, P, Q, b, primary, prim_out):
    """One step of ``step`` with the primary deltas added to ``prim_out``;
    returns (primary table after, prim_out, dq)."""
    tabs = {"user": torch.from_numpy(P.copy()), "item": torch.from_numpy(Q.copy())}
    prim, sec = ("user", "item") if primary == "user" else ("item", "user")
    t = {k: torch.from_numpy(v) for k, v in b.items()}
    ids = {"user": t["u"], "item": t["i"]}
    dq = step(cfg, torch.tensor(3.0), tabs[prim], tabs[sec], ids[prim],
              ids[sec], t["r"], t["w"],
              torch.from_numpy(sgd.update_mask(cfg, prim)),
              torch.from_numpy(sgd.update_mask(cfg, sec)), LR, cfg.reg,
              prim_out=prim_out)
    return tabs[prim], prim_out, dq


@pytest.mark.parametrize("case", BOUNDARY_CASES)
@pytest.mark.parametrize("seg_len", [4, 32])
@pytest.mark.parametrize("kernel", ["linear", "sigmoid", "rbf"])
def test_prim_out_is_the_in_place_delta(kernel, seg_len, case):
    """The accumulator mode of ``plain_sgd_step`` and of
    ``segmented_sgd_step`` (the kernel's summation): the primary table is
    only read, ``prim_out`` started from zeros gains the in-place result
    minus the pre-step table (1e-6: one rounding of the subtraction), and
    ``prim_out`` started from the pre-step table gains the in-place bits,
    runs that cross segment boundaries included; ``dq`` is the same."""
    cfg, jcfg = _cfgs(kernel)
    P, Q = _tables(jcfg, 32, 32)
    steps = {"plain": cuda_sgd.plain_sgd_step,
             "segmented": lambda *a, **k: cuda_sgd.segmented_sgd_step(
                 *a, **k, seg_len=seg_len)}
    for primary in ("user", "item"):
        b = _boundary_batch(case, seg_len, primary)
        pre = P if primary == "user" else Q
        for name, step in steps.items():
            inplace, _, dq0 = _acc_step(step, cfg, P, Q, b, primary, None)
            zeros = torch.zeros(pre.shape)
            tbl, out, dq = _acc_step(step, cfg, P, Q, b, primary, zeros)
            np.testing.assert_array_equal(tbl.numpy(), pre)
            np.testing.assert_allclose(out.numpy(), inplace.numpy() - pre,
                                       atol=1e-6, rtol=0, err_msg=name)
            assert torch.equal(dq, dq0)
            _, out, _ = _acc_step(step, cfg, P, Q, b, primary,
                                  torch.from_numpy(pre.copy()))
            assert torch.equal(out, inplace), name
