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
from matrix_factorization_tpu_torch.ops import cuda_sgd
from matrix_factorization_tpu_torch.ops import segment_sgd as sgd

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
    before = (cuda_sgd.step_launches, cuda_sgd.apply_launches)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_sgd.cuda_sgd_step(*args, t2[0], t2[1], prim, sec, r, w, pm, sm,
                               LR, cfg.reg)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_sgd.cuda_segment_apply(t2[1], plain, prim, sec)
    assert (cuda_sgd.step_launches, cuda_sgd.apply_launches) == before
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
