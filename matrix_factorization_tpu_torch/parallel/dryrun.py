"""One step of each multi-device path on tiny shapes, over a world of ranks.

The KernelMF part of ``__graft_entry__.dryrun_multichip`` (the JAX
package's multi-device smoke run): on ``n_devices`` ranks started by
``parallel/launch.py::spawn_world``, one data-parallel epoch flat,
overlapped and tiled, one 2D epoch and one sharded-catalog top-k; then
one epoch each of the data-parallel factor ALS (count buckets, the
solves split over the ranks), bias ALS and bias SGD (each rank its
columns of every batch) and NMF (its rows of P); then one epoch each of
the data-parallel BPR and SVD++ trainers, flat and tiled. Then the gram models'
sections: the data-parallel EASE gram and ``ease_weights_sharded`` (Schur
and Newton-Schulz), and ``similarity_topk(mesh=)``; last the row-sharded
dense retrieval (``retrieval/search.py::dense_topk_mesh``). Run it as

    python -m matrix_factorization_tpu_torch.parallel.dryrun 4 [gloo|nccl] [cuda:0|cpu]

Every rank runs on the GPU unless the caller names the CPU (``cpu`` here,
``device='cpu'`` from Python); without a GPU that raises.
"""

from __future__ import annotations

import sys

import numpy as np


def _rank(rank: int, world: int, device: str) -> dict:
    import torch

    from matrix_factorization_tpu_torch.core.config import SGDConfig
    from matrix_factorization_tpu_torch.parallel import distributed as pdist
    from matrix_factorization_tpu_torch.parallel.mesh import make_mesh
    from matrix_factorization_tpu_torch.parallel.serving import ShardedCatalog

    n_model = 2 if world % 2 == 0 and world >= 4 else 1
    mesh = make_mesh(world)
    mesh2 = make_mesh(world // n_model, n_model)
    rng = np.random.default_rng(0)
    n_users, n_items, n = 16 * world, 40, 512
    u = rng.integers(0, n_users, n).astype(np.int32)
    i = rng.integers(0, n_items, n).astype(np.int32)
    r = rng.uniform(1, 5, n).astype(np.float32)
    cfg = SGDConfig(kernel="linear", n_factors=16, batch_size=64, lr=0.05,
                    reg=0.02)
    fit = dict(n_epochs=1, lr=cfg.lr, device=device)
    out = {}
    for tag, kw in (("flat", {"layout": "flat"}),
                    ("overlap", {"layout": "flat", "overlap_psum": True}),
                    ("tiled", {"layout": "tiled", "pack_order": "shuffle"})):
        local, hist = pdist.dp_fit(u, i, r, n_users, n_items, cfg,
                                   mesh=mesh, **fit, **kw)
        out[tag] = hist
    whole = pdist.gather_params(local, mesh, q_sharded=False)
    out["Q"] = whole.item_features.cpu().numpy()
    local2, out["2d"] = pdist.dp_tp_fit(u, i, r, n_users, n_items, cfg,
                                        mesh=mesh2, **fit)
    cat = ShardedCatalog(local2, n_items, cfg, mesh2, q_sharded=n_model > 1)
    pu = pdist.gather_params(local2, mesh2, n_model > 1).user_features[:8]
    out["topk"] = cat.topk(pu, 5)
    out.update(_rank_als_nmf(u, i, r, n_users, n_items, mesh, device))
    out.update(_rank_families(u, i, r, n_users, n_items, mesh, device))
    out.update(_rank_gram(u, i, r, n_users, n_items, mesh, device))
    out.update(_rank_retrieval(mesh, device))
    out["device"] = str(torch.device(device))
    return out


def _rank_als_nmf(u, i, r, n_users, n_items, mesh, device) -> dict:
    """One epoch of each slice-6b trainer on this rank: the whole tables
    it ends with (factor ALS, NMF) or the biases (bias ALS and SGD), and
    each train-RMSE history."""
    import torch

    from matrix_factorization_tpu_torch.core.config import SGDConfig
    from matrix_factorization_tpu_torch.ops import als, ials, nmf
    from matrix_factorization_tpu_torch.ops import segment_sgd as sgd
    from matrix_factorization_tpu_torch.parallel import distributed as pdist
    from matrix_factorization_tpu_torch.parallel.mesh import data_size_of, device_index

    n, d = data_size_of(mesh), device_index(mesh)
    out = {}
    cfg = SGDConfig(kernel="linear", n_factors=8, reg=0.1, batch_size=64)
    gen = torch.Generator(device=device).manual_seed(0)
    p0 = sgd.init_params(gen, n_users, n_items, cfg, float(r.mean()))
    bu, bi = ials.group_both_sides_bucketed(u, i, r, n_users, n_items,
                                            max_block_rows=64, device=device)
    data = sgd.pack_ratings(u, i, r, 64, aggregate=False, device=device)
    p, out["ials"] = ials.dp_ials_train_bucketed(p0, bu, bi, data, cfg, 1, mesh,
                                                 reg_scale="per_obs")
    out["ials_Q"] = p.item_features.cpu().numpy()

    b0 = als.init_bias_params(n_users, n_items, float(r.mean()), device=device)
    cols = als.shard_bias_data(
        sgd.pack_ratings(u, i, r, 16 * n, aggregate=False, device="cpu"),
        mesh, device)
    b, out["bias_als"] = als.dp_als_train(b0, cols, 0.5, 1, mesh)
    out["bias_als_b"] = b.item_biases.cpu().numpy()
    order = torch.randperm(cols.n_batches, generator=sgd.seeded_generator("cpu", 0))
    b, out["bias_sgd"] = als.dp_bias_sgd_train(b0, cols, [order], 0.05, 0.1, mesh)
    out["bias_sgd_b"] = b.item_biases.cpu().numpy()

    ucap = sgd.round_up(n_users, 8 * n)
    q = nmf.init_nmf_params(torch.Generator(device=device).manual_seed(0),
                            n_users, n_items, cfg, user_capacity=ucap)
    rows = ucap // n
    pack = sgd.pack_ratings(u, i, r, 64, order="auto", n_dev=n,
                            users_per_dev=rows, segment=d, device=device)
    cnt = torch.from_numpy(np.bincount(u, minlength=ucap).astype(np.float32))
    cnt_i = torch.from_numpy(np.bincount(i, minlength=q.item_features.shape[0])
                             .astype(np.float32))
    local, out["nmf"] = nmf.dp_nmf_train(
        pdist.place_params(q, mesh, device), pack,
        cnt[d * rows:(d + 1) * rows].to(device), cnt_i.to(device), cfg, 1,
        0.05, 0.05, mesh)
    out["nmf_Q"] = local.item_features.cpu().numpy()
    for tag in ("ials", "bias_als", "bias_sgd", "nmf"):
        out[tag] = out[tag].cpu().numpy()
    return out


def _rank_families(u, i, r, n_users, n_items, mesh, device) -> dict:
    """One epoch of each slice-6c trainer on this rank (BPR and SVD++, the
    flat stream and the device-major pack, seeded draws): each history,
    and the replicated tables it ends with (Q, and Y for SVD++)."""
    import torch

    from matrix_factorization_tpu_torch.core.config import SGDConfig
    from matrix_factorization_tpu_torch.ops import bpr, svdpp
    from matrix_factorization_tpu_torch.ops import segment_sgd as sgd
    from matrix_factorization_tpu_torch.parallel import distributed as pdist
    from matrix_factorization_tpu_torch.parallel.mesh import data_size_of, device_index

    n, d = data_size_of(mesh), device_index(mesh)
    cfg = SGDConfig(kernel="linear", n_factors=8, lr=0.05, reg=0.02)
    ucap, bs, stream = pdist.dp_fit_plumbing(u, i, r, n_users, mesh, 32)
    flat = pdist.local_ratings(stream, d, n, device)
    pack = sgd.pack_ratings(u, i, r, bs, order="user", n_dev=n,
                            users_per_dev=ucap // n, segment=d, device=device)
    rows = slice(d * ucap // n, (d + 1) * ucap // n)
    gen = torch.Generator(device=device).manual_seed(0)
    p0 = svdpp.init_params(gen, n_users, n_items, cfg, float(r.mean()),
                           user_capacity=ucap)
    local = p0._replace(user_features=p0.user_features[rows],
                        user_implicit_sums=p0.user_implicit_sums[rows])
    mf = sgd.MFParams(local.user_features, local.item_features,
                      local.global_mean)
    wvec = torch.from_numpy(svdpp._neighbor_weights(u, n_users, ucap)[rows]).to(device)
    deg = torch.from_numpy(np.bincount(i, minlength=p0.item_features.shape[0])
                           .astype(np.float32)).to(device)
    out = {}
    for tag, (p, h) in (
            ("bpr", bpr.dp_bpr_train(mf, flat, cfg, 1, 0.05, n_items, bs,
                                     len(u), mesh)),
            ("bpr_tiled", bpr.dp_bpr_train_tiled(mf, pack, cfg, 1, 0.05,
                                                 n_items, mesh,
                                                 overlap_psum=True)),
            ("svdpp", svdpp.dp_svdpp_train(local, flat, wvec, deg, cfg, 1,
                                           0.05, 0.02, bs, len(u), mesh)),
            ("svdpp_tiled", svdpp.dp_svdpp_train_batched(
                local, pack, wvec, deg, cfg, 1, 0.05, 0.02, mesh,
                psum_every="auto"))):
        out[tag] = h.cpu().numpy()
        out[f"{tag}_Q"] = p.item_features.cpu().numpy()
        if tag.startswith("svdpp"):
            out[f"{tag}_Y"] = p.implicit_features.cpu().numpy()
    return out


def _rank_gram(u, i, r, n_users, n_items, mesh, device) -> dict:
    """The gram models' sections of JAX's dry run
    (``__graft_entry__.py:281-315``) on this rank: the user-sharded EASE
    gram (one all-reduce) and this rank's rows of ``B`` by the Schur path
    and the row-sharded Newton-Schulz path; the sparse gram's top-k with
    the user blocks split over the mesh (one all-reduce a strip)."""
    from matrix_factorization_tpu_torch.ops import ease as ease_ops
    from matrix_factorization_tpu_torch.ops.sparse_gram import similarity_topk

    G = ease_ops.dp_item_gram(u.astype(np.int64), i.astype(np.int64),
                              np.ones_like(r), n_users, n_items, mesh,
                              device=device)
    out = {"ease_" + inv: ease_ops.ease_weights_sharded(
        G.clone(), 5.0, mesh, inverse=inv).cpu().numpy()
        for inv in ("schur", "ns")}
    out["sims"], out["sim_ids"], _, _ = similarity_topk(
        u, i, r, n_users, n_items, k=4, user_block=16, item_tile=16,
        mesh=mesh, device=device)
    return out


def _rank_retrieval(mesh, device) -> dict:
    """JAX's dense retrieval section (``__graft_entry__.py:316-328``): 40
    items, ``hash_embed`` at dim 64, the row-sharded top-5 of one query
    (``dense_topk_mesh``: each rank's rows, the candidates merged)."""
    from matrix_factorization_tpu_torch.retrieval.encode import hash_embed
    from matrix_factorization_tpu_torch.retrieval.index import build_dense_index
    from matrix_factorization_tpu_torch.retrieval.search import dense_topk_mesh

    texts = [f"item {j} topic{j % 7}" for j in range(40)]
    index = build_dense_index([str(j) for j in range(40)], texts,
                              hash_embed(texts, dim=64))
    return {"dense_topk": dense_topk_mesh(
        index, hash_embed(["topic3 item"], dim=64), 5, mesh, device=device)}


FAMILY_TAGS = ("bpr", "bpr_tiled", "svdpp", "svdpp_tiled")


def dryrun_multichip(n_devices: int, backend: str = "gloo",
                     device=None) -> dict:
    """The dry run on ``n_devices`` ranks of ``backend``, every rank on
    ``device`` (``None``: ``cuda:0``, raising without a GPU); raises if a
    rank fails, a history is not finite, the replicas of a replicated table
    (Q of every trainer, Y of SVD++, the biases) differ or the ranks' top-k
    differ. Returns rank 0's results."""
    from matrix_factorization_tpu_torch.parallel.launch import spawn_world, world_device

    device = world_device(device)
    ranks = spawn_world(_rank, n_devices, backend, device, args=(device,))
    first = ranks[0]
    for rk in ranks:
        for tag in ("flat", "overlap", "tiled", "2d", "ials", "bias_als",
                    "bias_sgd", "nmf") + FAMILY_TAGS:
            if not np.isfinite(rk[tag]).all():
                raise AssertionError(f"{tag}: the training history is not finite")
        for tag in ("Q", "ials_Q", "bias_als_b", "bias_sgd_b", "nmf_Q",
                    "svdpp_Y", "svdpp_tiled_Y") + tuple(f"{t}_Q" for t in FAMILY_TAGS):
            if not np.array_equal(rk[tag], first[tag]):
                raise AssertionError(f"the replicas of {tag} differ across ranks")
        for a, b in zip(rk["topk"], first["topk"]):
            if not np.array_equal(a, b):
                raise AssertionError("the ranks' top-k differ")
    if first["topk"][1].max() >= 40:
        raise AssertionError("the top-k named a padding row")
    for rk in ranks:
        if not all(np.isfinite(rk[f"ease_{inv}"]).all() for inv in ("schur", "ns")):
            raise AssertionError("EASE: a rank's rows of B are not finite")
        if np.abs(rk["ease_ns"] - rk["ease_schur"]).max(initial=0.0) > 5e-4:
            raise AssertionError("EASE: Newton-Schulz differs from Schur")
        if not (np.array_equal(rk["sims"], first["sims"])
                and np.array_equal(rk["sim_ids"], first["sim_ids"])):
            raise AssertionError("the ranks' similarity top-k differ")
    if first["sim_ids"].shape != (40, 4):
        raise AssertionError("the similarity top-k has the wrong shape")
    dv, dp = first["dense_topk"]
    if not (np.isfinite(dv).all() and dp.max() < 40 and dv.shape == (1, 5)):
        raise AssertionError("the row-sharded dense top-k is not finite, or "
                             "named a padding row")
    for rk in ranks:
        if not all(np.array_equal(a, b)
                   for a, b in zip(rk["dense_topk"], first["dense_topk"])):
            raise AssertionError("the ranks' dense top-k differ")
    return first


if __name__ == "__main__":
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 2
    res = dryrun_multichip(n, *sys.argv[2:4])
    print(f"dryrun_multichip OK: {n} ranks, epoch rmse flat "
          f"{res['flat'][-1]:.4f}, 2D {res['2d'][-1]:.4f}, ALS "
          f"{res['ials'][-1]:.4f}, bias ALS {res['bias_als'][-1]:.4f}, bias "
          f"SGD {res['bias_sgd'][-1]:.4f}, NMF {res['nmf'][-1]:.4f}, SVD++ "
          f"{res['svdpp'][-1]:.4f} / {res['svdpp_tiled'][-1]:.4f}, BPR loss "
          f"{res['bpr'][-1]:.4f} / {res['bpr_tiled'][-1]:.4f}, top-k ids "
          f"{res['topk'][1][0].tolist()}, EASE rows {res['ease_ns'].shape}, "
          f"item 0's neighbours {res['sim_ids'][0].tolist()}, dense search "
          f"{res['dense_topk'][1][0].tolist()}")
