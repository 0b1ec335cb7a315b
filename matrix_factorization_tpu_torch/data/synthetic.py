"""Synthetic rating data with known low-rank structure (a copy of
``matrix_factorization_tpu/data/synthetic.py``: the same seed gives equal
frames).

Used by the test suite (convergence fixtures with analytically known
structure) and by ``bench.py`` (MovieLens-shaped workloads at arbitrary
scale, no download needed).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import pandas as pd


def lowrank_ratings(
    n_users: int = 200,
    n_items: int = 120,
    n_factors: int = 4,
    density: float = 0.3,
    noise_sd: float = 0.05,
    min_rating: float = 0.0,
    max_rating: float = 5.0,
    seed: int = 0,
) -> Tuple[pd.DataFrame, pd.Series]:
    """Ratings sampled from mu + b_u + b_i + <p_u, q_i> plus noise,
    clipped to the rating range. Returns (X[user_id,item_id], y)."""
    rng = np.random.default_rng(seed)
    mu = (min_rating + max_rating) / 2
    bu = rng.normal(0, 0.3, n_users)
    bi = rng.normal(0, 0.3, n_items)
    P = rng.normal(0, 0.5 / np.sqrt(n_factors), (n_users, n_factors))
    Q = rng.normal(0, 0.5 / np.sqrt(n_factors), (n_items, n_factors))

    n_total = n_users * n_items
    n_obs = max(1, int(density * n_total))
    flat = rng.choice(n_total, size=n_obs, replace=False)
    u, i = flat // n_items, flat % n_items
    r = mu + bu[u] + bi[i] + np.einsum("nf,nf->n", P[u], Q[i])
    r = np.clip(r + rng.normal(0, noise_sd, n_obs), min_rating, max_rating)

    X = pd.DataFrame({"user_id": u.astype(np.int64), "item_id": i.astype(np.int64)})
    return X, pd.Series(r, name="rating")


def movielens_shaped(
    n_users: int = 943,
    n_items: int = 1682,
    n_ratings: int = 100_000,
    seed: int = 0,
) -> Tuple[pd.DataFrame, pd.Series]:
    """A MovieLens-100K-shaped workload: power-law-ish popularity, ratings
    in {0.5 .. 5.0}. Not the real dataset — the shape for benchmarking."""
    if n_ratings > n_users * n_items:
        raise ValueError("n_ratings exceeds the number of possible pairs")
    rng = np.random.default_rng(seed)
    # mild power-law popularity/activity; keeps enough pair diversity that
    # vectorized oversample+dedup converges in a few rounds
    item_pop = (np.arange(1, n_items + 1, dtype=np.float64)) ** -0.8
    item_pop /= item_pop.sum()
    user_act = (np.arange(1, n_users + 1, dtype=np.float64)) ** -0.8
    user_act /= user_act.sum()

    chosen = np.empty(0, np.int64)
    for _ in range(64):
        need = n_ratings - len(chosen)
        if need <= 0:
            break
        m = max(1024, 2 * need)
        uu = rng.choice(n_users, size=m, p=user_act)
        ii = rng.choice(n_items, size=m, p=item_pop)
        chosen = np.unique(np.concatenate([chosen, uu.astype(np.int64) * n_items + ii]))
    if len(chosen) < n_ratings:  # tail fill: uniform over the complement
        all_pairs = np.setdiff1d(
            rng.permutation(n_users * n_items).astype(np.int64), chosen,
            assume_unique=False,
        )
        chosen = np.concatenate([chosen, all_pairs[: n_ratings - len(chosen)]])
    chosen = rng.permutation(chosen)[:n_ratings]
    u = (chosen // n_items).astype(np.int64)
    i = (chosen % n_items).astype(np.int64)
    base = 3.5 + 0.4 * rng.standard_normal(n_users)[u] + 0.4 * rng.standard_normal(n_items)[i]
    r = np.clip(np.round(2 * (base + 0.5 * rng.standard_normal(n_ratings))) / 2, 0.5, 5.0)
    X = pd.DataFrame({"user_id": u, "item_id": i})
    return X, pd.Series(r, name="rating")


def clustered_interactions(
    n_users: int = 500,
    n_items: int = 400,
    n_clusters: int = 8,
    per_user: int = 20,
    in_cluster: float = 0.85,
    seed: int = 0,
) -> Tuple[pd.DataFrame, pd.Series]:
    """Implicit interactions with genuine item-item co-occurrence: users
    and items belong to latent clusters and each user draws ``per_user``
    distinct items, ``in_cluster`` of them from their own cluster.

    ``movielens_shaped`` samples user and item marginals INDEPENDENTLY,
    so raw popularity is its Bayes-optimal ranker — useless for judging
    neighborhood/co-occurrence models (EASE, item CF).  This fixture is
    the complement: popularity carries almost nothing, co-occurrence
    carries everything.  Returns (X, y) with y = 1.0 weights.
    """
    rng = np.random.default_rng(seed)
    per_user = min(per_user, n_items)  # distinct items per user
    item_cluster = rng.integers(0, n_clusters, n_items)
    cluster_items = [np.flatnonzero(item_cluster == c) for c in range(n_clusters)]
    user_cluster = rng.integers(0, n_clusters, n_users)
    us, its = [], []
    for u in range(n_users):
        own = cluster_items[user_cluster[u]]
        n_in = min(int(round(per_user * in_cluster)), len(own))
        picks = set(rng.choice(own, size=n_in, replace=False).tolist())
        while len(picks) < per_user:
            picks.add(int(rng.integers(n_items)))
        its.extend(sorted(picks))
        us.extend([u] * len(picks))
    X = pd.DataFrame({
        "user_id": np.asarray(us, np.int64),
        "item_id": np.asarray(its, np.int64),
    })
    return X, pd.Series(np.ones(len(X), np.float32), name="rating")
