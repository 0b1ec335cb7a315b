"""The one generator of the benchmark's inputs, made on the device from
the run's seed and the parameters of a configuration and a traffic mix.

**Ratings shaped like MovieLens-25M** (``ratings``). Which (user, item)
pairs are rated is the configuration's, the same for every run seed (made
from the configuration's ``pairs_seed``), so that every seed gives the
program the same work: each user's number of ratings follows a
log-normal law over the users' ranks, floored at the minimum
(``min_per_user``) and with the heaviest user at ``max_per_user``, its
scale solved so that the counts add up to ``n_ratings`` exactly; each
user's items are a draw without replacement from a Zipf popularity over
the items (``item_zipf``; the Gumbel top-k trick: the largest
``log w + Gumbel`` keys), so no pair repeats; seeded permutations say
which user id holds which count and which item id which popularity rank.
The run's seed draws the ratings, half stars from ``rating_shares``.

**A dense catalog and its queries** (``catalog``, ``queries``): unit f32
rows from normal draws; each query is a catalog row picked by a Zipf
popularity over the rows (``query_zipf``), plus normal noise of
``query_noise`` a coordinate, renormalised.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from portbench.common import sub_seed

# streams of the run's seed
S_USERS, S_ITEMS, S_KEYS, S_STARS, S_CATALOG, S_QUERY_ROWS, S_QUERY_NOISE = range(7)


def _gen(device, seed: int, stream: int, *more: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, stream, *more))


def user_counts(n_users: int, n_ratings: int, min_per_user: int,
                max_per_user: int) -> np.ndarray:
    """(n_users,) int64 ratings per user rank, heaviest first, summing to
    ``n_ratings``: ``min + floor(exp(mu + sigma z_r))`` with z_r the
    normal quantile of rank r, ``mu`` set so that rank 0 gets
    ``max_per_user`` and ``sigma`` solved by bisection; the few ratings
    that the floor leaves over go one each to the heaviest users."""
    q = 1.0 - (np.arange(n_users, dtype=np.float64) + 0.5) / n_users
    z = torch.special.ndtri(torch.from_numpy(q)).numpy()
    span = float(max_per_user - min_per_user)

    def counts(s: float) -> np.ndarray:
        mu = np.log(span) - s * z[0]
        return min_per_user + np.floor(np.exp(mu + s * z)).astype(np.int64)

    lo, hi = 1e-3, 10.0  # the sum falls as sigma grows
    for _ in range(100):
        mid = (lo + hi) / 2
        lo, hi = (mid, hi) if counts(mid).sum() > n_ratings else (lo, mid)
    c = counts(hi)
    rest = n_ratings - int(c.sum())
    if rest < 0 or rest > n_users:
        raise ValueError(f"the count law cannot hold {n_ratings} ratings")
    c[:rest] += 1
    return c


def ratings(cfg: dict, seed: int, device) -> Tuple[torch.Tensor, torch.Tensor,
                                                    torch.Tensor]:
    """(user ids int32, item ids int32, ratings f32) on ``device``, grouped
    by user (users in order of their count); the ratings from ``seed``.
    See the module docstring."""
    n_users, n_items = cfg["n_users"], cfg["n_items"]
    g = cfg["generator"]
    counts = user_counts(n_users, cfg["n_ratings"], g["min_per_user"],
                         g["max_per_user"])
    if counts[0] > n_items:
        raise ValueError("a user cannot rate more items than there are")
    pairs = g["pairs_seed"]
    uid = torch.randperm(n_users, generator=_gen("cpu", pairs, S_USERS))
    iperm = torch.randperm(n_items, generator=_gen(device, pairs, S_ITEMS),
                           device=device)
    logw = -g["item_zipf"] * torch.log(
        torch.arange(1, n_items + 1, dtype=torch.float32, device=device))
    keys_g = _gen(device, pairs, S_KEYS)
    rows = max(1, g.get("key_block", 1 << 28) // n_items)
    us, its = [], []
    c_dev = torch.from_numpy(counts).to(device)
    for lo in range(0, n_users, rows):
        hi = min(n_users, lo + rows)
        kmax = int(counts[lo])
        key = torch.rand((hi - lo, n_items), generator=keys_g, device=device)
        key.clamp_(min=1e-30).log_().neg_().log_().neg_().add_(logw)  # Gumbel
        top = torch.topk(key, kmax, dim=1, sorted=True).indices
        del key
        keep = torch.arange(kmax, device=device)[None, :] < c_dev[lo:hi, None]
        its.append(iperm[top[keep]].to(torch.int32))
        rank = torch.arange(lo, hi, device=device)[:, None].expand(-1, kmax)
        us.append(rank[keep])
        del top, keep, rank
    u = uid.to(device)[torch.cat(us)].to(torch.int32)
    i = torch.cat(its)
    shares = torch.tensor(g["rating_shares"], dtype=torch.float64, device=device)
    stars = torch.multinomial(shares, u.numel(), replacement=True,
                              generator=_gen(device, seed, S_STARS))
    r = (stars.to(torch.float32) + 1.0) * 0.5
    return u, i, r


def catalog(cfg: dict, seed: int, device) -> torch.Tensor:
    """(n_items, dim) f32 unit rows on ``device``."""
    emb = torch.randn((cfg["n_items"], cfg["dim"]), generator=_gen(
        device, seed, S_CATALOG), device=device)
    emb /= torch.linalg.vector_norm(emb, dim=1, keepdim=True)
    return emb


def queries(emb: torch.Tensor, n: int, mix: dict, seed: int) -> torch.Tensor:
    """(n, dim) f32 unit queries on ``emb``'s device: a catalog row drawn
    by Zipf popularity over a seeded order of the rows, plus noise."""
    N, dim = emb.shape
    dev = emb.device
    # Zipf over ranks by inverse transform of a uniform draw on the CDF
    w = torch.arange(1, N + 1, dtype=torch.float64, device=dev).pow_(
        -mix["query_zipf"])
    cdf = torch.cumsum(w, 0)
    cdf /= cdf[-1].clone()
    g = _gen(dev, seed, S_QUERY_ROWS)
    rank = torch.searchsorted(cdf, torch.rand(n, generator=g, device=dev,
                                              dtype=torch.float64))
    rank.clamp_(max=N - 1)
    order = torch.randperm(N, generator=g, device=dev)
    q = emb[order[rank]] + mix["query_noise"] * torch.randn(
        (n, dim), generator=_gen(dev, seed, S_QUERY_NOISE), device=dev)
    return q / torch.linalg.vector_norm(q, dim=1, keepdim=True)
