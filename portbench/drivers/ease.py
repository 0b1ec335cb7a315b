"""Driver of EASE's fit on one card, through the two calls that
``EASE.fit`` makes on one data rank: ``ops/ease.py::gram_pack`` (the host
pack, put on the device) and ``fit_packed`` (the device's gram scan,
inverse and closed form).

Set-up checks the catalog against the program's item budget for the card,
as ``fit`` does first (a program whose budget cannot hold it raises here,
before anything is built), makes the plays on the device
(``gen.ratings``: the configuration's pairs, every weight 1, since the
configuration binarizes) and records the least and most played items,
runs the host pack, then runs the check's fit, whose first call builds
every kernel and shape that the window's fits use (a fit is
deterministic), and serves the check's users from its ``B`` through the
program's serving path (``history_topk_unseen``, whose top-k is the
port's). A unit is
``fits_per_unit`` whole fits on the resident pack, each waited for.

The check frees the program's pack, builds the float64 reference on the
device (``portbench/reference/ease.py``) and compares the check's fit:

* ``b_gap``: the largest ``|B - B_ref|`` over the largest ``|B_ref|``;
* ``score_gap``: over the ``check_users`` users' served lists (their top
  ``k`` unseen items), the largest gap between a served score and the
  reference's score of that item for that user;
* ``rank_gap``: the largest amount by which the j-th served item's
  reference score lies below the reference's j-th best unseen score;
* ``order_faults``: served neighbours out of the tie rule (score
  descending, then item ascending): an exact count, limit 0.

A served item that the user played, or that lies outside the catalog,
fails the run. With ``control`` the reference in its lower precision
(``'tf32'``) is judged in the program's place.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from matrix_factorization_tpu_torch.ops import ease as ease_ops
from portbench import gen
from portbench import training as tr
from portbench.common import Checks, sub_seed
from portbench.reference import ease as ref
from portbench.roofline_ease import fit_work, gram_least_s

S_CHECK_USERS = 40


def _budget(device, plays: int) -> int:
    """The program's item budget of one card for ``plays`` plays: its rule
    for the device where it has one, else its one-rank tier."""
    rule = getattr(ease_ops, "device_item_limit", None)
    return rule(1, device, plays) if rule is not None else ease_ops.item_limit(1)


def setup(cell) -> dict:
    c, m = cell.config, cell.mix
    st = {"cell": cell}
    ease_ops.check_item_budget(c["n_items"], _budget(cell.device, c["n_ratings"]))
    t0 = time.perf_counter()
    u, i, r = gen.ratings(c, cell.seed, cell.device)
    w = torch.ones_like(r) if c["binarize"] else r
    del r
    played = torch.bincount(i.long(), minlength=c["n_items"])
    counts = torch.bincount(u.long(), minlength=c["n_users"]).cpu().numpy()
    st.update(u=u, i=i, w=w, counts=counts, plays=int(u.numel()))
    host = [t.cpu().numpy() for t in (u, i, w)]
    parts = {"plays_s": time.perf_counter() - t0,
             "item_min": int(played.min()), "item_max": int(played.max())}
    t1 = time.perf_counter()
    st["pack"] = ease_ops.gram_pack(*host, c["n_users"], c["n_items"],
                                    device=cell.device)
    tr.sync(cell.device)
    parts["pack_s"] = time.perf_counter() - t1
    parts["int8"] = getattr(st["pack"], "tiles", None) is not None
    del host
    t2 = time.perf_counter()
    B = _fit(st)
    parts["check_fit_s"] = time.perf_counter() - t2
    users = ref.sample_users(c["n_users"], counts, m["check_users"],
                             sub_seed(cell.seed, S_CHECK_USERS))
    vals, idx = _serve(st, B, users)
    st["prog"] = {"B": B, "users": users, "vals": vals, "idx": idx}
    st["setup_parts"] = parts
    return st


def _fit(st) -> torch.Tensor:
    B = ease_ops.fit_packed(st["pack"], st["cell"].config["reg"])
    tr.sync(st["cell"].device)
    return B


def _serve(st, B: torch.Tensor, users: np.ndarray):
    """The program's (vals, idx) host arrays, each (users, k): the users'
    top ``k`` unseen items through ``history_topk_unseen``."""
    c, k = st["cell"].config, st["cell"].mix["k"]
    order, starts, counts = ref.histories(st["u"], st["i"], st["w"], c["n_users"])
    L = max(1, int(counts[torch.from_numpy(users).to(st["u"].device)].max()))
    L = 1 << max(3, (L - 1).bit_length())  # the model's padding (a power of two)
    u_t = torch.from_numpy(users).to(st["u"].device)
    ids, ws = ref.padded(u_t, L, st["i"][order], st["w"][order], starts, counts)
    return ease_ops.history_topk_unseen(B, ids.cpu().numpy().astype(np.int32),
                                        ws.cpu().numpy().astype(np.float32), k,
                                        c["n_items"])


def unit(st, job: int) -> dict:
    n = st["cell"].mix["fits_per_unit"]
    for _ in range(n):
        _fit(st)
    return {"ratings": n * st["plays"], "epochs": n}


def end_to_end(st, units, window_s: float) -> dict:
    return {"train_ratings_per_s": sum(u["ratings"] for u in units) / window_s}


def trace_work(st, units) -> dict:
    c = st["cell"].config
    fits = sum(u["epochs"] for u in units)
    sq = float(np.square(st["counts"].astype(np.float64)).sum())
    flops, nbytes = fit_work(c["n_items"], sq, st["plays"])
    users = int((st["counts"] > 0).sum())
    return {"epochs": fits, "epoch_flops": flops, "epoch_bytes": nbytes,
            "ease_gram_bound_s": fits * gram_least_s(users, c["n_items"])}


def _free(st) -> None:
    st.pop("pack", None)
    gc.collect()
    if st["cell"].device == "cuda":
        torch.cuda.empty_cache()


def reference(st, precision: str = "f64") -> torch.Tensor:
    """The reference's ``B`` (n_items, n_items) from the plays."""
    c = st["cell"].config
    return ref.weights(ref.gram(st["u"], st["i"], st["w"], c["n_users"], c["n_items"],
                                precision), c["reg"], precision)


def judge(st, B: torch.Tensor, users: np.ndarray, vals, idx, B_ref: torch.Tensor,
          checks: Checks) -> Checks:
    """The four numbers of the module docstring for a fitted ``B`` and the
    (users, k) lists served from it."""
    c, m = st["cell"].config, st["cell"].mix
    limits, k, n = m["limits"], m["k"], c["n_items"]
    dev = B_ref.device
    vals = torch.as_tensor(vals).to(dev, torch.float64)
    idx = torch.as_tensor(idx).to(dev, torch.int64)
    if tuple(idx.shape) != (len(users), k) or tuple(vals.shape) != (len(users), k):
        checks.fail(f"lists of shape {tuple(idx.shape)} for {len(users)} users at k={k}")
        return checks
    if bool(((idx < 0) | (idx >= n)).any()):
        checks.fail("a served item lies outside the catalog")
        return checks
    X = ref.history_block(torch.from_numpy(users).to(dev), st["u"], st["i"], st["w"],
                          c["n_users"], n)
    if bool((X.gather(1, idx) != 0).any()):
        checks.fail("a served item was already played")
        return checks
    gap, top = ref.max_abs_gap(B, B_ref)
    s = ref.scores(X, B_ref)
    s.masked_fill_(X != 0, float("-inf"))
    best = torch.topk(s, k, dim=1).values
    exact = s.gather(1, idx)
    checks.add("b_gap", gap / max(top, 1e-300), limits["b_gap"])
    checks.add("score_gap", float((vals - exact).abs().max()), limits["score_gap"])
    checks.add("rank_gap", float((best - exact).max().clamp(min=0)), limits["rank_gap"])
    v, p = vals[:, :-1], vals[:, 1:]
    faults = (v < p) | ((v == p) & (idx[:, :-1] >= idx[:, 1:]))
    checks.add("order_faults", int(faults.sum()), limits["order_faults"])
    return checks


def check(st, control: bool = False) -> Checks:
    """Free the program's pack, build the reference and judge the check's
    fit, or with ``control`` the reference in TF32 (the control)."""
    prog = st["prog"]
    _free(st)
    users = prog["users"]
    if control:
        B = reference(st, "tf32")
        X = ref.history_block(torch.from_numpy(users).to(B.device), st["u"], st["i"],
                              st["w"], st["cell"].config["n_users"],
                              st["cell"].config["n_items"], B.dtype)
        vals, idx = ref.serve(X, B, st["cell"].mix["k"])
        del X
    else:
        B, vals, idx = prog["B"], prog["vals"], prog["idx"]
    B_ref = reference(st, "f64")
    return judge(st, B, users, vals, idx, B_ref, Checks())
