"""What the two training drivers share: the ratings on both sides, the
starting tables, the program's table layout, and the numbers that decide
whether a training run is correct.

**The comparison** (the training rule of the benchmark's contract). Set-up
builds the program's training object (the pack or the buckets on the
device) and drives it from tables made from the seed through its first
three steps, through the call and feed the window times. The plain
reference follows the same three steps from the same tables. Compared,
each by the worst leaf (user factors, user biases, item factors, item
biases):

* ``loss_gap``: each step's training loss (the program's RMSE pass after
  the step, over the step's ratings) against the reference's, as a share
  of the reference's;
* ``step1_norm_gap``: the norm of the first step's update of a leaf
  (``lr`` times the gradient as the SGD step applies it) against the
  reference's, as a share of the reference's norm of that leaf or of the
  median leaf, whichever is larger (SGD only: an ALS step is an exact
  solve, with no gradient);
* ``change_norm_gap``: the same for the change of each leaf after the
  three steps;
* ``table_gap``: the largest entry of ``|program - reference|`` after the
  three steps, as a share of the largest entry of the reference's change
  of that leaf (what the norms cannot see: a delta on the wrong row).

A leaf whose reference update is under a thousandth of the median leaf's
is nought to rounding and is left out of the gaps (none is, at these
settings).
"""

from __future__ import annotations

import time
from typing import Dict

import numpy as np
import torch

from matrix_factorization_tpu_torch.ops.segment_sgd import MFParams
from portbench import gen
from portbench.common import Checks, sub_seed

S_INIT = 20  # stream of a job's starting tables: (S_INIT, job)
S_ORDER = 21  # stream of a job's batch orders
S_CHECK_BATCHES = 23
S_PAIRS = 24
CHECK_JOB = 1 << 30  # the job number of the check's starting tables
WARM_JOB = CHECK_JOB + 1  # and of the warm-up's
LEAVES = ("user_factors", "user_bias", "item_factors", "item_bias")


def sync(device: str) -> None:
    if device == "cuda":
        torch.cuda.synchronize()


def make_ratings(cell) -> dict:
    """The cell's ratings on its device, their host copies (for the
    program's host packs) and their mean."""
    t0 = time.perf_counter()
    u, i, r = gen.ratings(cell.config, cell.seed, cell.device)
    out = {"u": u, "i": i, "r": r}
    out["u_np"], out["i_np"], out["r_np"] = (t.cpu().numpy() for t in (u, i, r))
    # the mean as ``KernelMF.fit`` takes it (float32 numpy over the host
    # ratings)
    out["mu"] = float(np.mean(out["r_np"]))
    out["seconds"] = time.perf_counter() - t0
    return out


def start_tables(cell, job: int) -> Dict[str, torch.Tensor]:
    """The starting tables of a job: N(init_mean, init_sd) f32 factors and
    zero biases, from the seed (the distribution of ``KernelMF``'s
    ``init_params``)."""
    c, mix = cell.config, cell.mix
    g = torch.Generator(device=cell.device).manual_seed(
        sub_seed(cell.seed, S_INIT, job))
    k = c["n_factors"]
    P = torch.randn((c["n_users"], k), generator=g, device=cell.device)
    Q = torch.randn((c["n_items"], k), generator=g, device=cell.device)
    P.mul_(mix["init_sd"]).add_(mix["init_mean"])
    Q.mul_(mix["init_sd"]).add_(mix["init_mean"])
    z = torch.zeros
    return {"user_factors": P, "user_bias": z(c["n_users"], device=cell.device),
            "item_factors": Q, "item_bias": z(c["n_items"], device=cell.device)}


def to_program(T: Dict[str, torch.Tensor], mu: float, cfg):
    """The program's ``MFParams`` holding the tables ``T`` in its
    bias-folded layout (``user_ext = [p, b_u, 1]``, ``item_ext = [q, 1,
    b_i]``, rows padded to ``cfg.padded_factors`` columns and to a multiple
    of 8, the layout of its checkpoints)."""
    k, kp = cfg.n_factors, cfg.padded_factors
    dev = T["user_factors"].device

    def table(F, b, bias_col, const_col):
        n = F.shape[0]
        t = torch.zeros(((n + 7) // 8 * 8, kp), dtype=torch.float32, device=dev)
        t[:n, :k] = F
        t[:n, bias_col] = b
        t[:n, const_col] = 1.0
        return t

    return MFParams(
        user_features=table(T["user_factors"], T["user_bias"], k, k + 1),
        item_features=table(T["item_factors"], T["item_bias"], k + 1, k),
        global_mean=torch.tensor(mu, dtype=torch.float32, device=dev))


def from_program(params, cfg, n_users: int, n_items: int) -> Dict[str, torch.Tensor]:
    """The leaves of the program's tables (views)."""
    k = cfg.n_factors
    U, I = params.user_features, params.item_features
    return {"user_factors": U[:n_users, :k], "user_bias": U[:n_users, k],
            "item_factors": I[:n_items, :k], "item_bias": I[:n_items, k + 1]}


def norms(T: Dict[str, torch.Tensor], T0: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """Per leaf, the float64 norm of ``T - T0``."""
    return {n: float(torch.linalg.vector_norm(T[n].double() - T0[n].double()))
            for n in LEAVES}


def host_copy(T: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {n: T[n].detach().to("cpu", copy=True) for n in LEAVES}


def kept(ref_step1: Dict[str, float]) -> list:
    """The leaves that count: a reference update under a thousandth of the
    median leaf's is rounding (see the module docstring)."""
    med = float(np.median(list(ref_step1.values())))
    return [n for n in LEAVES if ref_step1[n] >= 1e-3 * med]


def norm_gap(prog: Dict[str, float], ref: Dict[str, float], leaves) -> float:
    med = float(np.median([ref[n] for n in LEAVES]))
    return max(abs(prog[n] - ref[n]) / max(ref[n], med, 1e-300) for n in leaves)


def table_gap(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
              T0: Dict[str, torch.Tensor], leaves) -> float:
    out = 0.0
    for n in leaves:
        p, r, t0 = prog[n].double(), ref[n].double(), T0[n].double().to(ref[n].device)
        scale = float((r - t0).abs().max())
        out = max(out, float((p.to(r.device) - r).abs().max()) / max(scale, 1e-300))
    return out


def compare(prog: dict, ref: dict, T0: Dict[str, torch.Tensor], limits: dict,
            checks: Checks) -> Checks:
    """The numbers of the module docstring that ``limits`` names. ``prog``
    and ``ref`` hold ``losses`` (3 floats), ``step1`` and ``change``
    (norms per leaf) and ``tables`` (the leaves after three steps)."""
    leaves = kept(ref["step1"])
    lp, lr = np.asarray(prog["losses"]), np.asarray(ref["losses"])
    if len(lp) != len(lr):
        checks.fail(f"{len(lp)} losses from the program, {len(lr)} expected")
        return checks
    numbers = {
        "loss_gap": lambda: float(np.max(np.abs(lp - lr) / np.abs(lr))),
        "step1_norm_gap": lambda: norm_gap(prog["step1"], ref["step1"], leaves),
        "change_norm_gap": lambda: norm_gap(prog["change"], ref["change"], leaves),
        "table_gap": lambda: table_gap(prog["tables"], ref["tables"], T0, leaves),
    }
    for name, value in numbers.items():
        if name in limits:
            checks.add(name, value(), limits[name])
    return checks
