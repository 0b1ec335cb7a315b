"""Driver of ``ops/ials.py::ials_train_bucketed``, the factor ALS that
``KernelMF(method='als')`` runs on ratings as skewed as MovieLens-25M's
(its ``_als_needs_buckets`` takes the bucketed path there).

Set-up makes the ratings on the device, groups them with the program's
``group_both_sides_bucketed`` (the host pass ``fit`` runs), warms up one
epoch, and runs the check's three epochs (``portbench/training.py``; an
ALS step is an epoch, a user and an item sweep). A unit of the window is
one job: ``epochs_per_job`` epochs from tables made from the seed, waited
for as ``fit`` waits. The window's RMSE pass is off; the check's epochs
run it to read the program's loss, over the ratings as one batch.
"""

from __future__ import annotations

import dataclasses
import time

import torch

from matrix_factorization_tpu_torch.core.config import SGDConfig
from matrix_factorization_tpu_torch.ops import ials
from matrix_factorization_tpu_torch.ops.segment_sgd import RatingBatches
from portbench import training as tr
from portbench.common import Checks
from portbench.reference.als import ALS
from portbench.roofline import als_epoch_work, spd_bound


def _cfg(cell):
    c, m = cell.config, cell.mix
    return SGDConfig(kernel="linear", n_factors=c["n_factors"], reg=m["reg"],
                     min_rating=c["min_rating"], max_rating=c["max_rating"],
                     compute_epoch_rmse=False)


def _train(st, params, epochs: int, cfg, data=None):
    return ials.ials_train_bucketed(params, st["bu"], st["bi"], data, cfg, epochs,
                                    reg_scale=st["cell"].mix["reg_scale"])


def setup(cell) -> dict:
    st = {"cell": cell, "cfg": _cfg(cell)}
    R = tr.make_ratings(cell)
    st["R"] = R
    c = cell.config
    t0 = time.perf_counter()
    st["bu"], st["bi"] = ials.group_both_sides_bucketed(
        R["u_np"], R["i_np"], R["r_np"], c["n_users"], c["n_items"],
        device=cell.device)
    st["setup_parts"] = {"ratings_s": R["seconds"],
                         "buckets_s": time.perf_counter() - t0}
    st["solved"] = sum(int(b.entity_ids.numel()) for b in st["bu"] + st["bi"])
    T = tr.start_tables(cell, tr.WARM_JOB)
    _train(st, tr.to_program(T, R["mu"], st["cfg"]), 1, st["cfg"])
    tr.sync(cell.device)
    _check_steps(st)
    return st


def _check_steps(st) -> None:
    cell, R = st["cell"], st["R"]
    c = cell.config
    cfg = dataclasses.replace(st["cfg"], compute_epoch_rmse=True)
    # the ratings as one batch: what the program's RMSE pass reads
    data = RatingBatches(R["u"][None], R["i"][None], R["r"][None],
                         torch.ones_like(R["r"])[None], R["r"].numel())
    T0 = tr.start_tables(cell, tr.CHECK_JOB)
    params = tr.to_program(T0, R["mu"], cfg)
    losses, step1 = [], None
    for s in range(3):
        params, hist = _train(st, params, 1, cfg, data)
        losses.append(float(hist[0]))
        if s == 0:
            step1 = tr.norms(tr.from_program(params, cfg, c["n_users"], c["n_items"]), T0)
    T3 = tr.from_program(params, cfg, c["n_users"], c["n_items"])
    st["prog"] = {"losses": losses, "step1": step1, "change": tr.norms(T3, T0),
                  "tables": tr.host_copy(T3)}


def unit(st, job: int) -> dict:
    cell = st["cell"]
    E = cell.mix["epochs_per_job"]
    params = tr.to_program(tr.start_tables(cell, job), st["R"]["mu"], st["cfg"])
    _, hist = _train(st, params, E, st["cfg"])
    hist.cpu()
    return {"ratings": E * st["R"]["r"].numel(), "epochs": E}


def end_to_end(st, units, window_s: float) -> dict:
    return {"train_ratings_per_s": sum(u["ratings"] for u in units) / window_s}


def trace_work(st, units) -> dict:
    c = st["cell"].config
    k = c["n_factors"]
    epochs = sum(u["epochs"] for u in units)
    n_users = sum(int(b.entity_ids.numel()) for b in st["bu"])
    n_items = st["solved"] - n_users
    flops, nbytes = als_epoch_work(st["R"]["r"].numel(), n_users, n_items, k)
    # the Gauss-Jordan leaves of one solve at d = k + 1: the Schur
    # recursion splits d at a multiple of 8 near its half, into leaves of
    # at most 128 (``ops/spd.py``)
    d = k + 1
    m = ((d // 2 + 7) // 8) * 8
    leaves = [m, d - m] if d > 128 else [d]
    gj_ms = sum(spd_bound(st["solved"], x)[0] for x in leaves)
    return {"epochs": epochs, "epoch_flops": flops, "epoch_bytes": nbytes,
            "gj_bound_s": epochs * gj_ms / 1e3}


def check(st, control: bool = False) -> Checks:
    """Free the program's state, follow the three epochs with the plain
    reference, or with ``control`` the reference in tf32 (the control),
    and compare."""
    cell, R = st["cell"], st["R"]
    prog = st["prog"]
    precision = "tf32" if control else "f64"
    for key in ("bu", "bi"):
        st.pop(key, None)
    if cell.device == "cuda":
        torch.cuda.empty_cache()
    T0 = tr.start_tables(cell, tr.CHECK_JOB)
    ref = ALS(T0, R["mu"], cell.mix["reg"], precision)
    losses, step1 = [], None
    for s in range(3):
        ref.epoch(R["u"], R["i"], R["r"])
        losses.append(ref.rmse(R["u"], R["i"], R["r"]))
        if s == 0:
            step1 = tr.norms(ref.T, T0)
    out = {"losses": losses, "step1": step1, "change": tr.norms(ref.T, T0),
           "tables": ref.T}
    return tr.compare(prog, out, T0, cell.mix["limits"], Checks())
