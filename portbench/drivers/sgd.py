"""Driver of ``ops/segment_sgd.py::sgd_train``, the SGD loop that
``KernelMF.fit`` runs after its pack.

Set-up makes the ratings on the device, packs them once with the
program's ``pack_ratings`` (the host pack ``fit`` runs), warms up one
epoch, and runs the check's three steps (``portbench/training.py``). A
unit of the window is one job: ``epochs_per_job`` epochs of
``sgd_train`` from tables made from the seed, with the batch orders drawn
from a seeded CPU generator as ``fit`` draws them, waited for as ``fit``
waits (its history comes to the host). The window's RMSE pass is off, as
in the repository's config-3 benchmark; the check's steps run it to read
the program's loss.
"""

from __future__ import annotations

import dataclasses
import time

import torch

from matrix_factorization_tpu_torch.core.config import SGDConfig
from matrix_factorization_tpu_torch.ops import segment_sgd as sgd
from portbench import training as tr
from portbench.common import Checks, sub_seed
from portbench.reference.sgd import SGD, batch_entries
from portbench.roofline import sgd_bounds, sgd_epoch_work

PAIRS = 1 << 16  # unseen (user, item) pairs whose predictions are compared


def _cfg(cell):
    c, m = cell.config, cell.mix
    return SGDConfig(kernel=m["kernel"], n_factors=c["n_factors"], lr=m["lr"],
                     reg=m["reg"], gamma=m["gamma"], min_rating=c["min_rating"],
                     max_rating=c["max_rating"], batch_size=m["batch_size"],
                     shuffle=m["shuffle"], compute_epoch_rmse=False)


def _one_batch(data, k):
    """Batch ``k`` of the pack as a pack of its own (views)."""
    sl = slice(k, k + 1)
    n_real = int(data.weights[k].sum())
    return dataclasses.replace(
        data, user_ids=data.user_ids[sl], item_ids=data.item_ids[sl],
        ratings=data.ratings[sl], weights=data.weights[sl], n_real=n_real,
        sec_ids_sorted=data.sec_ids_sorted[sl], sec_perm=data.sec_perm[sl])


def _orders(cell, job: int, nb: int, epochs: int):
    g = torch.Generator().manual_seed(sub_seed(cell.seed, tr.S_ORDER, job))
    return [torch.randperm(nb, generator=g) for _ in range(epochs)]


def setup(cell) -> dict:
    st = {"cell": cell, "cfg": _cfg(cell)}
    R = tr.make_ratings(cell)
    st["R"] = R
    t0 = time.perf_counter()
    # the pack's shuffle is the mix's (``fit`` packs with seed 0), so every
    # run seed gets the same batches; the seed orders them
    st["shuffle_seed"] = cell.mix["pack_shuffle_seed"]
    data = sgd.pack_ratings(R["u_np"], R["i_np"], R["r_np"],
                            cell.mix["batch_size"],
                            shuffle_seed=st["shuffle_seed"],
                            order=cell.mix["epoch_order"], device=cell.device)
    st["setup_parts"] = {"ratings_s": R["seconds"],
                         "pack_s": time.perf_counter() - t0}
    st["data"] = data
    # per batch: entries, distinct users and items (the necessary work),
    # and the primary and secondary runs the kernels walk
    prim = data.item_ids if data.primary == "item" else data.user_ids
    rp = [int(torch.unique_consecutive(prim[k]).numel()) for k in range(data.n_batches)]
    rs = [int(torch.unique_consecutive(data.sec_ids_sorted[k]).numel())
          for k in range(data.n_batches)]
    n_b = [int(data.weights[k].sum()) for k in range(data.n_batches)]
    users, items = (rs, rp) if data.primary == "item" else (rp, rs)
    st["batches"] = list(zip(n_b, users, items))
    st["runs"] = list(zip(rp, rs))
    # warm-up: one epoch of every shape the window uses
    T = tr.start_tables(cell, tr.WARM_JOB)
    sgd.sgd_train(tr.to_program(T, R["mu"], st["cfg"]), data, None, st["cfg"], 1,
                  cell.mix["lr"], batch_orders=_orders(cell, tr.WARM_JOB, data.n_batches, 1))
    tr.sync(cell.device)
    _check_steps(st)
    return st


def _check_steps(st) -> None:
    """The program's three check steps, through ``sgd_train`` on three
    distinct batches of the pack, each as a pack of its own; keeps the
    readings and frees the tables."""
    cell, data = st["cell"], st["data"]
    c = cell.config
    cfg = dataclasses.replace(st["cfg"], compute_epoch_rmse=True)
    g = torch.Generator().manual_seed(sub_seed(cell.seed, tr.S_CHECK_BATCHES))
    ks = torch.randperm(data.n_batches, generator=g)[:3].tolist()
    T0 = tr.start_tables(cell, tr.CHECK_JOB)
    params = tr.to_program(T0, st["R"]["mu"], cfg)
    losses, step1 = [], None
    for s, k in enumerate(ks):
        params, hist = sgd.sgd_train(params, _one_batch(data, k), None, cfg, 1,
                                     cell.mix["lr"], batch_orders=[[0]])
        losses.append(float(hist[0]))
        if s == 0:
            step1 = tr.norms(tr.from_program(params, cfg, c["n_users"], c["n_items"]), T0)
    T3 = tr.from_program(params, cfg, c["n_users"], c["n_items"])
    gp = torch.Generator(device=cell.device).manual_seed(sub_seed(cell.seed, tr.S_PAIRS))
    pu = torch.randint(0, c["n_users"], (PAIRS,), generator=gp, device=cell.device)
    pi = torch.randint(0, c["n_items"], (PAIRS,), generator=gp, device=cell.device)
    pred, _ = sgd.predict_pairs(params, pu.int(), pi.int(), cfg)
    st["prog"] = {"losses": losses, "step1": step1, "change": tr.norms(T3, T0),
                  "tables": tr.host_copy(T3), "pred": pred.cpu()}
    st["check"] = {"batches": ks, "pairs": (pu.cpu(), pi.cpu())}


def unit(st, job: int) -> dict:
    cell, data = st["cell"], st["data"]
    E = cell.mix["epochs_per_job"]
    params = tr.to_program(tr.start_tables(cell, job), st["R"]["mu"], st["cfg"])
    _, hist = sgd.sgd_train(params, data, None, st["cfg"], E, cell.mix["lr"],
                            batch_orders=_orders(cell, job, data.n_batches, E))
    hist.cpu()  # ``fit`` brings the history to the host: the job is done
    return {"ratings": E * data.n_real, "epochs": E}


def end_to_end(st, units, window_s: float) -> dict:
    return {"train_ratings_per_s": sum(u["ratings"] for u in units) / window_s}


def trace_work(st, units) -> dict:
    k = st["cell"].config["n_factors"]
    kp = st["cfg"].padded_factors
    epochs = sum(u["epochs"] for u in units)
    flops, nbytes = sgd_epoch_work(st["batches"], k)
    step_ms = apply_ms = 0.0
    for (n, _, _), (rp, rs) in zip(st["batches"], st["runs"]):
        b = sgd_bounds(st["data"].batch_size, kp, rp, rs)
        step_ms += b["sgd_step"][0]
        apply_ms += b["segment_apply"][0]
    return {"epochs": epochs, "epoch_flops": flops, "epoch_bytes": nbytes,
            "sgd_step_bound_s": epochs * step_ms / 1e3,
            "sgd_apply_bound_s": epochs * apply_ms / 1e3}


def check(st, control: bool = False) -> Checks:
    """Free the program's state, follow the three steps with the plain
    reference, or with ``control`` the reference in bf16 (the control),
    and compare."""
    cell = st["cell"]
    c, m = cell.config, cell.mix
    prog = st["prog"]
    precision = "bf16" if control else "f64"
    st.pop("data", None)
    if cell.device == "cuda":
        torch.cuda.empty_cache()
    R = st["R"]
    T0 = tr.start_tables(cell, tr.CHECK_JOB)
    ref = SGD(T0, R["mu"], m["kernel"], m["lr"], m["reg"], c["min_rating"],
              c["max_rating"], precision)
    entries = batch_entries(len(R["r_np"]), m["batch_size"], st["shuffle_seed"])
    losses, step1 = [], None
    for s, k in enumerate(st["check"]["batches"]):
        ix = torch.from_numpy(entries[k]).to(cell.device)
        u, i, r = R["u"][ix].long(), R["i"][ix].long(), R["r"][ix]
        ref.step(u, i, r)
        losses.append(ref.rmse(u, i, r))
        if s == 0:
            step1 = tr.norms(ref.T, T0)
    pu, pi = (t.to(cell.device).long() for t in st["check"]["pairs"])
    ref_pred, _ = ref.predict(pu, pi)
    ref_pred = ref_pred.clamp(c["min_rating"], c["max_rating"])
    out = {"losses": losses, "step1": step1, "change": tr.norms(ref.T, T0),
           "tables": ref.T}
    checks = tr.compare(prog, out, T0, m["limits"], Checks())
    checks.add("pred_gap", float((prog["pred"].to(cell.device).double()
                                  - ref_pred.double()).abs().max()),
               m["limits"]["pred_gap"])
    return checks
