#!/usr/bin/env python3
"""Time the ALS SPD solve on one CUDA GPU at the ALS cell's shapes.

    python3 tools/time_spd_solve.py [--out FILE] [--seed N]

Makes ``ml25m-als-linear``'s ratings from the seed (``portbench/gen.py``),
packs them into the count buckets as the cell does and takes the starting
tables of one of its jobs; the systems are those of the normal equations
(``ops/ials.py::normal_equations``, the kernel on the card). At the
cell's 15,625 x 256 user chunk (d = 201) it holds both chains to the
float64 solution (``torch.linalg.solve``):

* ``inverse``: ``ops/spd.py::_inverse_solve``, the solve that every d took
  before the block solve (the Schur-recursion inverse of the scaled
  system, applied by batched matrix-vector products);
* ``block``: ``spd_solve`` as the sweeps call it (``_block_solve``: the
  split, two Gauss-Jordan leaves, two batched products, the back-solve);

checks that two calls of each give the same bits, and times in turns with
``chip_smoke.Timer`` (device time, L2 flushed, 5 readings a median, the
least of two medians) the two chains, the two kernels alone, ``split``
(``mf_spd_split``) and ``backsolve`` (``mf_spd_block_solve``), and their
plain versions, beside each kernel's bytes bound at the card's memory
bandwidth: the split reads the three blocks of A it scales and writes
them and ds; the back-solve reads the four staged blocks (d^2 floats), A,
ds and b and writes x. Last,
one epoch's solves (every chunk of both sides, in the pieces
``ials._solve_entities`` cuts, each system made before its timing) by
both chains, device time by CUDA events, twice in turns, with the
launches of the block solve's kernels.

One JSON line a phase on stdout and in ``--out``. Needs a GPU; imports
nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

CELL = "ml25m-als-linear"
JOB = 0
ENTRIES = ("mf_spd_split", "mf_gj_inverse", "mf_spd_block_solve")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None)
    ap.add_argument("--seed", type=int, default=2500000001)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("time_spd_solve: no CUDA device is available", file=sys.stderr)
        return 1
    from matrix_factorization_tpu_torch.ops import _build, ials, spd
    from matrix_factorization_tpu_torch.ops import cuda_spd_solve as css
    from portbench import common
    from portbench import training as tr
    from portbench.drivers.als import _cfg

    out = open(args.out, "w") if args.out else None

    def emit(obj):
        line = json.dumps(obj)
        print(line, flush=True)
        if out is not None:
            out.write(line + "\n")
            out.flush()

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    secs = _build.build(["spd_gj", "spd_block_solve", "als_normal_eq"])
    emit({"phase": "device", "nvidia_smi": smi, "torch": torch.__version__,
          "build_s": secs,
          "ptxas": cs.ptxas_summary(_build.build_logs.values())})

    cell = common.Cell.load(common.load_manifest(), CELL, args.seed)
    cfg = _cfg(cell)
    c = cell.config
    R = tr.make_ratings(cell)
    bu, bi = ials.group_both_sides_bucketed(
        R["u_np"], R["i_np"], R["r_np"], c["n_users"], c["n_items"], device="cuda")
    params = tr.to_program(tr.start_tables(cell, JOB), R["mu"], cfg)
    reg_scale = cell.mix["reg_scale"]
    k = cfg.n_factors
    d = k + 1
    m = css.split_point(d)
    sides = {"user": (bu, params.item_features), "item": (bi, params.user_features)}

    def systems(side, ids, r, mask):
        return ials.normal_equations(sides[side][1], ids, r, mask, params.global_mean,
                                     cfg, side, "f32", reg_scale)

    def inverse(A, b):
        return spd._inverse_solve(A, b, 32, 1, "auto")

    def block(A, b):
        return spd.spd_solve(A, b)

    # -- the user chunk -----------------------------------------------------
    user = max((b for b in bu if b.other_ids.shape[1] == 256),
               key=lambda b: b.other_ids.shape[0])  # 15,625 x 256
    A, b = systems("user", user.other_ids, user.ratings, user.mask)
    E = A.shape[0]
    exact = torch.linalg.solve(A.double(), b.double())
    scale = float(exact.abs().max())
    row = {"phase": "check", "E": E, "d": d, "m": m}
    for name, fn in (("inverse", inverse), ("block", block)):
        x = fn(A, b)
        row[f"{name}_err"] = float((x.double() - exact).abs().max()) / scale
        row[f"{name}_same_bits"] = bool(torch.equal(fn(A, b), x))
    del exact, x
    torch.cuda.empty_cache()
    emit(row)
    cs.check(row["block_same_bits"] and row["block_err"] <= 1e-5,
             f"the block solve at the user chunk: {row}")

    inv11, A12, invS, W, ds = spd._schur_blocks(A)
    bodies = {
        "inverse": lambda: inverse(A, b),
        "block": lambda: block(A, b),
        "split": lambda: css.cuda_spd_split(A),
        "backsolve": lambda: css.cuda_block_solve(inv11, A12, invS, W, ds, A, b),
        "plain_split": lambda: css.plain_spd_split(A),
        "plain_backsolve": lambda: css.plain_block_solve(inv11, A12, invS, W, ds, A, b),
    }
    timer = cs.Timer(torch)
    times = {n: [] for n in bodies}
    for n in (*bodies, *reversed(bodies)):
        times[n].append(timer.ms(bodies[n], reps=5))
    row = {"phase": "chunk", "shape": "user_chunk_15625x201", "E": E}
    for n, t in times.items():
        row[f"{n}_ms"] = min(t)
        row[f"{n}_medians_ms"] = t
    for n, nbytes in (("split", cs.split_bytes(E, d, m)),
                      ("backsolve", cs.backsolve_bytes(E, d))):
        bound = nbytes / cs.HBM_BYTES_PER_S * 1e3
        row[f"{n}_bound_ms"] = bound
        row[f"{n}_share_of_bound"] = bound / row[f"{n}_ms"]
    emit(row)
    del A, b, inv11, A12, invS, W, ds
    torch.cuda.empty_cache()

    # -- one epoch's solves, as the sweeps call them (no flush) -------------
    pieces = []
    for side, (buckets, _) in sides.items():
        for bk in buckets:
            n_e, L = bk.other_ids.shape
            step = max(1, ials._SOLVE_ELEMS // (d * max(L, d)))
            for s in range(0, n_e, step):
                pieces.append((side, bk, s, s + step))
    row = {"phase": "epoch", "calls": len(pieces),
           "systems": sum(min(hi, bk.other_ids.shape[0]) - lo for _, bk, lo, hi in pieces)}
    row["split_bound_ms"] = cs.split_bytes(row["systems"], d, m) / cs.HBM_BYTES_PER_S * 1e3
    row["backsolve_bound_ms"] = cs.backsolve_bytes(row["systems"], d) / cs.HBM_BYTES_PER_S * 1e3
    for which, fn in (("inverse", inverse), ("block", block), ("block", block),
                      ("inverse", inverse)):
        _build.reset_launches(*ENTRIES)
        total = 0.0
        for side, bk, lo, hi in pieces:
            A, b = systems(side, bk.other_ids[lo:hi], bk.ratings[lo:hi], bk.mask[lo:hi])
            torch.cuda.synchronize()
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            s.record()
            fn(A, b)
            e.record()
            torch.cuda.synchronize()
            total += s.elapsed_time(e)
            del A, b
        row.setdefault(f"{which}_ms", []).append(total)
        row[f"{which}_launches"] = {n: _build.launches(n) for n in ENTRIES}
    emit(row)
    emit({"phase": "done", "nvidia_smi": smi})
    return 0


if __name__ == "__main__":
    sys.exit(main())
