#!/usr/bin/env python3
"""Time the ALS normal equations on one CUDA GPU at the ALS cell's shapes.

    python3 tools/time_normal_eq.py [--out FILE] [--seed N]

Makes ``ml25m-als-linear``'s ratings from the seed (``portbench/gen.py``),
packs them into the count buckets as the cell does
(``ops/ials.py::group_both_sides_bucketed``) and takes the starting
tables of one of its jobs. Then, at the cell's 15,625 x 256 user chunk and
at its longest item chunk (the split into slices), it holds the kernel
(``ops/ials.py::normal_equations`` on the card, ``ops/cuda_normal_eq.py``)
and the plain body (``plain_normal_equations``: the (E, L, d) design
gather, the mask, one batched product and the right-hand sides) to the
plain body in float64: the kernel no less accurate than the plain body
(its largest error at most twice the plain body's, plus 1e-7 of the
largest entry); checks that two calls give the same bits, and times in turns with ``chip_smoke.Timer`` (device time, L2 flushed):

* ``kernel``: the kernel call, its ridge values included;
* ``plain``: the plain body;
* ``library``: the batched product alone (``torch.bmm`` of the masked
  design block, made before the timing), the one library call inside
  the plain body;

beside the chunk's bound: the larger of the upper triangle of each live
row's augmented products, (d + 1)(d + 2) / 2 FMAs, at the card's f32
peak, and the bytes (each live row's k + 2 columns read, the slots read,
A and b written) at its memory bandwidth. Last, one epoch's normal
equations (every chunk of both sides, as a sweep calls them) by the
kernel and by the plain body, device time by CUDA events.

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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None)
    ap.add_argument("--seed", type=int, default=2300000001)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("time_normal_eq: no CUDA device is available", file=sys.stderr)
        return 1
    from matrix_factorization_tpu_torch.ops import _build, cuda_normal_eq, ials
    from matrix_factorization_tpu_torch.ops.segment_sgd import bias_col, const_col
    from matrix_factorization_tpu_torch.ops.spd import exact_f32
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
    secs = _build.build(["als_normal_eq"])
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
    sides = {"user": (bu, params.item_features), "item": (bi, params.user_features)}
    emit({"phase": "pack", "ratings_s": R["seconds"],
          "chunks": {s: [list(b.other_ids.shape) for b in v[0]] for s, v in sides.items()}})

    def calls(side, b):
        other = sides[side][1]
        o_side = "item" if side == "user" else "user"
        o_bias, o_const = bias_col(cfg, o_side), const_col(cfg, o_side)
        mu = params.global_mean

        def kernel():
            return ials.normal_equations(other, b.other_ids, b.ratings, b.mask, mu,
                                         cfg, side, "f32", reg_scale)

        def plain():
            return ials.plain_normal_equations(other, b.other_ids, b.ratings, b.mask,
                                               mu, k, o_bias, o_const, cfg.reg, "f32",
                                               reg_scale)

        return kernel, plain

    timer = cs.Timer(torch)
    user = max((b for b in bu if b.other_ids.shape[1] == 256),
               key=lambda b: b.other_ids.shape[0])  # 15,625 x 256
    longest = max(bi, key=lambda b: b.other_ids.shape[1])
    for name, side, b in (("user_chunk_15625x256", "user", user),
                          ("item_chunk_longest", "item", longest)):
        kernel, plain = calls(side, b)
        E, L = b.other_ids.shape
        live = int(b.mask.count_nonzero())
        A, rhs = kernel()
        wA, wb = plain()
        A2, rhs2 = kernel()
        same = bool(torch.equal(A, A2) and torch.equal(rhs, rhs2))
        del A2, rhs2
        # both against the plain body in float64, as shares of its largest entry
        other = sides[side][1]
        o_side = "item" if side == "user" else "user"
        tA, tb = ials.plain_normal_equations(
            other.double(), b.other_ids, b.ratings.double(), b.mask.double(),
            params.global_mean.double(), k, bias_col(cfg, o_side),
            const_col(cfg, o_side), cfg.reg, "f32", reg_scale)
        err = {}
        for who, (x, y) in (("kernel", (A, rhs)), ("plain", (wA, wb))):
            err[f"{who}_err_A"] = float((x.double() - tA).abs().max() / tA.abs().max())
            err[f"{who}_err_b"] = float((y.double() - tb).abs().max() / tb.abs().max())
        del A, rhs, wA, wb, tA, tb
        torch.cuda.empty_cache()
        # no less accurate than the plain body (within rounding), the same bits twice
        ok = same and all(err[f"kernel_err_{x}"] <= 2 * err[f"plain_err_{x}"] + 1e-7
                          for x in "Ab")
        cs.check(ok, f"{name}: kernel {err}, same bits {same}")
        o_const = const_col(cfg, o_side)
        design = torch.cat([other[:, :k], other[:, o_const:o_const + 1]], dim=1)
        Xm = design[b.other_ids.long()].mul_(b.mask[..., None])

        def library():
            with exact_f32():
                return torch.bmm(Xm.transpose(1, 2), Xm)

        bodies = {"kernel": kernel, "plain": plain, "library": library}
        times = {n: [] for n in bodies}
        for n in (*bodies, *reversed(bodies)):
            times[n].append(timer.ms(bodies[n], reps=5))
        flops, nbytes = cs.normal_eq_work(k, E, L, live)
        bound = max(flops / cs.PEAK_FLOPS["float32"], nbytes / cs.HBM_BYTES_PER_S) * 1e3
        row = {"phase": "chunk", "shape": name, "E": E, "L": L, "live_rows": live,
               "slices": cuda_normal_eq.normal_eq_plan(k + 1, L).slices,
               **err, "same_bits": same,
               "bound_ms": bound,
               "bound_by": "operations" if flops / cs.PEAK_FLOPS["float32"]
               > nbytes / cs.HBM_BYTES_PER_S else "bytes"}
        for n, t in times.items():
            row[f"{n}_ms"] = min(t)
        row["kernel_share_of_bound"] = bound / row["kernel_ms"]
        emit(row)
        del Xm, design
        torch.cuda.empty_cache()

    # one epoch's normal equations, as the sweeps call them (no flush)
    epoch = [calls(side, b) for side in sides for b in sides[side][0]]
    live = sum(int(b.mask.count_nonzero()) for side in sides for b in sides[side][0])
    flops = sum(cs.normal_eq_work(k, *b.other_ids.shape, int(b.mask.count_nonzero()))[0]
                for side in sides for b in sides[side][0])
    row = {"phase": "epoch", "chunks": len(epoch), "live_rows": live,
           "bound_ops_ms": flops / cs.PEAK_FLOPS["float32"] * 1e3}
    for which, idx in (("kernel", 0), ("plain", 1), ("kernel", 0), ("plain", 1)):
        torch.cuda.synchronize()
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        for pair in epoch:
            pair[idx]()
        e.record()
        torch.cuda.synchronize()
        row.setdefault(f"{which}_ms", []).append(s.elapsed_time(e))
    emit(row)
    emit({"phase": "done", "nvidia_smi": smi})
    return 0


if __name__ == "__main__":
    sys.exit(main())
