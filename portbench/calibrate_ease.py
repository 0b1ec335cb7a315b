"""Readings that the limits of an EASE cell's check are set from, in one
process. The benchmark's own runs never run this.

    python3 portbench/calibrate_ease.py --workload msd-ease-fit --seed <n> \\
        --user-seeds 1,2,... [--control-seeds ...] [--faults chunk,lam] \\
        [--fault-seeds ...] [--out chiprun_out/calibrate_ease.jsonl]

The cell's plays do not depend on the run's seed (the pairs are the
configuration's and every weight is 1), so one set-up, one check fit and
one float64 reference serve every reading, and a user seed draws the
check's users (as the run's seed does). Readings, judged as the cell's
check judges (``drivers/ease.py::judge``):

* ``program``: the check's fit and its lists, for each user seed (the
  lower reading);
* ``control``: the reference in TF32 (``reference/ease.py``, precision
  ``'tf32'``), its ``B`` and its lists, for each control seed;
* ``fault:chunk``: a fit of the program with the first user chunk's
  weights zeroed in its pack (a chunk dropped from the gram);
  ``fault:lam``: a fit of the program at 1.01 times the cell's lambda; for
  each fault seed.

One JSON line a reading, on standard output and in ``--out``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import common  # noqa: E402
from portbench.common import Cell, Checks, sub_seed  # noqa: E402


def _faulty_fit(st, name: str):
    from matrix_factorization_tpu_torch.ops import ease as ease_ops

    pack, lam = st["pack"], st["cell"].config["reg"]
    if name == "chunk":
        ww = pack.ww.clone()
        ww[pack.bounds[0]:pack.bounds[1]] = 0.0
        return ease_ops.fit_packed(pack._replace(ww=ww), lam)
    if name == "lam":
        return ease_ops.fit_packed(pack, 1.01 * lam)
    raise ValueError(f"no fault {name!r}")


def readings(manifest, name: str, seed: int, user_seeds, control_seeds=(),
             faults=(), fault_seeds=(), device: str = "cuda", cell=None) -> list:
    """The readings of the module docstring, as dicts. ``cell`` may be
    given in place of the manifest's (the tests cut it to the CPU)."""
    import torch

    from portbench.reference import ease as ref

    cell = cell or Cell.load(manifest, name, seed, device)
    d = common.load_module(common.driver_path(cell.mix["driver"]),
                           f"portbench_driver_{cell.mix['driver']}")
    t0 = time.perf_counter()
    st = d.setup(cell)
    setup_s = time.perf_counter() - t0
    c, m = cell.config, cell.mix

    def users_of(s):
        return ref.sample_users(c["n_users"], st["counts"], m["check_users"],
                                sub_seed(s, d.S_CHECK_USERS))

    judged = []  # (kind, user seed, B on the host, vals, idx)

    def keep(kind, B, seeds, serve):
        for s in seeds:
            vals, idx = serve(B, users_of(s))
            judged.append((kind, s, vals, idx))
        return B.cpu()

    Bs = {}
    for f in faults:
        Bs[f"fault:{f}"] = keep(f"fault:{f}", _faulty_fit(st, f), fault_seeds,
                                lambda B, u: d._serve(st, B, u))
    Bs["program"] = keep("program", st["prog"].pop("B"), user_seeds,
                         lambda B, u: d._serve(st, B, u))
    d._free(st)
    if control_seeds:
        def serve_ctl(B, u):
            X = ref.history_block(torch.from_numpy(u).to(B.device), st["u"], st["i"],
                                  st["w"], c["n_users"], c["n_items"], B.dtype)
            return ref.serve(X, B, m["k"])

        Bs["control"] = keep("control", d.reference(st, "tf32"), control_seeds, serve_ctl)
    t1 = time.perf_counter()
    B_ref = d.reference(st, "f64")
    ref_s = time.perf_counter() - t1
    out = []
    for kind, s, vals, idx in judged:
        t2 = time.perf_counter()
        checks = d.judge(st, Bs[kind], users_of(s), vals, idx, B_ref, Checks())
        out.append({"workload": name, "seed": seed, "user_seed": s, "kind": kind,
                    "correct": checks.correct, "checks": checks.rows,
                    "failures": checks.failures, "setup_s": setup_s,
                    "reference_s": ref_s, "judge_s": time.perf_counter() - t2})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--user-seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--faults", default="")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--out", default="")
    a = ap.parse_args(argv)
    ints = lambda s: [int(x) for x in s.split(",") if x]  # noqa: E731
    rows = readings(common.load_manifest(), a.workload, a.seed, ints(a.user_seeds),
                    ints(a.control_seeds), [f for f in a.faults.split(",") if f],
                    ints(a.fault_seeds))
    lines = [json.dumps(row) for row in rows]
    print("\n".join(lines), flush=True)
    if a.out:
        with open(a.out, "a") as sink:
            sink.write("".join(line + "\n" for line in lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
