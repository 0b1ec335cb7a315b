"""Readings that the limits of a cell's check are set from, in one
process (set-up is long; one process pays the imports and the build
once). The benchmark's own runs never run this.

    python3 portbench/calibrate.py --workload <name> --seeds 1,2,... \\
        [--control-seeds ...] [--faults half,altered] [--fault-seeds ...] \\
        [--out chiprun_out/calibrate.jsonl]

For each seed: the cell's set-up, for a search cell a short window of
``check_calls`` calls, then the check against the plain reference (the
lower reading); on the control seeds also the control (the reference in
the next lower precision, judged in the program's place: the upper
reading); and on the fault seeds each named fault planted in the program
(``unchanged``: a step that leaves its state as it was; ``half``: a step
that sees half of its batch at twice the weight, or half of a batch of
queries left out, its answers copied from the other half; ``altered``: a
top-k answer altered where it is produced). One JSON line a reading, on
standard output and in ``--out``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import common  # noqa: E402
from portbench.common import Cell  # noqa: E402


@contextlib.contextmanager
def fault(driver_name: str, name: str):
    """Plant fault ``name`` in the program for the block."""
    if name == "unchanged" and driver_name in ("sgd", "als"):
        if driver_name == "sgd":
            from matrix_factorization_tpu_torch.ops import segment_sgd as mod

            attr = "minibatch_update"

            def patched(params, *a, **kw):
                return params
        else:
            from matrix_factorization_tpu_torch.ops import ials as mod

            attr = "bucket_sweep"

            def patched(own, *a, **kw):
                return own
        orig = getattr(mod, attr)
    elif name == "half" and driver_name == "sgd":
        from matrix_factorization_tpu_torch.ops import segment_sgd as mod

        orig = mod.minibatch_update

        def patched(params, b, cfg, lr, primary, masks=None, reg=None, write=None):
            b = dict(b)
            w = b["w"].clone()
            w[1::2] = 0.0
            w[0::2] *= 2.0
            b["w"] = w
            return orig(params, b, cfg, lr, primary, masks, reg, write)

        attr = "minibatch_update"
    elif name == "half" and driver_name == "als":
        from matrix_factorization_tpu_torch.ops import ials as mod

        orig = mod.normal_equations

        def patched(other, other_ids, ratings, mask, *a, **kw):
            mask = mask.clone()
            mask[:, 1::2] = 0.0
            return orig(other, other_ids, ratings, mask, *a, **kw)

        attr = "normal_equations"
    elif name in ("altered", "half") and driver_name == "search":
        from matrix_factorization_tpu_torch.retrieval import search as mod

        orig = mod.dense_topk

        def patched(emb, q, k):
            if name == "half":
                import torch

                h = max(1, q.shape[0] // 2)
                vals, idx = orig(emb, q[:h], k)
                reps = -(-q.shape[0] // h)
                return (torch.cat([vals] * reps)[:q.shape[0]],
                        torch.cat([idx] * reps)[:q.shape[0]])
            vals, idx = orig(emb, q, k)
            idx = idx.clone()
            idx[:, -1] = (idx[:, -1] + 1) % emb.shape[0]
            return vals, idx

        attr = "dense_topk"
    else:
        raise ValueError(f"no fault {name!r} for the {driver_name} driver")
    setattr(mod, attr, patched)
    try:
        yield
    finally:
        setattr(mod, attr, orig)


def reading(manifest, name: str, seed: int, control: bool = False,
            fault_name: str = "", device: str = "cuda") -> dict:
    import torch

    cell = Cell.load(manifest, name, seed, device)
    driver = common.load_module(common.driver_path(cell.mix["driver"]),
                                f"portbench_driver_{cell.mix['driver']}")
    t0 = time.perf_counter()
    with (fault(cell.mix["driver"], fault_name) if fault_name
          else contextlib.nullcontext()):
        st = driver.setup(cell)
        for j in range(cell.mix.get("check_calls", 0)):
            driver.unit(st, j)
    setup_s = time.perf_counter() - t0
    out = []
    kinds = [("program", False)] + ([("control", True)] if control else [])
    if fault_name:
        kinds = [(f"fault:{fault_name}", False)]
    for kind, ctl in kinds:
        t1 = time.perf_counter()
        checks = driver.check(st, control=ctl)
        out.append({"workload": name, "seed": seed, "kind": kind,
                    "correct": checks.correct, "checks": checks.rows,
                    "failures": checks.failures, "setup_s": setup_s,
                    "check_s": time.perf_counter() - t1})
    del st
    if device == "cuda":
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--faults", default="")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--out", default="")
    a = ap.parse_args(argv)
    ints = lambda s: [int(x) for x in s.split(",") if x]  # noqa: E731
    manifest = common.load_manifest()
    ctl = set(ints(a.control_seeds))
    jobs = [(s, s in ctl, "") for s in ints(a.seeds)]
    jobs += [(s, True, "") for s in ctl - set(ints(a.seeds))]
    jobs += [(s, False, f) for f in a.faults.split(",") if f
             for s in ints(a.fault_seeds)]
    sink = open(a.out, "a") if a.out else None
    try:
        for seed, control, f in jobs:
            for row in reading(manifest, a.workload, seed, control, f):
                line = json.dumps(row)
                print(line, flush=True)
                if sink:
                    sink.write(line + "\n")
                    sink.flush()
    finally:
        if sink:
            sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
