#!/usr/bin/env python3
"""Time the fits that the segment sum and the SGD apply carry, for this
checkout and another one, in turns on one CUDA GPU.

    python3 tools/compare_fits.py --other DIR [--rounds 2] [--seed N]
        [--out FILE]

``DIR`` is the root of another checkout of the repository (e.g. the
parent commit unpacked with ``git archive`` into a git-ignored
directory). Each round runs this checkout, then ``DIR``, then ``DIR``,
then this checkout (A B B A), each in a process of its own that builds
its own kernels, makes the data from the seed as ``chip_smoke.py`` does
and times, each fit run twice and the second one kept:

- ``BaselineModel`` by SGD and by ALS at config 2 (MovieLens-1M shape,
  ``chip_smoke.BASE``): the segment sum's main paths;
- ``grid_search_kernel_mf`` at config 1 (MovieLens-100K shape, the 3 x 3
  grid, ``chip_smoke.sweep_inputs``): 3,960 SGD steps and applies.

Each process prints one JSON line (the tree, the seconds of each fit,
the launch counts, the card's name and power limit); the parent prints
them again and writes them to ``--out``. Host-clock seconds ending in a
CUDA sync. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def worker(tree: Path, seed: int) -> None:
    """Time the fits of the checkout at ``tree``."""
    sys.path.insert(0, str(tree))
    import pandas as pd
    import torch

    import chip_smoke as cs
    from matrix_factorization_tpu_torch import BaselineModel, grid_search_kernel_mf
    from matrix_factorization_tpu_torch.ops import _build

    _build.build(sorted(p.stem for p in _build.CSRC.glob("*.cu")))
    (u, i, r), _ = cs.ml1m_ratings(seed)
    X, y = pd.DataFrame({"user_id": u, "item_id": i}), pd.Series(r)
    sw = cs.sweep_inputs(seed)
    out = {"tree": str(tree)}

    def timed(name, fn):
        fn()  # first fit: warm-up
        _build.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out[f"{name}_seconds"] = time.perf_counter() - t0
        out[f"{name}_launches"] = {
            "segment_sum": _build.launches("mf_segment_sum"),
            "sgd_step": _build.launches("mf_sgd_step", "mf_sgd_step_acc"),
            "segment_apply": _build.launches("mf_segment_apply")}

    for method in ("sgd", "als"):
        timed(f"baseline_{method}", lambda: BaselineModel(
            min_rating=0.5, max_rating=5.0, seed=seed,
            **cs.BASE[method]).fit(X, y))
    timed("sweep", lambda: grid_search_kernel_mf(
        sw["X"], sw["y"], sw["Xv"], sw["yv"], n_epochs=cs.ML100K["epochs"],
        seed=seed, **sw["kw"]))
    out["nvidia_smi"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(json.dumps(out), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other", type=Path)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", type=Path, default=None)
    ap.add_argument("--worker", type=Path, default=None,
                    help=argparse.SUPPRESS)  # time the fits of this tree
    args = ap.parse_args()
    if args.worker is not None:
        worker(args.worker, args.seed)
        return 0
    if args.other is None:
        ap.error("--other DIR is needed")
    trees = [ROOT, args.other.resolve()]
    lines = []
    for _ in range(args.rounds):
        for tree in trees + trees[::-1]:
            proc = subprocess.run(
                [sys.executable, str(Path(__file__).resolve()), "--worker",
                 str(tree), "--seed", str(args.seed)],
                cwd=tree, capture_output=True, text=True, timeout=900)
            if proc.returncode != 0:
                print(proc.stderr, file=sys.stderr)
                return proc.returncode
            lines.append(proc.stdout.strip().splitlines()[-1])
            print(lines[-1], flush=True)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
