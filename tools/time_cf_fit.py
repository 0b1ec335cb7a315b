#!/usr/bin/env python3
"""Time the dense CF fits at config 2 with two similarity chunk sizes.

    python3 tools/time_cf_fit.py [--seed N] [--reps N]

Makes config 2's 1M ratings (``chip_smoke.ml1m_ratings``), then fits
``UserUserCF`` and ``ItemItemCF`` (50 neighbours, as ``chip_smoke.py``'s
``cf`` phase) ``--reps`` times each with the chunk of
``ops/similarity.py::cosine_rows`` as it is (``row_chunk(E)``) and with a
fixed chunk of ``ROW_CHUNK`` (1,024) rows, in the order A B B A ..., after
one warm-up fit with each; and times ``cosine_rows`` alone on the fitted
model's centered matrix by CUDA events, both ways. Prints the card's name
and power limit, then one JSON line a model with the medians and every
reading. Needs a GPU; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=9)
    args = ap.parse_args()

    import pandas as pd
    import torch

    if not torch.cuda.is_available():
        print("time_cf_fit: no CUDA device is available", file=sys.stderr)
        return 1
    from matrix_factorization_tpu_torch import ItemItemCF, UserUserCF
    from matrix_factorization_tpu_torch.ops import similarity as sim

    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(json.dumps({"phase": "device", "nvidia_smi": smi}), flush=True)
    (u, i, r), _ = cs.ml1m_ratings(args.seed)
    X = pd.DataFrame({"user_id": u, "item_id": i})
    y = pd.Series(r)
    chunks = {"row_chunk": sim.row_chunk, "fixed": lambda e: sim.ROW_CHUNK}
    order = list(chunks)
    try:
        for cls in (UserUserCF, ItemItemCF):
            def fit():
                t0 = time.perf_counter()
                model = cls(n_neighbors=cs.CF_NEIGHBOURS, min_rating=0.5,
                            max_rating=5.0).fit(X, y)
                torch.cuda.synchronize()
                return model, time.perf_counter() - t0

            for name in order:  # warm-up
                sim.row_chunk = chunks[name]
                model, _ = fit()
            st = model._state
            m = (st.ratings - st.means[:, None] if cls is UserUserCF
                 else (st.ratings - st.means[None, :]).T)  # as the fits' own
            e = m.shape[0]
            fits = {name: [] for name in order}
            prods = {name: [] for name in order}
            for rep in range(args.reps):
                for name in (order if rep % 2 == 0 else order[::-1]):
                    sim.row_chunk = chunks[name]
                    fits[name].append(fit()[1])
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    start.record()
                    sim.cosine_rows(m)
                    end.record()
                    torch.cuda.synchronize()
                    prods[name].append(start.elapsed_time(end))
            rows = {name: chunks[name](e) for name in order}
            print(json.dumps({
                "model": cls.__name__, "E": e, "chunk_rows": rows,
                "padding_share": {k: (-(-e // c) * c - e) / e for k, c in rows.items()},
                "fit_seconds_median": {k: statistics.median(v) for k, v in fits.items()},
                "cosine_rows_ms_median": {k: statistics.median(v)
                                          for k, v in prods.items()},
                "fit_seconds": fits, "cosine_rows_ms": prods}), flush=True)
    finally:
        sim.row_chunk = chunks["row_chunk"]
    return 0


if __name__ == "__main__":
    sys.exit(main())
