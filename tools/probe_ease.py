"""EASE's fit at the Million Song Dataset's size on one card, by phase,
with its peak memory: the numbers behind ``ops/ease.py::FIT_PEAK_COPIES``
and the gram's two paths.

    python3 tools/probe_ease.py [--seed N] [--fits 3] [--prefix-users 65536] \\
        [--model] [--at-budget] [--out chiprun_out/probe_ease.jsonl]

Makes the plays of ``portbench/configs/msd-ease-l200.json`` on the card
(``portbench/gen.py``, every weight 1), packs them (``gram_pack``), then:

* ``fit``: ``--fits`` whole ``fit_packed`` calls, each with the peak of
  device memory reset after the pack (``FIT_PEAK_COPIES`` is the largest
  peak over ``I_p^2 * 4`` bytes) and its phases timed by CUDA events: the
  scan (``gram_scan``), the inverse (``spd_inverse_scaled`` of the system)
  and the closed form;
* ``gram_paths``: the first ``--prefix-users`` users' gram by the int8
  kernels and by the exact-f32 scan, each timed, and whether the two are
  equal bit for bit;
* with ``--model``, ``model``: ``EASE(reg).fit`` on the plays as a
  DataFrame (the whole model path: ids, duplicate check, budget, pack,
  fit, histories), its seconds and peak, then ``recommend_batch`` of 100
  items for 256 users, none of them already played;
* with ``--at-budget``, ``budget`` alone: the configuration's users and
  plays over as many items as ``ops/ease.py::device_item_limit`` admits
  on this card, ``EASE(reg).fit`` through the model, its seconds, its peak
  allocated and reserved against the card's memory and the budget's
  model of the peak (or the out-of-memory error, if the budget admitted
  too much).

One JSON line a reading, with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def _card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def _events(torch):
    return torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=2200000001)
    ap.add_argument("--fits", type=int, default=3)
    ap.add_argument("--prefix-users", type=int, default=65536)
    ap.add_argument("--model", action="store_true")
    ap.add_argument("--at-budget", action="store_true")
    ap.add_argument("--out", default="")
    a = ap.parse_args(argv)
    import numpy as np
    import torch

    from matrix_factorization_tpu_torch.ops import ease as ease_ops
    from matrix_factorization_tpu_torch.ops import spd
    from portbench import gen

    sink = open(a.out, "a") if a.out else None

    def emit(row):
        row = dict(row, card=_card())
        line = json.dumps(row)
        print(line, flush=True)
        if sink:
            sink.write(line + "\n")
            sink.flush()

    cfg = json.loads((ROOT / "portbench" / "configs" / "msd-ease-l200.json").read_text())
    if a.at_budget:
        return _at_budget(cfg, a.seed, emit)
    t0 = time.perf_counter()
    u, i, r = gen.ratings(cfg, a.seed, "cuda")
    u, i = u.cpu().numpy(), i.cpu().numpy()
    w = np.ones(len(u), np.float32)
    del r
    gen_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    pack = ease_ops.gram_pack(u, i, w, cfg["n_users"], cfg["n_items"], device="cuda")
    torch.cuda.synchronize()
    emit({"phase": "pack", "gen_s": gen_s, "pack_s": time.perf_counter() - t1,
          "int8": pack.tiles is not None, "chunks": len(pack.bounds) - 1,
          "ip": pack.ip,
          "pack_bytes": sum(t.numel() * t.element_size() for t in pack[:3])})
    ip = pack.ip
    for f in range(a.fits):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        (e0, e1), (e2, e3), (e4, e5) = _events(torch), _events(torch), _events(torch)
        t = time.perf_counter()
        e0.record()
        G = ease_ops.gram_scan(pack)
        e1.record()
        system = [ease_ops._with_ridge(G, cfg["reg"])]
        del G
        e2.record()
        P = spd.spd_inverse_scaled(system.pop())
        e3.record()
        e4.record()
        B = ease_ops._closed_form(P)
        e5.record()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        peak = torch.cuda.max_memory_allocated()
        emit({"phase": "fit", "fit": f, "wall_s": wall,
              "gram_ms": e0.elapsed_time(e1), "inverse_ms": e2.elapsed_time(e3),
              "closed_form_ms": e4.elapsed_time(e5), "peak_bytes": peak,
              "resident_bytes": base, "peak_copies": peak / (4.0 * ip * ip),
              "fit_peak_copies": (peak - base) / (4.0 * ip * ip),
              "b_finite": bool(torch.isfinite(B).all()),
              "b_diag_zero": bool((B.diagonal() == 0).all())})
        del P, B
    # the whole fit through fit_packed, as the benchmark's unit calls it
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    B = ease_ops.fit_packed(pack, cfg["reg"])
    torch.cuda.synchronize()
    emit({"phase": "fit_packed", "wall_s": time.perf_counter() - t,
          "peak_bytes": torch.cuda.max_memory_allocated(),
          "peak_copies": torch.cuda.max_memory_allocated() / (4.0 * ip * ip)})
    del B, pack
    torch.cuda.empty_cache()
    # the two gram paths on a prefix of the users
    keep = u < a.prefix_users
    args = (u[keep], i[keep], w[keep], a.prefix_users, cfg["n_items"])
    p8 = ease_ops.gram_pack(*args, device="cuda")
    lu, ii, ww, bounds = ease_ops._gram_chunks(*args[:4], 2048)
    pf = ease_ops.GramPack(*(torch.from_numpy(x).cuda() for x in (lu, ii, ww)),
                           tuple(int(b) for b in bounds), ip, 2048, None)
    out = {}
    for name, p in (("int8", p8), ("f32", pf), ("int8_again", p8)):
        e0, e1 = _events(torch)
        e0.record()
        out[name] = ease_ops.gram_scan(p)
        e1.record()
        torch.cuda.synchronize()
        out[name + "_ms"] = e0.elapsed_time(e1)
    emit({"phase": "gram_paths", "users": a.prefix_users, "plays": int(keep.sum()),
          "int8_ms": out["int8_again_ms"], "int8_first_ms": out["int8_ms"],
          "f32_ms": out["f32_ms"], "equal": bool(torch.equal(out["int8"], out["f32"]))})
    del out, p8, pf
    torch.cuda.empty_cache()
    if a.model:
        import pandas as pd

        from matrix_factorization_tpu_torch import EASE

        X = pd.DataFrame({"user_id": u, "item_id": i})
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        m = EASE(reg=cfg["reg"]).fit(X, pd.Series(w))
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t
        peak = torch.cuda.max_memory_allocated()
        users = np.unique(u)[:: max(1, cfg["n_users"] // 256)][:256]
        t = time.perf_counter()
        rec = m.recommend_batch(users.tolist(), amount=100)
        rec_s = time.perf_counter() - t
        played = set(zip(u.tolist(), i.tolist()))
        seen = sum((a_, b_) in played for a_, b_ in zip(rec["user_id"], rec["item_id"]))
        emit({"phase": "model", "fit_s": fit_s, "peak_bytes": peak,
              "peak_copies": peak / (4.0 * ip * ip), "n_items": m.n_items,
              "recommend_s": rec_s, "rows": len(rec), "already_played": seen})
    if sink:
        sink.close()
    return 0


def _at_budget(cfg, seed: int, emit) -> int:
    """``--at-budget``: a whole ``EASE.fit`` at the card's item budget."""
    import numpy as np
    import pandas as pd
    import torch

    from matrix_factorization_tpu_torch import EASE
    from matrix_factorization_tpu_torch.ops import ease as ease_ops
    from portbench import gen

    total = torch.cuda.get_device_properties(0).total_memory
    n = ease_ops.device_item_limit(1, "cuda", cfg["n_ratings"])
    cfg = dict(cfg, n_items=n)
    u, i, _ = gen.ratings(cfg, seed, "cuda")
    u, i = u.cpu().numpy(), i.cpu().numpy()
    torch.cuda.empty_cache()
    X = pd.DataFrame({"user_id": u, "item_id": i})
    row = {"phase": "budget", "total_memory": total, "n_items": n, "plays": len(u),
           "model_peak_bytes": ease_ops.FIT_PEAK_COPIES * 4 * ease_ops.round8(n) ** 2
           + ease_ops.PLAY_BYTES * len(u)}
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    try:
        m = EASE(reg=cfg["reg"]).fit(X, pd.Series(np.ones(len(u), np.float32)))
        torch.cuda.synchronize()
    except torch.cuda.OutOfMemoryError as e:
        emit(dict(row, ok=False, error=str(e).splitlines()[0],
                  peak_bytes=torch.cuda.max_memory_allocated(),
                  reserved_bytes=torch.cuda.max_memory_reserved()))
        return 1
    B = m._params.item_weights
    emit(dict(row, ok=True, fit_s=time.perf_counter() - t,
              peak_bytes=torch.cuda.max_memory_allocated(),
              reserved_bytes=torch.cuda.max_memory_reserved(),
              b_finite=bool(torch.isfinite(B).all()),
              b_diag_zero=bool((B.diagonal() == 0).all())))
    return 0


if __name__ == "__main__":
    sys.exit(main())
