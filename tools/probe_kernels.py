#!/usr/bin/env python3
"""Probe the catalog scorer's two paths and hold the scorer and the GJ
SPD leaf against another build of their sources, on one CUDA GPU.

    python3 tools/probe_kernels.py [--old-src DIR] [--out FILE] [--seed N]

1. build: the port's sources, with the ptxas lines (registers, spills).
2. paths: at config 3's serving width (I = 59,392, Kp = 256), sigmoid,
   f32 and bf16 tables, the streaming plans (2, 3 and 4 stages) and the
   tiled plan timed against each other for B from 1 to 256 (CUDA events,
   median, L2 flushed), to place the boundary B_s
   (``ops/cuda_scores.py::STREAM_MAX_B``) and the stage count; and B=1
   f32 timed with the L2 flushed by a 256 MB write (``chip_smoke.Timer``),
   by a 256 MB read, and not flushed.
3. With ``--old-src DIR``: ``DIR/score_catalog.cu`` and ``DIR/spd_gj.cu``,
   sources of the same functions with the earlier C interface (no launch
   plan arguments), are built under other library names and called on
   the same inputs as the current kernels, at every shape of
   ``chip_smoke.py``'s compare and compare_spd phases: ``torch.equal``
   of the two outputs, their largest difference, and both kernels' times
   at the timed shapes.

Each result is one JSON line on stdout and in ``--out``. Needs a GPU and
``nvcc``; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

_out = None


def emit(obj):
    line = json.dumps(obj)
    print(line, flush=True)
    if _out is not None:
        _out.write(line + "\n")
        _out.flush()


def build_old(src_dir: Path, name: str):
    from matrix_factorization_tpu_torch.ops import _build

    dst = _build.BUILD_DIR / "old"
    dst.mkdir(parents=True, exist_ok=True)
    lib = dst / f"lib{name}_old.so"
    res = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
                          str(src_dir / f"{name}.cu")],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed on the old {name}.cu:\n{res.stdout}{res.stderr}")
    return ctypes.CDLL(str(lib)), res.stdout + res.stderr


def phase_paths(torch, rng, timer):
    from matrix_factorization_tpu_torch.core.config import SGDConfig
    from matrix_factorization_tpu_torch.ops import cuda_scores as sc

    cfg = cs.score_cfg(SGDConfig, "sigmoid", 256)
    Q32 = torch.from_numpy(cs.ext_tables(rng, cs.N_ITEMS, cfg, "item")).to("cuda")
    P32 = torch.from_numpy(cs.ext_tables(rng, 256, cfg, "user")).to("cuda")
    mu = torch.tensor(3.5, device="cuda")
    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    for dtype in (torch.float32, torch.bfloat16):
        Q, P = Q32.to(dtype), P32.to(dtype)
        size = Q.element_size()
        for B in (1, 4, 16, 17, 32, 64, 128, 256):
            pu = P[:B].contiguous()
            row = {"phase": "paths", "B": B, "dtype": str(dtype).split(".")[-1],
                   "plan": sc.score_plan(B, cs.N_ITEMS, 256, size, n_sms).path}
            want = sc.score_with_plan(cfg, mu, pu, Q, None)
            plans = {}
            users = next((u for u in sc.STREAM_USERS if u >= B), None)
            if users is not None:
                for stages in (2, 3, 4):
                    smem = sc.stream_smem(users, 256, stages)
                    if smem <= sc.SMEM_LIMIT:
                        plans[f"stream{stages}"] = sc.ScorePlan(
                            "stream", users, sc.STREAM_ITEMS, 128 // size, stages,
                            (min(-(-cs.N_ITEMS // sc.STREAM_ITEMS), n_sms), 1), smem)
            plans["tile"] = sc.ScorePlan(
                "tile", sc.TILE_M, sc.TILE_N, 128 // size, sc.TILE_STAGES,
                (-(-cs.N_ITEMS // sc.TILE_N), -(-B // sc.TILE_M)),
                sc.tile_smem(sc.TILE_STAGES))
            for name, plan in plans.items():
                got = sc.score_with_plan(cfg, mu, pu, Q, plan)
                row[f"{name}_equal"] = bool(torch.equal(got, want))
                row[f"{name}_ms"] = timer.ms(
                    lambda plan=plan: sc.score_with_plan(cfg, mu, pu, Q, plan))
            row["bound_ms"], row["bound_by"] = cs.bound(
                B, cs.N_ITEMS, 256, "sigmoid", str(dtype).split(".")[-1])
            emit(row)
    # what the flush costs the timed call: a written flush leaves the L2
    # full of dirty lines that the kernel's reads then evict to memory
    pu = P32[:1].contiguous()
    call = lambda: sc.cuda_score_catalog(cfg, mu, pu, Q32)  # noqa: E731
    emit({"phase": "flush", "B": 1, "dtype": "float32",
          "write_flush_ms": timer.ms(call),
          "read_flush_ms": median_ms(torch, call, timer.flush.sum),
          "no_flush_ms": median_ms(torch, call, lambda: None),
          "write_flush_ms_again": timer.ms(call)})


def median_ms(torch, fn, before, reps=25, warmup=3):
    """``chip_smoke.Timer.ms`` with ``before`` run ahead of each timed
    call in place of its written flush."""
    for _ in range(warmup):
        fn()
    pairs = []
    for _ in range(reps):
        before()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    return sorted(s.elapsed_time(e) for s, e in pairs)[reps // 2]


def phase_old_scores(torch, rng, timer, old):
    from matrix_factorization_tpu_torch.core.config import SGDConfig
    from matrix_factorization_tpu_torch.ops import cuda_scores as sc

    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    old.mf_score_catalog.argtypes = [vp, vp, vp, vp, ci, ci, ci, ci, ci,
                                     cf, cf, cf, vp]
    old.mf_score_catalog.restype = ci

    def run_old(cfg, mu, pu, Q):
        out = torch.empty((pu.shape[0], Q.shape[0]), device="cuda")
        rc = old.mf_score_catalog(
            mu.data_ptr(), pu.data_ptr(), Q.data_ptr(), out.data_ptr(),
            pu.shape[0], Q.shape[0], pu.shape[1],
            {"linear": 0, "sigmoid": 1, "rbf": 2}[cfg.kernel],
            0 if pu.dtype == torch.float32 else 1, float(cfg.gamma),
            float(cfg.a), float(cfg.c),
            torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"old scorer failed: {rc}")
        return out

    shapes = list(cs.compare_shapes(sc.STREAM_MAX_B))
    shapes += [(B, cs.N_ITEMS, 256) for B in cs.SCORE_TIMED_B
               if (B, cs.N_ITEMS, 256) not in shapes]
    for B, I, kp in shapes:
        for kernel in ("linear", "sigmoid", "rbf"):
            cfg = cs.score_cfg(SGDConfig, kernel, kp)
            pu32 = torch.from_numpy(cs.ext_tables(rng, B, cfg, "user")).to("cuda")
            Q32 = torch.from_numpy(cs.ext_tables(rng, I, cfg, "item")).to("cuda")
            mu = torch.tensor(3.5, device="cuda")
            for dtype in (torch.float32, torch.bfloat16):
                pu, Q = pu32.to(dtype), Q32.to(dtype)
                new = sc.cuda_score_catalog(cfg, mu, pu, Q)
                was = run_old(cfg, mu, pu, Q)
                diff = (new - was).abs()
                row = {"phase": "old_scores", "B": B, "I": I, "Kp": kp,
                       "kernel": kernel, "dtype": str(dtype).split(".")[-1],
                       "path": sc.score_plan(B, I, kp, pu.element_size()).path,
                       "equal": bool(torch.equal(new, was)),
                       "max_abs_diff": float(diff.max()),
                       "n_differ": int((diff > 0).sum())}
                if I == cs.N_ITEMS and B in cs.SCORE_TIMED_B:
                    row["new_ms"] = timer.ms(lambda: sc.cuda_score_catalog(cfg, mu, pu, Q))
                    row["old_ms"] = timer.ms(lambda: run_old(cfg, mu, pu, Q))
                    row["new_ms_again"] = timer.ms(
                        lambda: sc.cuda_score_catalog(cfg, mu, pu, Q))
                emit(row)


def phase_old_spd(torch, gen, timer, old):
    from matrix_factorization_tpu_torch.ops import cuda_spd

    vp, ci = ctypes.c_void_p, ctypes.c_int
    old.mf_gj_inverse.argtypes = [vp, vp, ctypes.c_longlong, ci, vp]
    old.mf_gj_inverse.restype = ci

    def run_old(A):
        out = torch.empty_like(A)
        rc = old.mf_gj_inverse(A.data_ptr(), out.data_ptr(), A.shape[0],
                               A.shape[-1], torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"old GJ leaf failed: {rc}")
        return out

    for E, d in cs.SPD_SHAPES:
        A = cs.ridged_grams(torch, gen, E, d)
        new = cuda_spd.cuda_gj_inverse(A)
        was = run_old(A)
        diff = (new - was).abs()
        row = {"phase": "old_spd", "E": E, "d": d,
               "equal": bool(torch.equal(new, was)),
               "max_abs_diff": float(diff.max()), "n_differ": int((diff > 0).sum())}
        if (E, d) in cs.SPD_TIMED:
            row["new_ms"] = timer.ms(lambda: cuda_spd.cuda_gj_inverse(A))
            row["old_ms"] = timer.ms(lambda: run_old(A))
            row["new_ms_again"] = timer.ms(lambda: cuda_spd.cuda_gj_inverse(A))
            row["bound_ms"], row["bound_by"] = cs.spd_bound(E, d)
        emit(row)
        del A, new, was
        torch.cuda.empty_cache()


def main() -> int:
    global _out
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--old-src", type=Path, default=None)
    ap.add_argument("--out", type=Path, default=None)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("probe_kernels: no CUDA device is available", file=sys.stderr)
        return 1
    from matrix_factorization_tpu_torch.ops import _build

    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        _out = args.out.open("w")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    emit({"phase": "device", "nvidia_smi": smi, "torch": torch.__version__})
    secs = _build.build(["score_catalog", "spd_gj"])
    emit({"phase": "build", "seconds": secs,
          "ptxas": cs.ptxas_summary(_build.build_logs.values())})
    timer = cs.Timer(torch)
    rng = np.random.default_rng(args.seed)
    phase_paths(torch, rng, timer)
    if args.old_src is not None:
        old_sc, log_sc = build_old(args.old_src, "score_catalog")
        old_gj, log_gj = build_old(args.old_src, "spd_gj")
        emit({"phase": "build_old",
              "ptxas": cs.ptxas_summary((log_sc, log_gj))})
        phase_old_scores(torch, rng, timer, old_sc)
        phase_old_spd(torch, torch.Generator(device="cuda").manual_seed(args.seed),
                      timer, old_gj)
    emit({"phase": "done", "nvidia_smi": smi})
    return 0


if __name__ == "__main__":
    sys.exit(main())
