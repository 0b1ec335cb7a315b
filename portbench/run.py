"""Run one cell of the port's benchmark and print its result line.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds ``matrix_factorization_tpu_torch``,
on a machine with the CUDA cards the cell asks for (exit 2 without them;
nothing runs on the CPU). Set-up (imports, inputs made from the seed,
the program's host packs, warm-up of every shape, the check's first
steps) is timed as ``setup_s``; then the window runs the cell's driver's
units back to back until ``--seconds`` have passed, each unit whole. With
``--trace 0`` the result carries the cell's end-to-end metrics; with
``--trace 1`` a ``torch.profiler`` trace of a steady stretch of the
window gives its per-layer metrics, ``busy_s``, ``window_s`` and a
``breakdown``. After the window the peak of device memory is read, the
program's state is freed, and the check compares what the program
produced with the plain reference (``correct``); each compared number is
printed beside its limit, last on standard error and last in the result.
The last line of standard output is the result, one JSON object.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# kernel caches stay in the checkout; a transformer library, should the
# program load one, must not load its JAX side
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton")):
    os.environ[var] = str(ROOT / "build" / "portbench_cache" / sub)
os.environ["USE_FLAX"] = "0"
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import common  # noqa: E402
from portbench.common import Cell, Checks  # noqa: E402


class NoDevice(RuntimeError):
    pass


def _device_info(torch, device: str, count: int) -> dict:
    if device != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": count,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": count, "memory_peak_bytes": int(torch.cuda.max_memory_allocated())}


def forbidden_loaded() -> list:
    return sorted(m for m in sys.modules
                  if m.split(".")[0] in common.FORBIDDEN_MODULES)


def run_cell(manifest: dict, name: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", cell: Cell | None = None) -> tuple:
    """One run of a cell; returns (the result object, its ``Checks``).
    ``cell`` may be given in place of the manifest's (the tests run tiny
    cells on the CPU)."""
    import torch

    w = common.workload(manifest, name)
    chips = int(w["chips"])
    if device == "cuda" and (not torch.cuda.is_available()
                             or torch.cuda.device_count() < chips):
        raise NoDevice(f"the cell needs {chips} CUDA device(s); "
                       f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
                       " found")
    import matrix_factorization_tpu_torch as port

    if Path(port.__file__).resolve().parents[1] != ROOT:
        raise RuntimeError(f"the program was imported from {port.__file__}, "
                           f"not from this checkout ({ROOT})")
    cell = cell or Cell.load(manifest, name, seed, device)
    driver = common.load_module(common.driver_path(cell.mix["driver"]),
                                f"portbench_driver_{cell.mix['driver']}")
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    st = driver.setup(cell)
    if device == "cuda":
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - T_START
    print(f"set-up {setup_s:.3f} s; parts {st.get('setup_parts', {})}",
          file=sys.stderr)

    units: list = []
    breakdown = None
    if not trace:
        t0 = time.perf_counter()
        j = 0
        while True:
            units.append(driver.unit(st, j))
            j += 1
            window_s = time.perf_counter() - t0
            if window_s >= seconds:
                break
        e2e = driver.end_to_end(st, units, window_s)
        e2e["setup_s"] = setup_s
        metrics = {}
        for m in common.end_to_end_for(manifest, name):
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    else:
        from torch.autograd.profiler import record_function

        from portbench.trace import Profiled, reduce_trace

        units.append(driver.unit(st, 0))  # a steady unit before the trace
        traced = []
        with Profiled(torch, device) as prof:
            for j in range(1, 1 + cell.mix["trace_units"]):
                with record_function("pb:unit"):
                    traced.append(driver.unit(st, j))
        units += traced
        view = reduce_trace(prof.events, work=driver.trace_work(st, traced))
        metrics = {}
        for m in common.per_layer_for(manifest, name):
            reader = common.load_module(common.metric_path(m["name"]),
                                        "portbench_metric_" + m["name"].replace(".", "_"))
            v = reader.read(view, cell)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        breakdown = view.breakdown()
    info = _device_info(torch, device, chips)
    if trace:
        info["busy_s"] = view.busy_s
        info["window_s"] = view.window_s
    checks: Checks = driver.check(st)
    del st
    attempted = sum(u.get("queries", u.get("epochs", 1)) for u in units)
    out = {"correct": checks.correct, "attempted": attempted,
           "failed": 0 if checks.correct else attempted,
           "metrics": metrics, "device": info}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = dict(checks.rows, **({"failures": checks.failures}
                                         if checks.failures else {}))
    return out, checks


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    manifest = common.load_manifest()
    try:
        out, checks = run_cell(manifest, a.workload, a.seed, a.seconds,
                               bool(a.trace))
    except NoDevice as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 2
    bad = forbidden_loaded()
    if bad:
        print(f"portbench: modules that may not load were loaded: {bad}",
              file=sys.stderr)
        return 3
    for line in checks.lines():
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
