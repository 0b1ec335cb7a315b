#!/usr/bin/env python3
"""Read a benchmark cell's traced stretch by the program's own spans.

    python3 tools/trace_spans.py --workload <name> --seed <n> [--out FILE]
    python3 tools/trace_spans.py --cost [--out FILE]

Runs the cell as ``portbench/run.py --seconds 0 --trace 1`` does (the same
set-up, steady unit, traced units and check; the harness's result object
is kept whole under ``result``) and keeps the trace's events. From them it
prints one JSON object: the window's reduction by ``mf:`` span
(``portbench/program_trace.py::reduce_program``: count, host, device,
kernel and idle seconds of each span, and what lies outside every span),
each span's count a traced unit, the spans' per-layer readings
(``span_readings``) and the checks that hold them to the harness's
name-matching readers:

* the harness's call spans as many as the driver's traced calls;
* each span roofline within 1% of its name-matching original;
* ``topk_tie_blocks.span`` equal to ``topk_tie_blocks``;
* ``topk_idle_ms`` <= ``search_idle_program_ms`` <= ``search_host_ms``;
* the device seconds under ``als.normal_eq``, ``spd.schur`` and
  ``spd.leaf`` at most the window's busy seconds, and the attributed and
  unattributed device seconds adding up to it within 0.1%.

Besides, the kernels launched inside each span (innermost), by name, with
their device seconds in the window (``kernels_by_span``, the ten longest a
span): what runs under ``als.normal_eq`` shows whether the design gather
and the batched product are gone. And each span's device seconds with the
spans nested in it (``inclusive_device_s``), and from them
``als_normal_eq_ms.inclusive``: the normal equations' device ms an epoch
with the kernel's own span ``als.gram_kernel`` inside, which the
harness's innermost ``als_normal_eq_ms`` leaves out.

``--cost`` times ``utils.profiling.span`` on the host instead: entered and
left with no profiler recording, and with one recording, beside a bare
``record_function`` and ``_RecordFunctionFast``, in microseconds a span.

Needs a CUDA card (the benchmark's cells run nowhere else); imports
nothing of JAX.
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


def _device_by_span(events: list, lo: float, hi: float, cats) -> tuple:
    """The ``mf:`` spans ((start, end, name), by start) and, for each device
    event of ``cats`` with a launch, (name, device seconds in the window
    [lo, hi], index of the innermost span its launch lies in or -1)."""
    from portbench.program_trace import LAUNCH_CATS, PROGRAM_PREFIX, _innermost

    spans = sorted((e["ts"], e["ts"] + e["dur"], e["name"][len(PROGRAM_PREFIX):])
                   for e in events if e.get("ph") == "X" and e.get("cat") == "cpu_op"
                   and e.get("name", "").startswith(PROGRAM_PREFIX))
    launch = {e["args"]["correlation"]: e["ts"] for e in events
              if e.get("ph") == "X" and e.get("cat") in LAUNCH_CATS
              and "correlation" in e.get("args", {})}
    work = []
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in cats:
            continue
        a, b = max(e["ts"], lo), min(e["ts"] + e["dur"], hi)
        at = launch.get(e.get("args", {}).get("correlation"))
        if b > a and at is not None:
            work.append((e["name"], (b - a) / 1e6, at))
    inner = _innermost(spans, [w[2] for w in work])
    return spans, [(n, secs, ix) for (n, secs, _), ix in zip(work, inner)]


def kernels_by_span(events: list, lo: float, hi: float, top: int = 10) -> dict:
    """{span: [[kernel name, device seconds in the window], ...]} for the
    kernels whose launch lies innermost in each ``mf:`` span, the longest
    first."""
    spans, kernels = _device_by_span(events, lo, hi, ("kernel",))
    out: dict = {}
    for kname, secs, ix in kernels:
        per = out.setdefault(spans[ix][2] if ix >= 0 else "(outside)", {})
        per[kname] = per.get(kname, 0.0) + secs
    return {n: sorted(([k[:100], v] for k, v in per.items()), key=lambda x: -x[1])[:top]
            for n, per in sorted(out.items())}


def inclusive_device_s(events: list, lo: float, hi: float) -> dict:
    """{span: device seconds in the window of the work launched inside it,
    the spans nested in it included}: a launch counts once in every span
    name that holds it."""
    from portbench.trace import DEVICE_CATS

    spans, work = _device_by_span(events, lo, hi, DEVICE_CATS)
    parent, open_ = [], []
    for j, (start, _, _) in enumerate(spans):  # as ``_innermost`` nests them
        while open_ and spans[open_[-1]][1] < start:
            open_.pop()
        parent.append(open_[-1] if open_ else -1)
        open_.append(j)
    out: dict = {}
    for _, secs, ix in work:
        names = set()
        while ix >= 0:
            names.add(spans[ix][2])
            ix = parent[ix]
        for n in names:
            out[n] = out.get(n, 0.0) + secs
    return dict(sorted(out.items()))


def trace_cell(name: str, seed: int) -> dict:
    """One traced run of cell ``name``."""
    from portbench import common, run, trace
    from portbench.program_trace import harness_window, reduce_program, span_readings, total

    # the harness's own run, with its trace's events and view kept: the
    # readings below come from the stretch the harness read
    kept = {}

    class Keeping(trace.Profiled):
        def __exit__(self, *exc):
            out = super().__exit__(*exc)
            kept["events"] = self.events
            return out

    def keeping_reduce(events, work=None):
        kept["view"] = real_reduce(events, work)
        return kept["view"]

    real_profiled, real_reduce = trace.Profiled, trace.reduce_trace
    trace.Profiled, trace.reduce_trace = Keeping, keeping_reduce
    try:
        result, _ = run.run_cell(common.load_manifest(), name, seed, 0.0, True)
    finally:
        trace.Profiled, trace.reduce_trace = real_profiled, real_reduce
    events, view = kept["events"], kept["view"]
    lo, hi = harness_window(events)
    # the harness's call spans, as ``search_host_ms`` counts them
    units = sum(1 for n, _, _ in view.spans if n == "unit")
    prog = reduce_program(events, lo, hi)
    readings = span_readings(view, prog)
    metrics = {k: v["value"] for k, v in result["metrics"].items()}
    checks = {}
    if view.work.get("calls"):
        checks["units_are_calls"] = units == view.work["calls"]
    for twin in ("sgd_step_roofline", "sgd_apply_roofline", "gj_roofline",
                 "search_gemm_roofline"):
        a, b = readings.get(twin + ".span"), metrics.get(twin)
        if a is not None and b is not None:
            checks[twin + ".span_rel_gap"] = abs(a - b) / b
    if "topk_tie_blocks" in metrics:
        checks["tie_counts_equal"] = readings["topk_tie_blocks.span"] == metrics["topk_tie_blocks"]
    if readings["search_idle_program_ms"] is not None and "search_host_ms" in metrics:
        checks["idle_order_holds"] = (readings["topk_idle_ms"]
                                      <= readings["search_idle_program_ms"]
                                      <= metrics["search_host_ms"])
    sp = prog["spans"]
    inclusive = inclusive_device_s(events, lo, hi)
    if "als.normal_eq" in sp:
        parts = inclusive.get("als.normal_eq", 0.0) + sum(
            sp.get(n, {}).get("device_s", 0.0) for n in ("spd.schur", "spd.leaf"))
        checks["als_parts_within_busy"] = parts <= prog["busy_s"]
        if view.work.get("epochs"):
            readings["als_normal_eq_ms.inclusive"] = (
                1e3 * inclusive.get("als.normal_eq", 0.0) / view.work["epochs"])
    if prog["busy_s"] > 0:
        attributed = total(prog, "device_s") + prog["outside"]["device_s"]
        checks["device_rel_gap"] = abs(attributed - prog["busy_s"]) / prog["busy_s"]
    return {"workload": name, "seed": seed, "units": units, "result": result,
            "program": prog,
            "per_unit": {n: r["count"] / units for n, r in sorted(sp.items())},
            "span_readings": readings, "checks": checks,
            "inclusive_device_s": inclusive,
            "kernels_by_span": kernels_by_span(events, lo, hi)}


def span_cost(n: int = 100_000) -> dict:
    """Host microseconds a span is entered and left, with and without a
    profiler recording."""
    import torch
    from torch.autograd.profiler import record_function
    from torch.profiler import ProfilerActivity, profile

    from matrix_factorization_tpu_torch.utils.profiling import _RecordFunctionFast, span

    def per_span(make, count):
        t0 = time.perf_counter()
        for _ in range(count):
            with make("sgd.step"):
                pass
        return (time.perf_counter() - t0) / count * 1e6

    out = {"torch": torch.__version__,
           "span_off_us": per_span(span, n),
           "record_function_off_us": per_span(record_function, n // 10)}
    with profile(activities=[ProfilerActivity.CPU]):
        m = n // 10
        out["span_on_us"] = per_span(span, m)
        out["record_function_on_us"] = per_span(record_function, m)
        out["record_function_fast_on_us"] = per_span(_RecordFunctionFast, m)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload")
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--cost", action="store_true")
    ap.add_argument("--out")
    a = ap.parse_args(argv)
    out = span_cost() if a.cost else trace_cell(a.workload, a.seed)
    line = json.dumps(out)
    if a.out:
        with open(a.out, "a") as f:
            f.write(line + "\n")
    brief = out if a.cost else {k: out[k] for k in ("workload", "seed", "units",
                                                    "per_unit", "span_readings",
                                                    "checks", "inclusive_device_s",
                                                    "kernels_by_span")}
    print(json.dumps(brief))
    return 0


if __name__ == "__main__":
    sys.exit(main())
