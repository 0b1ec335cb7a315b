"""The program's own spans in a traced window: where the device's time and
the device's idle time go, by the port's ``mf:`` spans
(``matrix_factorization_tpu_torch/utils/profiling.py`` lists them).

``reduce_program(events, lo, hi)`` reads the Chrome trace that
``trace.reduce_trace`` reads, over the same window (``lo``, ``hi``: the
trace's microseconds, ``harness_window``). A span is a ``cpu_op`` event
named with the program's prefix (``utils.profiling.SPAN_PREFIX``). Spans nest, so the span
that holds a time innermost is the open one that started last. For each
span name:

* ``count``: the spans that start in the window; ``host_s``: their summed
  seconds inside it;
* ``device_s``, ``kernel_s``: the seconds of the device intervals
  (kernels, copies and memsets for ``device_s``; kernels alone for
  ``kernel_s``) whose launching runtime call lies innermost in a span of
  that name; an interval is matched to its launch by ``args.correlation``;
* ``idle_s``: the window's device-idle seconds whose gap middle lies
  innermost in a span of that name; every gap counts.

``outside`` holds the device and idle seconds under no span (or, for a
device interval, with no launch in the trace), so that the spans and
``outside`` add up to the window's busy seconds (``busy_s``, the union of
the device intervals; the sums equal it where no two intervals overlap, as
on one stream) and idle seconds (``idle_s``).

``span_readings(view, program)`` turns a ``trace.TraceView`` and this
reduction into the per-layer readings of the spans (the module's table
below), each ``None`` where its cell has nothing to read.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from matrix_factorization_tpu_torch.utils.profiling import SPAN_PREFIX as PROGRAM_PREFIX
from portbench.roofline import least_seconds
from portbench.trace import DEVICE_CATS, SPAN_PREFIX, _union
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def _innermost(spans: Sequence[Tuple[float, float, str]],
               times: Sequence[float]) -> List[int]:
    """For each of ``times`` (any order), the index in ``spans`` (nested
    (start, end, name), by start) of the innermost span that holds it, or
    -1: one sweep with a stack of the open spans."""
    out = [-1] * len(times)
    stack: List[int] = []
    j = 0
    for q in sorted(range(len(times)), key=times.__getitem__):
        t = times[q]
        while j < len(spans) and spans[j][0] <= t:
            while stack and spans[stack[-1]][1] < spans[j][0]:
                stack.pop()
            stack.append(j)
            j += 1
        while stack and spans[stack[-1]][1] < t:
            stack.pop()
        out[q] = stack[-1] if stack else -1
    return out


def reduce_program(events: list, lo: float, hi: float) -> dict:
    """``{"spans": {name: {count, host_s, device_s, kernel_s, idle_s}},
    "outside": {device_s, kernel_s, idle_s}, "busy_s", "idle_s"}`` of the
    window [lo, hi] (microseconds); names without the ``mf:`` prefix."""
    spans = sorted((e["ts"], e["ts"] + e["dur"], e["name"][len(PROGRAM_PREFIX):])
                   for e in events if e.get("ph") == "X"
                   and e.get("cat") == "cpu_op"
                   and e.get("name", "").startswith(PROGRAM_PREFIX))
    launch = {e["args"]["correlation"]: e["ts"] for e in events
              if e.get("ph") == "X" and e.get("cat") in LAUNCH_CATS
              and "correlation" in e.get("args", {})}
    device = []
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
            continue
        a, b = max(e["ts"], lo), min(e["ts"] + e["dur"], hi)
        if b > a:
            device.append((a, b, e["cat"] == "kernel",
                           launch.get(e.get("args", {}).get("correlation"))))
    device.sort()

    def row() -> Dict[str, float]:
        return {"count": 0, "host_s": 0.0, "device_s": 0.0, "kernel_s": 0.0,
                "idle_s": 0.0}

    out: Dict[str, Dict[str, float]] = {}
    for s, e, name in spans:
        r = out.setdefault(name, row())
        if lo <= s <= hi:
            r["count"] += 1
        r["host_s"] += max(0.0, min(e, hi) - max(s, lo)) / 1e6
    outside = {"device_s": 0.0, "kernel_s": 0.0, "idle_s": 0.0}

    def into(ix: int) -> Dict[str, float]:
        return outside if ix < 0 else out[spans[ix][2]]

    with_launch = [d for d in device if d[3] is not None]
    for (a, b, is_kernel, _), ix in zip(
            with_launch, _innermost(spans, [d[3] for d in with_launch])):
        r = into(ix)
        r["device_s"] += (b - a) / 1e6
        if is_kernel:
            r["kernel_s"] += (b - a) / 1e6
    for a, b, is_kernel, t in device:
        if t is None:
            outside["device_s"] += (b - a) / 1e6
            if is_kernel:
                outside["kernel_s"] += (b - a) / 1e6

    busy = _union([(a, b, None) for a, b, _, _ in device])
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    gaps = [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]
    for (a, b), ix in zip(gaps, _innermost(spans, [(a + b) / 2 for a, b in gaps])):
        into(ix)["idle_s"] += (b - a) / 1e6
    busy_s = sum(b - a for a, b in busy) / 1e6
    return {"spans": out, "outside": outside, "busy_s": busy_s,
            "idle_s": (hi - lo) / 1e6 - busy_s}


def total(program: dict, key: str, prefix: str = "") -> float:
    """``key`` summed over the spans whose name starts with ``prefix``."""
    return sum(r[key] for n, r in program["spans"].items() if n.startswith(prefix))


def _share(least_s: float, spent_s: float) -> Optional[float]:
    return 100.0 * least_s / spent_s if least_s and spent_s > 0 else None


def span_readings(view, program: dict) -> Dict[str, Optional[float]]:
    """The spans' per-layer readings of a traced window (``view``: its
    ``trace.TraceView``, whose ``work`` the cell's driver counted):

    ================================  ==========================================
    ``sgd_step_roofline.span``        step bound over kernel s under ``sgd.step``
    ``sgd_apply_roofline.span``       apply bound over kernel s under ``sgd.apply``
    ``gj_roofline.span``              leaf bound over kernel s under ``spd.leaf``
    ``search_gemm_roofline.span``     product bound over kernel s, ``search.gemm``
    ``topk_roofline.span``            top-k bound over kernel s, every ``topk.*``
    ``topk_tie_blocks.span``          ``topk.ties`` spans a call (with ``topk.select``)
    ``search_idle_program_ms``        device-idle ms a call inside any span
    ``topk_idle_ms``                  the same inside the ``topk.*`` spans
    ``als_normal_eq_ms``              device ms an epoch under ``als.normal_eq``
    ``als_schur_ms``                  device ms an epoch under ``spd.schur`` itself
    ================================  ==========================================

    The rooflines have the name-matching readers' ``work`` and formulas."""
    w, sp = view.work, program["spans"]

    def get(name: str, key: str) -> float:
        return sp.get(name, {}).get(key, 0.0)

    calls, epochs = w.get("calls"), w.get("epochs")
    out: Dict[str, Optional[float]] = {
        "sgd_step_roofline.span": _share(w.get("sgd_step_bound_s"),
                                         get("sgd.step", "kernel_s")),
        "sgd_apply_roofline.span": _share(w.get("sgd_apply_bound_s"),
                                          get("sgd.apply", "kernel_s")),
        "gj_roofline.span": _share(w.get("gj_bound_s"), get("spd.leaf", "kernel_s")),
    }
    out.update(dict.fromkeys(("search_gemm_roofline.span", "topk_roofline.span",
                              "topk_tie_blocks.span", "search_idle_program_ms",
                              "topk_idle_ms", "als_normal_eq_ms", "als_schur_ms")))
    if calls:
        if "gemm_work" in w:
            out["search_gemm_roofline.span"] = _share(
                least_seconds(*w["gemm_work"])[0] * calls,
                get("search.gemm", "kernel_s"))
        if "topk_work" in w:
            out["topk_roofline.span"] = _share(
                least_seconds(*w["topk_work"])[0] * calls,
                total(program, "kernel_s", "topk."))
        if get("topk.select", "count"):
            out["topk_tie_blocks.span"] = get("topk.ties", "count") / calls
        if sp:
            out["search_idle_program_ms"] = 1e3 * total(program, "idle_s") / calls
            out["topk_idle_ms"] = 1e3 * total(program, "idle_s", "topk.") / calls
    if epochs and "als.normal_eq" in sp:
        out["als_normal_eq_ms"] = 1e3 * get("als.normal_eq", "device_s") / epochs
        out["als_schur_ms"] = 1e3 * get("spd.schur", "device_s") / epochs
    return out


def harness_window(events: list) -> Tuple[float, float]:
    """``reduce_trace``'s window in the trace's microseconds: from the
    first of the harness's spans to the end of the last."""
    spans = [(e["ts"], e["ts"] + e["dur"]) for e in events if e.get("ph") == "X"
             and e.get("cat") == "user_annotation"
             and e["name"].startswith(SPAN_PREFIX)]
    return min(a for a, _ in spans), max(b for _, b in spans)
