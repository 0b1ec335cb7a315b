"""``search_mfu``: the whole search call's share of the chip's peak.

The least time of one exact search (``roofline.search_work``: 2 B N D
operations at 67 TFLOP/s f32, or the catalog, the queries and the (B, k)
answers moved once at 3.35 TB/s) over the measured call time (the traced
window's seconds on the trace's timeline, over its calls), in percent."""

from portbench.roofline import least_seconds


def read(t, cell):
    w = t.work
    if not w.get("calls") or "call_work" not in w:
        return None
    least, _ = least_seconds(*w["call_work"])
    return 100.0 * least * w["calls"] / t.window_s
