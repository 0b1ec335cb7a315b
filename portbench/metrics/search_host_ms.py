"""``search_host_ms``: the host's side of a search call, in milliseconds.

Per traced call, the host seconds of the call (the harness's span around
it) in which the device ran nothing: the query's copy and the launches
before the device starts, the result's copy back and the Python around
them."""


def read(t, cell):
    calls = [(a, b) for n, a, b in t.spans if n == "unit"]
    if not calls or not t.work.get("calls"):
        return None
    wall = sum(b - a for a, b in calls)
    return 1e3 * (wall - t.busy_in_spans.get("unit", 0.0)) / len(calls)
