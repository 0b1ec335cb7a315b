"""``device_idle_share.train``: the share of the traced training window
in which no kernel, copy or memset ran on the device (waiting on the
host), in percent."""


def read(t, cell):
    if not t.work.get("epochs") or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
