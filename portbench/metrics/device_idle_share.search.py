"""``device_idle_share.search``: the share of the traced search window
in which no kernel, copy or memset ran on the device (the host's side of
each call and the caller between calls), in percent."""


def read(t, cell):
    if not t.work.get("calls") or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
