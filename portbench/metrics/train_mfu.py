"""``train_mfu``: the whole training epoch's share of the chip's peak.

The least time an epoch could take on one H100 (the larger of its
necessary operations at 67 TFLOP/s f32 and its necessary bytes at
3.35 TB/s, counted by the driver from the data, independent of the code:
``roofline.sgd_epoch_work``, ``roofline.als_epoch_work``) over the
measured epoch time (the traced window's seconds on the trace's timeline,
over its epochs), in percent."""

from portbench.roofline import least_seconds


def read(t, cell):
    w = t.work
    if not w.get("epochs") or "epoch_flops" not in w:
        return None
    least, _ = least_seconds(w["epoch_flops"], w["epoch_bytes"])
    return 100.0 * least * w["epochs"] / t.window_s
