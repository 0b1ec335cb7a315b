"""``gj_roofline``: the Gauss-Jordan SPD leaf's share of its roofline.

The least time of the traced epochs' leaf inverses (``roofline.spd_bound``
of every solved entity's two Schur leaves, summed by the driver) over the
device time of ``gj_inverse_kernel`` (``csrc/spd_gj.cu``), in percent."""

KERNELS = r"gj_inverse_kernel"


def read(t, cell):
    bound = t.work.get("gj_bound_s")
    spent = t.kernel_seconds(KERNELS)
    if not bound or spent <= 0:
        return None
    return 100.0 * bound / spent
