"""``sgd_apply_roofline``: the secondary apply kernel's share of its
roofline.

The least time of every apply launch of the traced epochs
(``roofline.sgd_bounds``) over the device time of the kernels of
``mf_segment_apply`` (``csrc/segment_sum.cu``: ``apply_chunk_kernel`` and
``apply_finish_kernel``), in percent."""

KERNELS = r"apply_chunk_kernel|apply_finish_kernel"


def read(t, cell):
    bound = t.work.get("sgd_apply_bound_s")
    spent = t.kernel_seconds(KERNELS)
    if not bound or spent <= 0:
        return None
    return 100.0 * bound / spent
