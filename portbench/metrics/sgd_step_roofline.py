"""``sgd_step_roofline``: the SGD step kernel's share of its roofline.

The least time of every step launch of the traced epochs
(``roofline.sgd_bounds`` on each batch's runs, summed by the driver) over
the device time of the kernels of ``mf_sgd_step`` (``csrc/sgd_step.cu``:
``sgd_step_kernel`` and ``step_finish_kernel``), in percent."""

KERNELS = r"sgd_step_kernel|step_finish_kernel"


def read(t, cell):
    bound = t.work.get("sgd_step_bound_s")
    spent = t.kernel_seconds(KERNELS)
    if not bound or spent <= 0:
        return None
    return 100.0 * bound / spent
