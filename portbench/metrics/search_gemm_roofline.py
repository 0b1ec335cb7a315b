"""``search_gemm_roofline``: the exact f32 score product's share of its
roofline.

The least time of the (B, N) score product of every traced call
(``roofline.gemm_work``) over the device time of the GEMM and GEMV kernels
(cuBLAS names: ``gemm``, ``gemv``), in percent."""

from portbench.roofline import least_seconds

KERNELS = r"(?i)gemm|gemv"


def read(t, cell):
    w = t.work
    spent = t.kernel_seconds(KERNELS)
    if not w.get("calls") or "gemm_work" not in w or spent <= 0:
        return None
    least, _ = least_seconds(*w["gemm_work"])
    return 100.0 * least * w["calls"] / spent
