"""``topk_roofline``: the top-k's share of its roofline.

The least time of reading every traced call's (B, N) scores once and
writing its (B, k) answers once (``roofline.topk_work``) over the device
time of the call's kernels that are not the score product
(``ops/scoring.py::stable_topk``'s sort or selection body), in percent."""

from portbench.roofline import least_seconds

GEMM = r"(?i)gemm|gemv"


def read(t, cell):
    w = t.work
    spent = t.kernel_seconds(r".", exclude=GEMM)
    if not w.get("calls") or "topk_work" not in w or spent <= 0:
        return None
    least, _ = least_seconds(*w["topk_work"])
    return 100.0 * least * w["calls"] / spent
