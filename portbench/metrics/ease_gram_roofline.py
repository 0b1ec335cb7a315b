"""``ease_gram_roofline``: the EASE gram's share of its roofline.

The least time of the traced fits' grams (``roofline_ease.gram_least_s``:
the symmetric half of the slab product over the real users at 1,979 TOP/s
int8, or its bytes at 3.35 TB/s; summed by the driver as
``ease_gram_bound_s``) over the device time of the gram kernels
(``csrc/ease_gram.cu``: ``ease_gram_slab_kernel``, ``ease_gram_tile_kernel``,
``ease_gram_finish_kernel``), in percent. Nothing to read where the program
recorded no ``ease.gram`` span, or ran no gram kernel (the f32 path, the
CPU). A gram that skips empty tiles could read over 100%: it needs a
``benchmark`` PR to recount the least work first."""

from matrix_factorization_tpu_torch.utils import profiling

KERNELS = r"ease_gram_"


def read(t, cell):
    prefix = getattr(profiling, "SPAN_PREFIX", None)
    if prefix is None or not t.host_calls.get(prefix + "ease.gram"):
        return None
    bound = t.work.get("ease_gram_bound_s")
    spent = t.kernel_seconds(KERNELS)
    if not bound or spent <= 0:
        return None
    return 100.0 * bound / spent
