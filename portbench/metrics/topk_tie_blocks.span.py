"""``topk_tie_blocks.span``: row blocks a search call whose top-k took the
tie branch, counted from the program's own spans.

``ops/scoring.py::_select_topk`` opens the ``mf:topk.ties`` span once for
each block that has a row tied across the k-th score, inside the block's
``mf:topk.select`` span (``utils/profiling.py``); the trace records both
as host operators. The count over the traced calls, per call; nothing to
read where no block took the selection body, or where the program records
no spans. The twin of ``topk_tie_blocks``, which infers the same count
from the aten operators that the branch happens to call."""

from matrix_factorization_tpu_torch.utils import profiling


def read(t, cell):
    # a program older than its spans has no prefix, and nothing to read
    prefix = getattr(profiling, "SPAN_PREFIX", None)
    if prefix is None or not t.host_calls.get(prefix + "topk.select") \
            or not t.work.get("calls"):
        return None
    return t.host_calls.get(prefix + "topk.ties", 0) / t.work["calls"]
