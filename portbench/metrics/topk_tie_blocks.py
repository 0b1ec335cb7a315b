"""``topk_tie_blocks``: row blocks a search call whose top-k took the tie
branch: a second pass over the rows where more than k scores lie at or
above the k-th.

``ops/scoring.py::_select_topk`` calls ``nonzero`` once a block of rows; a
block with such a row takes those rows again (a wider ``torch.topk``, or
past ``SELECT_MAX_TIED`` tied scores a whole-row sort) and writes them
back into the block's answers, two ``index_put_`` calls. Counted from the
host operators of the traced calls; nothing to read where no block took
the selection body (the whole-row sort of a small block has no tie
branch)."""


def read(t, cell):
    blocks = t.host_calls.get("aten::nonzero", 0)
    if not blocks or not t.work.get("calls"):
        return None
    return t.host_calls.get("aten::index_put_", 0) / 2 / t.work["calls"]
