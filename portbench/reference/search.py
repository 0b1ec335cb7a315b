"""Plain exact dense search, in PyTorch, for the benchmark's comparison.
Nothing here comes from the program.

``exact_scores`` recomputes the score of given (query, row) pairs in
float64; ``topk_scores`` takes the k best float64 scores of each query
over the whole catalog, in blocks of rows and of queries. ``search`` is
the control: the scores in float32 with TF32 allowed in the product, and
the top k under the one tie rule (score descending, then position
ascending) by a stable sort.
"""

from __future__ import annotations

import torch

ROW_BLOCK = 1 << 18
QUERY_BLOCK = 256


def exact_scores(emb: torch.Tensor, q: torch.Tensor, pos: torch.Tensor,
                 chunk: int = 64) -> torch.Tensor:
    """(B, k) float64 scores of query b against row ``pos[b, j]``."""
    out = []
    for lo in range(0, q.shape[0], chunk):
        rows = emb[pos[lo:lo + chunk].long()].double()
        out.append((rows * q[lo:lo + chunk, None, :].double()).sum(-1))
    return torch.cat(out)


def topk_scores(emb: torch.Tensor, q: torch.Tensor, k: int) -> torch.Tensor:
    """(B, k) float64 best scores of each query, descending."""
    out = []
    for qlo in range(0, q.shape[0], QUERY_BLOCK):
        qb = q[qlo:qlo + QUERY_BLOCK].double()
        best = None
        for lo in range(0, emb.shape[0], ROW_BLOCK):
            s = qb @ emb[lo:lo + ROW_BLOCK].double().T
            cand = torch.topk(s, min(k, s.shape[1]), dim=1).values
            best = cand if best is None else torch.topk(
                torch.cat([best, cand], 1), k, dim=1).values
        out.append(best)
    return torch.cat(out)


def search(emb: torch.Tensor, q: torch.Tensor, k: int):
    """The control's (B, k) scores and positions: float32 scores with TF32
    allowed, then the stable top k."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        vals, idx = [], []
        for lo in range(0, q.shape[0], 64):
            s = q[lo:lo + 64].float() @ emb.T
            order = torch.sort(s, dim=1, descending=True, stable=True).indices[:, :k]
            vals.append(s.gather(1, order))
            idx.append(order)
        return torch.cat(vals), torch.cat(idx)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
