"""Retrieval: item indexes (dense + TF-IDF), query encoding, top-k search
(PyTorch port of ``matrix_factorization_tpu/retrieval``).

Reference: ``project_template/app/retrieval.py`` (two index types behind
one interface, dot-product scoring + argpartition top-k). Dense scoring and
its top-k run on the GPU (an f32 product and a top-k that breaks ties by
position); TF-IDF single queries score on the host, batches on the GPU
through dense vocab blocks (``sparse_scoring``).
"""

from matrix_factorization_tpu_torch.retrieval.index import (
    DenseItemIndex,
    TfidfItemIndex,
    load_item_index,
    save_item_index,
)
from matrix_factorization_tpu_torch.retrieval.search import (
    encode_query_for_index,
    search_topk,
    search_topk_pos,
)
