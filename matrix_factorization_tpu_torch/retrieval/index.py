"""Item index containers and their on-disk artifact schema (a copy of
``matrix_factorization_tpu/retrieval/index.py``).

Artifact schema matches the reference so pipelines interoperate
(``build_tfidf_index.py:42-52`` / ``export_artifacts.py:28-33``):
``{'index_type': 'tfidf', item_ids, texts, vectorizer, matrix}`` or
``{item_ids, texts, embeddings}`` pickles of plain containers (numpy,
scipy, the sklearn vectorizer), so an index written by either package
loads in the other. The port reads them with ``core.artifacts``'
unpickler. The device copy of a dense index lives in
``retrieval.search``'s cache, never in the index.
"""

from __future__ import annotations

import pickle
from dataclasses import dataclass
from pathlib import Path
from typing import List, Union

import numpy as np

from matrix_factorization_tpu_torch.core.artifacts import load_pickle


@dataclass(frozen=True, eq=False)  # identity hash: weak-cacheable
class DenseItemIndex:
    """L2-normalized float32 embeddings (reference retrieval.py:12-17)."""

    item_ids: list
    texts: List[str]
    embeddings: np.ndarray  # (n_items, dim), normalized


@dataclass(frozen=True)
class TfidfItemIndex:
    """Sparse TF-IDF matrix + fitted vectorizer (retrieval.py:19-25)."""

    item_ids: list
    texts: List[str]
    vectorizer: object
    matrix: object  # scipy.sparse.csr_matrix


ItemIndexT = Union[DenseItemIndex, TfidfItemIndex]


def load_item_index(path: Path) -> ItemIndexT:
    obj = load_pickle(path)
    if obj.get("index_type", "dense") == "tfidf":
        return TfidfItemIndex(
            item_ids=obj["item_ids"],
            texts=obj["texts"],
            vectorizer=obj["vectorizer"],
            matrix=obj["matrix"],
        )
    return DenseItemIndex(
        item_ids=obj["item_ids"],
        texts=obj["texts"],
        embeddings=np.asarray(obj["embeddings"], dtype=np.float32),
    )


def save_item_index(index: ItemIndexT, path: Path) -> None:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    if isinstance(index, TfidfItemIndex):
        obj = {
            "index_type": "tfidf",
            "item_ids": index.item_ids,
            "texts": index.texts,
            "vectorizer": index.vectorizer,
            "matrix": index.matrix,
        }
    else:
        obj = {
            "index_type": "dense",
            "item_ids": index.item_ids,
            "texts": index.texts,
            "embeddings": index.embeddings,
        }
    with path.open("wb") as f:
        pickle.dump(obj, f)


def build_tfidf_index(
    item_ids: list,
    texts: List[str],
    max_features: int = 50_000,
    min_df: int = 2,
) -> TfidfItemIndex:
    """Fit a TF-IDF index (reference build_tfidf_index.py:32-52 settings:
    max_features=50k, min_df=2, l2 norm). Needs sklearn (an optional
    package); any object whose ``transform(texts)`` gives l2-normalized
    CSR rows over the matrix's columns serves as a vectorizer."""
    from sklearn.feature_extraction.text import TfidfVectorizer

    vectorizer = TfidfVectorizer(
        max_features=max_features, min_df=min_df, norm="l2"
    )
    matrix = vectorizer.fit_transform(texts)
    return TfidfItemIndex(
        item_ids=list(item_ids), texts=list(texts), vectorizer=vectorizer,
        matrix=matrix,
    )


def build_dense_index(
    item_ids: list,
    texts: List[str],
    embeddings: np.ndarray,
    normalize: bool = True,
) -> DenseItemIndex:
    emb = np.asarray(embeddings, np.float32)
    if normalize:
        norms = np.linalg.norm(emb, axis=1, keepdims=True)
        emb = emb / np.maximum(norms, 1e-12)
    return DenseItemIndex(item_ids=list(item_ids), texts=list(texts),
                          embeddings=emb)
