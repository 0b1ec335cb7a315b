"""Artifact-backed recommendation service (PyTorch port of
``matrix_factorization_tpu/serve/service.py``).

Reference: ``project_template/app/api.py`` — loads pickled artifacts at
startup (``:57-72``), ``/recommend`` = retrieval + min-maxed hybrid blend
(``:90-134``), soft degradation: model scores fall back to zeros on any
exception (``:43-52``), missing artifacts produce actionable errors
(``:92-98``).

``model.pkl`` is a whole-model pickle, as the JAX pipeline writes it
(``pipeline/train.py:106``). The port's models pickle host tensors and
load onto the service's ``device``; the artifacts are read with
``core.artifacts.load_pickle``, which loads a JAX ``reranker.pkl`` into the
port's reranker and refuses a JAX-pickled model (jax arrays): the service
then serves retrieval only, as for any model that fails to load.
"""

from __future__ import annotations

import pickle
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np

from matrix_factorization_tpu_torch.core.artifacts import load_pickle
from matrix_factorization_tpu_torch.core.device import resolve_device
from matrix_factorization_tpu_torch.rank.hybrid import blend, model_scores
from matrix_factorization_tpu_torch.retrieval.index import (
    TfidfItemIndex,
    load_item_index,
)
from matrix_factorization_tpu_torch.retrieval.search import (
    encode_query_for_index,
    search_topk,
)


def _load_optional(path: Path, device):
    """The artifact at ``path``, or None when it is absent or fails to
    load (the service degrades instead of failing to start)."""
    if not path.exists():
        return None
    try:
        return load_pickle(path, device)
    except (pickle.UnpicklingError, EOFError, AttributeError, ImportError,
            IndexError, KeyError, TypeError, ValueError, RuntimeError):
        return None


@dataclass
class RecommendService:
    index: Any
    model: Optional[Any] = None
    reranker: Optional[Dict] = None
    meta: Optional[Any] = None  # pd.DataFrame indexed by str(item_id)
    device: Any = None  # where dense retrieval scores (None = CUDA)

    @classmethod
    def from_artifacts(
        cls,
        artifacts_dir: Path,
        features_dir: Optional[Path] = None,
        device=None,
    ) -> "RecommendService":
        """Load ``item_index.pkl`` (required), ``model.pkl`` and
        ``reranker.pkl`` (optional) from ``artifacts_dir``, and
        ``recipe_meta.parquet`` from ``features_dir``; the model's tensors
        and the dense index's device copy go to ``device`` (``None`` =
        CUDA)."""
        resolve_device(device)  # no GPU for device=None: raise, not degrade
        artifacts_dir = Path(artifacts_dir)
        index_path = artifacts_dir / "item_index.pkl"
        if not index_path.exists():
            raise FileNotFoundError(
                f"Missing {index_path}. Build it first, e.g.: python -m "
                "matrix_factorization_tpu.pipeline.build_tfidf_index"
            )
        index = load_item_index(index_path)
        model = _load_optional(artifacts_dir / "model.pkl", device)
        reranker = _load_optional(artifacts_dir / "reranker.pkl", device)

        meta = None
        if features_dir is not None:
            meta_path = Path(features_dir) / "recipe_meta.parquet"
            if meta_path.exists():
                import pandas as pd

                meta = pd.read_parquet(meta_path)
                meta["item_id"] = meta["item_id"].astype(str)
                meta = meta.set_index("item_id")
        return cls(index=index, model=model, reranker=reranker, meta=meta,
                   device=device)

    # -- endpoints -----------------------------------------------------------
    def health(self) -> Dict[str, Any]:
        return {
            "status": "ok",
            "index_type": "tfidf" if isinstance(self.index, TfidfItemIndex)
            else "dense",
            "n_items": len(self.index.item_ids),
            "has_model": self.model is not None,
            "has_reranker": self.reranker is not None,
        }

    def recommend(
        self,
        query: str,
        user_id: Optional[Any] = None,
        k: int = 10,
        candidate_k: int = 100,
        alpha: float = 0.5,
        embedding_model: Optional[str] = None,
    ) -> List[Dict[str, Any]]:
        k = max(1, min(int(k), 50))  # request bounds (reference api.py:16-26)
        candidate_k = max(k, min(int(candidate_k), 500))
        qvec = encode_query_for_index(self.index, query,
                                      model_name=embedding_model)
        candidates = search_topk(self.index, qvec, k=candidate_k,
                                 device=self.device)
        if not candidates:
            return []
        ids = [c[0] for c in candidates]
        sims = np.asarray([c[1] for c in candidates], np.float32)
        ms = model_scores(self.model, user_id, ids)
        score = blend(ms, sims, alpha)
        order = np.argsort(-score)[:k]
        reason = (
            f"hybrid: {alpha:.2f}*model + {1 - alpha:.2f}*similarity"
            if (user_id is not None and self.model is not None)
            else "embedding similarity recall"
        )
        return [
            {"item_id": ids[int(i)], "score": float(score[int(i)]),
             "reason": reason}
            for i in order
        ]
