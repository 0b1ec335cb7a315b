"""Query/document embedding encoders (a copy of
``matrix_factorization_tpu/retrieval/encode.py``; ``hash_embed`` gives the
same bytes).

The reference uses sentence-transformers (``retrieval.py:45-67``), which
needs downloaded weights; the encoder stack here is layered:

1. ``transformer`` — mean-pooled hidden states from a HuggingFace
   ``AutoModel`` if the package + weights are available (gated import).
2. ``hash`` — a deterministic, dependency-free hashed bag-of-ngrams
   embedding (unigram+bigram feature hashing with sign hashing, L2
   normalized).  Quality is below a trained sentence encoder but it is
   hermetic, fast, and adequate for structural/flow testing and as an
   offline fallback — the same role the reference's `keywords` judge plays
   for its LLM judge (``evaluate_llm.py:159-187``).
"""

from __future__ import annotations

import hashlib
import re
from functools import lru_cache
from typing import List, Optional

import numpy as np

_TOKEN_RE = re.compile(r"[a-z0-9一-鿿]+")


def _tokens(text: str) -> List[str]:
    return _TOKEN_RE.findall(text.lower())


def hash_embed(texts: List[str], dim: int = 512) -> np.ndarray:
    """Hashed bag-of-ngrams embedding, L2 normalized, deterministic."""
    out = np.zeros((len(texts), dim), np.float32)
    for row, text in enumerate(texts):
        toks = _tokens(text)
        grams = toks + [f"{a}_{b}" for a, b in zip(toks, toks[1:])]
        for g in grams:
            h = int.from_bytes(
                hashlib.blake2b(g.encode(), digest_size=8).digest(), "little"
            )
            idx = h % dim
            sign = 1.0 if (h >> 63) & 1 else -1.0
            out[row, idx] += sign
    norms = np.linalg.norm(out, axis=1, keepdims=True)
    return out / np.maximum(norms, 1e-12)


@lru_cache(maxsize=4)
def _get_transformer(model_name: str):
    import torch  # noqa: F401
    from transformers import AutoModel, AutoTokenizer

    tok = AutoTokenizer.from_pretrained(model_name)
    model = AutoModel.from_pretrained(model_name)
    model.eval()
    return tok, model


def transformer_embed(
    texts: List[str], model_name: str, batch_size: int = 32
) -> np.ndarray:
    """Mean-pooled transformer embeddings, L2 normalized (CPU torch)."""
    import torch

    tok, model = _get_transformer(model_name)
    chunks = []
    with torch.no_grad():
        for lo in range(0, len(texts), batch_size):
            batch = texts[lo : lo + batch_size]
            enc = tok(batch, padding=True, truncation=True, max_length=256,
                      return_tensors="pt")
            hidden = model(**enc).last_hidden_state
            mask = enc["attention_mask"].unsqueeze(-1).float()
            emb = (hidden * mask).sum(1) / mask.sum(1).clamp(min=1e-9)
            chunks.append(emb.numpy())
    out = np.concatenate(chunks).astype(np.float32)
    norms = np.linalg.norm(out, axis=1, keepdims=True)
    return out / np.maximum(norms, 1e-12)


def embed_texts(
    texts: List[str],
    model_name: Optional[str] = None,
    dim: int = 512,
) -> np.ndarray:
    """Best-available embedding: transformer if a model_name is given and
    loadable, else the hermetic hash embedding."""
    if model_name and model_name != "hash":
        try:
            return transformer_embed(texts, model_name)
        except Exception:
            pass  # no package or weights: fall through to the hermetic encoder
    return hash_embed(texts, dim=dim)
