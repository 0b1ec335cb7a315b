"""Weak-supervision reranker: 17 hand features + logistic regression
(PyTorch port of ``matrix_factorization_tpu/rank/reranker.py``).

Reference: ``project_template/pipeline/train_reranker.py`` — queries are
synthesized from seed items (``:169-219``), the seed's retrieval hit is the
positive, hard negatives come from the same top-k (``:284-296``), features
are 17 interpretable columns (``:60-101``), and the classifier is a
balanced logistic regression (``:305-306``).

``keyword_overlap``, ``featurize``, ``generate_queries`` and
``rerank_scores`` are copies. The JAX package's two optax models become
:class:`TorchLogisticRegression` and :class:`TorchMLPReranker`, trained
full-batch with ``torch.optim.Adam`` on the device (``device=None`` =
CUDA). They keep the JAX models' serving API (``predict_proba``,
``decision_function``, ``predict``, all numpy on the host), attribute
names and numpy state (``coef_``, ``intercept_``, ``_mean``, ``_scale``,
``_params``), so a reranker payload crosses between the packages
(``core.artifacts``).
"""

from __future__ import annotations

import random
import re
from typing import Dict, List, Optional, Tuple

import numpy as np
import pandas as pd
import torch
import torch.nn.functional as F

from matrix_factorization_tpu_torch.core.device import resolve_device

from matrix_factorization_tpu_torch.rank.recipe_features import (
    compute_flags,
    compute_low_calorie_score,
    compute_protein_score,
    extract_directions_text,
    extract_ingredient_phrases,
    extract_time_minutes,
    parse_query_intent,
)
from matrix_factorization_tpu_torch.rank.filters import parse_time_constraint_from_query

FEATURE_NAMES = [
    "sim",
    "kw_overlap",
    "has_dairy",
    "has_peanut",
    "has_tree_nuts",
    "has_egg",
    "has_wheat",
    "has_soy",
    "has_fish",
    "has_shellfish",
    "time_min",
    "time_ok",
    "protein_score",
    "protein_ok",
    "low_calorie_score",
    "low_calorie_ok",
    "ingredients_count",
]


def keyword_overlap(query: str, text: str) -> float:
    """Fraction of the first 20 query tokens present in the item text."""
    q_terms = [t for t in re.split(r"\W+", (query or "").lower()) if t]
    if not q_terms:
        return 0.0
    hay = (text or "").lower()
    hit = sum(1 for t in q_terms[:20] if t in hay)
    return float(hit / max(1, min(20, len(q_terms))))


def featurize(
    query: str,
    item_text: str,
    sim: float,
    meta_row: Optional[pd.Series] = None,
) -> np.ndarray:
    """The 17-feature row; metadata values override parsed ones when
    present (reference ``:104-166``)."""
    ing = extract_ingredient_phrases(item_text)
    flags = compute_flags(ing)
    tmin = extract_time_minutes(item_text)
    pscore = compute_protein_score(ing)
    low_score, _ = compute_low_calorie_score(
        ingredients=ing, directions=extract_directions_text(item_text)
    )
    if meta_row is not None:
        for col, caster in (
            ("time_min", int), ("protein_score", float),
            ("low_calorie_score", float),
        ):
            if col in meta_row and pd.notna(meta_row[col]):
                try:
                    v = caster(meta_row[col])
                    if col == "time_min":
                        tmin = v
                    elif col == "protein_score":
                        pscore = v
                    else:
                        low_score = v
                except Exception:
                    pass

    q_t = parse_time_constraint_from_query(query)
    time_ok = 1.0
    if q_t is not None and tmin is not None:
        time_ok = 1.0 if int(tmin) <= int(q_t) else 0.0

    intent = parse_query_intent(query)
    protein_ok = 1.0
    if intent.get("want_high_protein", False):
        protein_ok = 1.0 if float(pscore) >= 2.0 else 0.0
    low_cal_ok = 1.0
    if intent.get("want_low_calorie", False):
        low_cal_ok = 1.0 if float(low_score) >= 1.0 else 0.0

    return np.asarray(
        [
            float(sim),
            keyword_overlap(query, item_text),
            float(flags.has_dairy),
            float(flags.has_peanut),
            float(flags.has_tree_nuts),
            float(flags.has_egg),
            float(flags.has_wheat),
            float(flags.has_soy),
            float(flags.has_fish),
            float(flags.has_shellfish),
            float(tmin) if tmin is not None else -1.0,
            float(time_ok),
            float(pscore),
            float(protein_ok),
            float(low_score),
            float(low_cal_ok),
            float(len(ing)),
        ],
        dtype=np.float32,
    )


def generate_queries(item_text: str, rng: random.Random) -> List[str]:
    """Synthesize up to 4 realistic queries from a seed item
    (reference ``:169-219``): goal + meal (+ ingredient tokens), a timed
    variant, and no-dairy / no-nuts variants when the allergens apply."""
    ing = list(extract_ingredient_phrases(item_text))
    flags = compute_flags(ing)
    tmin = extract_time_minutes(item_text)

    tokens = []
    for x in ing:
        w = str(x).split(",")[0].strip()
        if 2 <= len(w) <= 24:
            tokens.append(w)
    rng.shuffle(tokens)
    tokens = tokens[:3]

    meal = rng.choice(["breakfast", "lunch", "dinner"])
    goal = rng.choice(["high protein", "low carb", "low sodium", "low calorie"])
    t = (
        rng.choice([20, 30, 45, 60])
        if tmin is None
        else (30 if tmin <= 30 else 45 if tmin <= 45 else 60)
    )

    base = f"{goal} {meal}"
    if tokens:
        base += " with " + " and ".join(tokens[:2])
    out = [base, base + f" under {t} minutes"]
    if flags.has_dairy:
        out.append(base + " no dairy")
    if flags.has_tree_nuts or flags.has_peanut:
        out.append(base + " no nuts")

    uniq, seen = [], set()
    for q in out:
        key = re.sub(r"\s+", " ", q.strip().lower())
        if key and key not in seen:
            seen.add(key)
            uniq.append(q.strip())
    return uniq[:4]


def _standardize_and_weigh(X, y):
    """Standardized features (mean, scale kept for serving) and the
    balanced class weights (reference: ``class_weight='balanced'``)."""
    X = np.asarray(X, np.float32)
    y = np.asarray(y, np.float32)
    mean = X.mean(axis=0)
    scale = np.maximum(X.std(axis=0), 1e-6)
    Xs = (X - mean) / scale
    n = Xs.shape[0]
    n_pos = max(1.0, float(y.sum()))
    n_neg = max(1.0, float(n - y.sum()))
    w = np.where(y > 0.5, n / (2 * n_pos), n / (2 * n_neg)).astype(np.float32)
    return Xs, y, w, mean, scale


def _bce(z, y, w):
    """Weighted mean sigmoid binary cross-entropy of logits ``z``."""
    ll = F.binary_cross_entropy_with_logits(z, y, reduction="none")
    return torch.mean(w * ll)


class TorchLogisticRegression:
    """Balanced binary logistic regression, full-batch Adam from zeros on
    the device (JAX: ``JaxLogisticRegression``, optax Adam).

    API-compatible with the sklearn estimator the reference pickles
    (coef_, intercept_, predict_proba, decision_function).
    """

    device = None  # the JAX model's pickled state has no device

    def __init__(self, max_iter: int = 500, lr: float = 0.1, l2: float = 1e-3,
                 device=None):
        self.max_iter = max_iter
        self.lr = lr
        self.l2 = l2
        self.device = device
        self.coef_: Optional[np.ndarray] = None
        self.intercept_: Optional[np.ndarray] = None
        self._mean: Optional[np.ndarray] = None
        self._scale: Optional[np.ndarray] = None

    def fit(self, X: np.ndarray, y: np.ndarray) -> "TorchLogisticRegression":
        dev = resolve_device(self.device)
        Xs, y, w, self._mean, self._scale = _standardize_and_weigh(X, y)
        Xt, yt, wt = (torch.from_numpy(a).to(dev) for a in (Xs, y, w))
        wv = torch.zeros(Xs.shape[1], dtype=torch.float32, device=dev,
                         requires_grad=True)
        b = torch.zeros((), dtype=torch.float32, device=dev, requires_grad=True)
        opt = torch.optim.Adam([wv, b], lr=self.lr)
        for _ in range(self.max_iter):
            opt.zero_grad(set_to_none=True)
            loss = _bce(Xt @ wv + b, yt, wt) + self.l2 * torch.sum(wv ** 2)
            loss.backward()
            opt.step()
        w_s = wv.detach().cpu().numpy()
        b_s = float(b.detach().cpu())
        # unfold standardization: w = w_s / scale; b = b_s - mean . w
        coef = w_s / self._scale
        self.coef_ = coef[None, :]
        self.intercept_ = np.asarray([b_s - float(self._mean @ coef)])
        return self

    def decision_function(self, X: np.ndarray) -> np.ndarray:
        return np.asarray(X, np.float32) @ self.coef_[0] + self.intercept_[0]

    def predict_proba(self, X: np.ndarray) -> np.ndarray:
        z = self.decision_function(X)
        p = 1.0 / (1.0 + np.exp(-z))
        return np.stack([1 - p, p], axis=1)

    def predict(self, X: np.ndarray) -> np.ndarray:
        return (self.decision_function(X) > 0).astype(np.int32)


class TorchMLPReranker:
    """One-hidden-layer MLP reranker, full-batch Adam on the device (JAX:
    ``JaxMLPReranker``). Same serving API and payload schema as
    :class:`TorchLogisticRegression`.

    The JAX model draws its first weights from ``jax.random``, which torch
    cannot reproduce: ``fit(init_params=)`` takes them given (``w1`` (d,
    h), ``b1`` (h,), ``w2`` (h,), ``b2`` ()), and without them they are
    drawn from ``torch.Generator().manual_seed(seed)`` at the JAX scales
    (``w1`` N(0, 2/d), ``w2`` N(0, 1/h), biases 0). The ``val_frac``
    split is numpy's ``default_rng(seed).permutation``, as in JAX; with a
    split the parameters of the best held-out loss are kept.
    """

    device = None  # the JAX model's pickled state has no device

    def __init__(self, hidden: int = 64, max_iter: int = 200,
                 lr: float = 0.005, l2: float = 1e-3, seed: int = 0,
                 val_frac: float = 0.0, device=None):
        self.hidden = hidden
        self.max_iter = max_iter
        self.lr = lr
        self.l2 = l2
        self.seed = seed
        self.val_frac = val_frac
        self.device = device
        self._params: Optional[Dict] = None
        self._mean: Optional[np.ndarray] = None
        self._scale: Optional[np.ndarray] = None

    def initial_params(self, d: int) -> Dict[str, np.ndarray]:
        """The default first weights for ``d`` features."""
        g = torch.Generator().manual_seed(self.seed)
        h = self.hidden
        return {
            "w1": (torch.randn((d, h), generator=g) * (2.0 / d) ** 0.5).numpy(),
            "b1": np.zeros((h,), np.float32),
            "w2": (torch.randn((h,), generator=g) * (1.0 / h) ** 0.5).numpy(),
            "b2": np.float32(0.0),
        }

    def fit(self, X: np.ndarray, y: np.ndarray,
            init_params: Optional[Dict] = None) -> "TorchMLPReranker":
        dev = resolve_device(self.device)
        Xs, y, w, self._mean, self._scale = _standardize_and_weigh(X, y)
        n, d = Xs.shape
        init = self.initial_params(d) if init_params is None else init_params
        p = {k: torch.tensor(np.asarray(v, np.float32), device=dev,
                             requires_grad=True)
             for k, v in init.items()}

        # optional held-out split for early stopping (val_frac > 0); the
        # default trains the full budget on all samples (JAX's defaults)
        n_val = int(round(n * self.val_frac))
        track_best = 0 < n_val < n
        if track_best:
            perm = np.random.default_rng(self.seed).permutation(n)
            vi, ti = perm[:n_val], perm[n_val:]
            Xv, yv, wv = (torch.from_numpy(a[vi]).to(dev) for a in (Xs, y, w))
            Xs, y, w = Xs[ti], y[ti], w[ti]
        Xt, yt, wt = (torch.from_numpy(a).to(dev) for a in (Xs, y, w))

        def logits(x):
            return torch.relu(x @ p["w1"] + p["b1"]) @ p["w2"] + p["b2"]

        def snapshot():
            return {k: v.detach().clone() for k, v in p.items()}

        opt = torch.optim.Adam(list(p.values()), lr=self.lr)
        best_p, best_l = None, None
        if track_best:
            with torch.no_grad():
                best_p, best_l = snapshot(), _bce(logits(Xv), yv, wv)
        for _ in range(self.max_iter):
            opt.zero_grad(set_to_none=True)
            reg = self.l2 * (torch.sum(p["w1"] ** 2) + torch.sum(p["w2"] ** 2))
            loss = _bce(logits(Xt), yt, wt) + reg
            loss.backward()
            opt.step()
            if track_best:
                with torch.no_grad():
                    vl = _bce(logits(Xv), yv, wv)
                    better = vl < best_l
                    for k in p:  # on the device: no host sync a step
                        best_p[k] = torch.where(better, p[k].detach(), best_p[k])
                    best_l = torch.minimum(vl, best_l)
        out = best_p if track_best else snapshot()
        self._params = {k: v.cpu().numpy() for k, v in out.items()}
        return self

    def decision_function(self, X: np.ndarray) -> np.ndarray:
        Xs = (np.asarray(X, np.float32) - self._mean) / self._scale
        p = self._params
        hid = np.maximum(Xs @ p["w1"] + p["b1"], 0.0)
        return hid @ p["w2"] + p["b2"]

    def predict_proba(self, X: np.ndarray) -> np.ndarray:
        z = self.decision_function(X)
        # stable sigmoid: exp of a non-positive argument only
        e = np.exp(-np.abs(z))
        prob = np.where(z >= 0.0, 1.0 / (1.0 + e), e / (1.0 + e))
        return np.stack([1 - prob, prob], axis=1)

    def predict(self, X: np.ndarray) -> np.ndarray:
        return (self.decision_function(X) > 0).astype(np.int32)


def rerank_scores(
    payload: Dict,
    query: str,
    rows: List[Tuple[str, float]],  # [(item_text, sim)]
    meta_map: Optional[Dict[str, pd.Series]] = None,
    item_ids: Optional[List] = None,
) -> np.ndarray:
    """Serve-time scoring: P(relevant) per candidate from a reranker
    payload (reference streamlit_app.py:460-566 feature assembly)."""
    model = payload["model"]
    feats = []
    for idx, (text, sim) in enumerate(rows):
        meta_row = None
        if meta_map is not None and item_ids is not None:
            meta_row = meta_map.get(str(item_ids[idx]))
        feats.append(featurize(query, text, sim, meta_row))
    X = np.vstack(feats)
    return model.predict_proba(X)[:, 1]
