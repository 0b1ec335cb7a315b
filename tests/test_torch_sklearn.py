"""The port's models are sklearn estimators: ``tests/test_sklearn_compat.py``
run on the port's ``KernelMF`` and ``BaselineModel`` (``device="cpu"``),
and ``clone`` / ``set_params`` / ``score`` on all thirteen classes. Skips
without sklearn; without it the port keeps its own ``get_params``."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pandas as pd
import pytest

sklearn = pytest.importorskip("sklearn")

from sklearn.base import clone  # noqa: E402
from sklearn.model_selection import GridSearchCV  # noqa: E402

import matrix_factorization_tpu_torch as mf  # noqa: E402
from matrix_factorization_tpu.models.base import RecommenderBase as JaxBase  # noqa: E402
from matrix_factorization_tpu_torch import BaselineModel, KernelMF  # noqa: E402
from matrix_factorization_tpu_torch.data.synthetic import lowrank_ratings  # noqa: E402

CLASSES = ["KernelMF", "ImplicitALS", "BaselineModel", "UserUserCF",
           "ItemItemCF", "ContentBasedRecommender", "TopKItemItemCF",
           "TopKUserUserCF", "EASE", "BPR", "SVDpp", "NMF", "Popularity"]


def test_get_set_params_and_clone():
    m = KernelMF(n_factors=7, n_epochs=3, lr=0.05, reg=0.1, batch_size=64,
                 device="cpu")
    params = m.get_params()
    assert params["n_factors"] == 7 and params["lr"] == 0.05
    m2 = clone(m)
    assert m2.get_params()["reg"] == 0.1
    assert m2.device == "cpu"  # the device survives clone
    m2.set_params(lr=0.2)
    assert m2.lr == 0.2 and m.lr == 0.05


def test_gridsearchcv_kernelmf():
    X, y = lowrank_ratings(n_users=60, n_items=40, density=0.5, seed=12)
    grid = GridSearchCV(
        KernelMF(n_epochs=8, batch_size=128, verbose=0, device="cpu"),
        param_grid={"n_factors": [4, 8], "reg": [0.01, 0.1]},
        scoring="neg_root_mean_squared_error",
        cv=2,
        error_score="raise",
    )
    grid.fit(X, y)
    assert grid.best_score_ < 0  # neg RMSE
    assert set(grid.best_params_) == {"n_factors", "reg"}
    assert grid.best_estimator_.device == "cpu"
    preds = grid.best_estimator_.predict(X.iloc[:10])
    assert len(preds) == 10


def test_gridsearchcv_baseline():
    X, y = lowrank_ratings(n_users=50, n_items=30, density=0.5, seed=13)
    grid = GridSearchCV(
        BaselineModel(method="als", n_epochs=5, device="cpu"),
        param_grid={"reg": [0.1, 1.0]},
        scoring="neg_mean_absolute_error",
        cv=2,
        error_score="raise",
    )
    grid.fit(X, y)
    assert grid.best_params_["reg"] in (0.1, 1.0)


def _fitted(name):
    cls = getattr(mf, name)
    kw = {} if name == "Popularity" else {"device": "cpu"}
    rng = np.random.default_rng(0)
    X = pd.DataFrame({"user_id": np.arange(60) % 9,
                      "item_id": np.arange(60) // 9})
    y = pd.Series(rng.uniform(1, 5, 60))
    m = cls(**kw)
    params = m.get_params()
    for key, value in (("n_epochs", 2), ("batch_size", 16)):
        if key in params:
            m.set_params(**{key: value})
    if name == "ContentBasedRecommender":
        feats = pd.DataFrame({"item_id": range(7),
                              "g0": [1.0, 0, 1, 0, 1, 0, 1]})
        m.fit(X, y, item_features=feats)
    elif name == "BPR":
        m.fit(X)
    else:
        m.fit(X, y)
    return m, X, y


@pytest.mark.parametrize("name", CLASSES)
def test_clone_set_params_score_every_class(name):
    """Every class is a ``RecommenderBase`` with sklearn's bases, as the
    JAX classes are; ``clone`` keeps every parameter (``device`` too),
    ``set_params`` sets one, and ``score`` is R^2 of ``predict``."""
    from sklearn.metrics import r2_score

    m, X, y = _fitted(name)
    assert isinstance(m, mf.RecommenderBase)
    for base in (sklearn.base.BaseEstimator, sklearn.base.RegressorMixin):
        assert issubclass(JaxBase, base) and isinstance(m, base)
    c = clone(m)
    assert c is not m and c.get_params() == m.get_params()
    c.set_params(verbose=1)
    assert c.verbose == 1 and m.verbose == 0
    assert m.score(X, y) == pytest.approx(r2_score(y, m.predict(X)), abs=1e-12)


def test_popularity_score_is_mode_and_method():
    """``Popularity``'s ``score`` argument names its ranking mode; read
    back it equals that string and is also sklearn's ``score(X, y)``."""
    m, X, y = _fitted("Popularity")
    assert m.score == "count" and m.get_params()["score"] == "count"
    assert isinstance(m.score(X, y), float)
    assert clone(mf.Popularity(score="mean")).score == "mean"


_NO_SKLEARN = r"""
import sys
class _Block:
    def find_spec(self, name, path=None, target=None):
        if name == "sklearn" or name.startswith("sklearn."):
            raise ImportError("sklearn blocked")
sys.meta_path.insert(0, _Block())
import matrix_factorization_tpu_torch as mf
m = mf.KernelMF(n_factors=3, device="cpu")
p = m.get_params(deep=True)
assert p["n_factors"] == 3 and p["device"] == "cpu", p
assert m.get_params() == p
assert type(m).__mro__[1].__name__ == "RecommenderBase"
print("ok", "sklearn" in sys.modules)
"""


def test_without_sklearn_get_params_is_the_ports():
    repo = Path(__file__).resolve().parents[1]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(repo)
    proc = subprocess.run([sys.executable, "-c", _NO_SKLEARN],
                          capture_output=True, text=True, env=env, cwd=repo,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == ["ok", "False"]
