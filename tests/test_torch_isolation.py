"""The PyTorch port stands alone: it imports neither JAX nor the JAX
package (``matrix_factorization_tpu``), at run time or in its sources."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

PORT = Path(__file__).resolve().parents[1] / "matrix_factorization_tpu_torch"
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax",
             "matrix_factorization_tpu"}

_DRIVE = r"""
import sys, tempfile
import numpy as np
import matrix_factorization_tpu_torch as mf
from matrix_factorization_tpu_torch.core.ids import IdVocab

m = mf.KernelMF(n_factors=6, kernel="rbf", device="cpu")
cfg = m._cfg()
rng = np.random.default_rng(0)
P = np.zeros((8, cfg.padded_factors), np.float32)
Q = np.zeros((8, cfg.padded_factors), np.float32)
P[:, :6] = rng.normal(size=(8, 6))
Q[:, :6] = rng.normal(size=(8, 6))
m.user_vocab, m.item_vocab = IdVocab(range(8)), IdVocab("abcdefgh")
m._params = mf.params_from_numpy(P, Q, 3.0, device="cpu", cfg=cfg)
with tempfile.TemporaryDirectory() as d:
    mf.save_model(m, d + "/ckpt")
    back = mf.load_model(d + "/ckpt", device="cpu")
assert len(back.recommend(3, amount=4)) == 4
assert len(back.recommend_batch([1, 2], amount=3)) == 6
co = mf.CoalescingRecommender(back)
assert len(co.recommend(5, amount=2)) == 2
co.close()
import pandas as pd
X = pd.DataFrame({"user_id": np.arange(60) % 9, "item_id": np.arange(60) // 9})
t = mf.KernelMF(n_factors=6, n_epochs=2, batch_size=16, device="cpu")
t.fit(X, pd.Series(rng.uniform(1, 5, 60)))
t.update_users(X.iloc[::9][:5].assign(user_id=99), pd.Series(np.ones(5)), n_epochs=1)
assert len(t.train_rmse) == 1
a = mf.KernelMF(n_factors=4, n_epochs=2, method="als", reg=0.1, device="cpu")
a.fit(X, pd.Series(rng.uniform(1, 5, 60)))
a.update_users(X.iloc[::9][:5].assign(user_id=98), pd.Series(np.ones(5)))
w = mf.KernelMF(n_factors=4, n_epochs=1, kernel="sigmoid", als_warm_start=1,
                batch_size=16, device="cpu")
w.fit(X, pd.Series(rng.uniform(1, 5, 60)))
im = mf.ImplicitALS(n_factors=4, n_epochs=2, device="cpu")
im.fit(X, pd.Series(rng.uniform(0, 3, 60)))
im.update_users(X.iloc[::9][:3].assign(user_id=97), pd.Series(np.ones(3)))
assert len(a.train_rmse) == 2 and len(im.train_loss) == 2
assert len(im.recommend(97, amount=2)) == 2
ry = pd.Series(rng.uniform(1, 5, 60))
for method in ("sgd", "als"):
    b = mf.BaselineModel(method=method, n_epochs=2, batch_size=16, device="cpu")
    b.fit(X, ry).update_users(X.iloc[::9][:4].assign(user_id=96), ry.iloc[:4])
    assert len(b.recommend(96, amount=3)) == 3
for cls in (mf.UserUserCF, mf.ItemItemCF):
    assert len(cls(n_neighbors=3, device="cpu").fit(X, ry).predict(X)) == 60
feats = pd.DataFrame({"item_id": range(7), "g0": [1.0, 0, 1, 0, 1, 0, 1]})
c = mf.ContentBasedRecommender(predict_mode="similarity", device="cpu")
assert len(c.fit(X, ry, item_features=feats).predict(X)) == 60
g, res = mf.grid_search_kernel_mf(X, ry, X, ry, lrs=[0.01], regs=[0.1, 0.2],
                                  n_epochs=1, n_factors=4, batch_size=16,
                                  device="cpu")
assert len(res) == 2 and len(g.recommend(1, amount=2)) == 2
print("\n".join(sorted(sys.modules)))
"""


def _top(name: str) -> str:
    return name.split(".")[0]


def test_port_runs_without_jax_modules():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(PORT.parent)
    proc = subprocess.run([sys.executable, "-c", _DRIVE], capture_output=True,
                          text=True, env=env, cwd=PORT.parent, timeout=240)
    assert proc.returncode == 0, proc.stderr
    loaded = proc.stdout.split()
    assert "matrix_factorization_tpu_torch.serve.coalesce" in loaded
    assert "matrix_factorization_tpu_torch.ops.cuda_sgd" in loaded
    assert "matrix_factorization_tpu_torch.ops.cuda_spd" in loaded
    for name in ("ops.segment_sum", "ops.als", "ops.similarity", "ops.sweep",
                 "models.baseline", "models.collaborative",
                 "models.content_based", "models.grid_search"):
        assert f"matrix_factorization_tpu_torch.{name}" in loaded
    bad = sorted(m for m in loaded if _top(m) in FORBIDDEN)
    assert not bad, bad


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) + [
    PORT.parent / "chip_smoke.py"], ids=lambda p: str(p.relative_to(PORT.parent)))
def test_sources_import_no_jax(path):
    bad = [m for m in _imports(path) if _top(m) in FORBIDDEN]
    assert not bad, (path, bad)
