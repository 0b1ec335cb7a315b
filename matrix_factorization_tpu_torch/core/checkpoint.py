"""Checkpoints of fitted models, in the JAX package's directory layout.

Counterpart of ``save_model`` / ``load_model`` in
``matrix_factorization_tpu/core/checkpoint.py``, for ``KernelMF`` (SGD or
ALS) and ``ImplicitALS``, whose tables are both ``MFParams``, and
``BaselineModel``, whose state is ``BiasParams``. A checkpoint is a
directory:

* ``arrays.npz`` — the params' fields as host numpy: ``user_features``,
  ``item_features`` and ``global_mean`` (``MFParams``), or
  ``user_biases``, ``item_biases`` and ``global_mean`` (``BiasParams``)
* ``meta.pkl``   — ``format_version``, ``model_class``, ``params_class``,
  the constructor ``config``, the raw user and item ids, ``train_rmse``,
  ``train_loss``, ``global_mean`` and ``epochs_done``

``fit_resumable`` trains in segments and checkpoints after each, so an
interrupted fit restarts from the last completed segment.

A checkpoint written by either package loads into the other: ``config``
holds the JAX package's constructor arguments, so ``device`` (a runtime
choice of the port) is left out of it. Writes are atomic: a temp
directory beside the target, then a rename. ``meta.pkl`` is a pickle:
load only checkpoints this program or the JAX package wrote.
"""

from __future__ import annotations

import pickle
import shutil
import tempfile
from pathlib import Path
from typing import Optional

import numpy as np

FORMAT_VERSION = 1


def save_model(model, path) -> None:
    """Checkpoint a fitted model to a directory (atomic)."""
    path = Path(path)
    # the temp dir must live on the same filesystem as the target or the
    # final rename fails (EXDEV); create missing parents up front
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(dir=path.parent))
    try:
        params = model._params
        arrays = {name: getattr(params, name).detach().cpu().numpy()
                  for name in params._fields}
        np.savez(tmp / "arrays.npz", **arrays)
        config = model.get_params()
        config.pop("device", None)
        meta = {
            "format_version": FORMAT_VERSION,
            "model_class": type(model).__name__,
            "params_class": type(params).__name__,
            "config": config,
            "user_raw_ids": model.user_vocab.raw_ids,
            "item_raw_ids": model.item_vocab.raw_ids,
            "train_rmse": list(getattr(model, "train_rmse", [])),
            "train_loss": list(getattr(model, "train_loss", [])),
            "global_mean": float(getattr(model, "global_mean", 0.0)),
            "epochs_done": int(getattr(model, "_epochs_done", 0)),
        }
        with (tmp / "meta.pkl").open("wb") as f:
            pickle.dump(meta, f)
        # move any existing checkpoint aside with a rename (fast) so the
        # window with no checkpoint on disk is two renames, not an rmtree
        old = None
        if path.exists():
            old = path.parent / (path.name + ".old." + tmp.name)
            path.rename(old)
        tmp.rename(path)
        if old is not None:
            shutil.rmtree(old, ignore_errors=True)
    except Exception:
        shutil.rmtree(tmp, ignore_errors=True)
        raise


def _model_classes() -> dict:
    """Model class name -> (class, the name of its params class)."""
    from matrix_factorization_tpu_torch.models.baseline import BaselineModel
    from matrix_factorization_tpu_torch.models.implicit import ImplicitALS
    from matrix_factorization_tpu_torch.models.kernel_mf import KernelMF

    return {"KernelMF": (KernelMF, "MFParams"),
            "ImplicitALS": (ImplicitALS, "MFParams"),
            "BaselineModel": (BaselineModel, "BiasParams")}


def _bias_params(npz, device):
    import torch

    from matrix_factorization_tpu_torch.ops.als import BiasParams

    return BiasParams(*(
        torch.from_numpy(np.array(npz[name], dtype=np.float32)).to(device)
        for name in BiasParams._fields))


def load_model(path, device=None):
    """Restore a ``KernelMF``, an ``ImplicitALS`` or a ``BaselineModel``
    from a checkpoint directory onto ``device`` (``None`` = CUDA, see
    ``core.device``)."""
    from matrix_factorization_tpu_torch.core.ids import IdVocab
    from matrix_factorization_tpu_torch.ops.segment_sgd import params_from_numpy

    path = Path(path)
    with (path / "meta.pkl").open("rb") as f:
        meta = pickle.load(f)
    classes = _model_classes()
    if classes.get(meta["model_class"], (None, None))[1] != meta["params_class"]:
        raise ValueError(
            f"the PyTorch port loads {', '.join(sorted(classes))} "
            f"checkpoints only, not {meta['model_class']!r} "
            f"({meta['params_class']!r})")
    cls, params_class = classes[meta["model_class"]]
    model = cls(**meta["config"], device=device)
    model.user_vocab = IdVocab(meta["user_raw_ids"])
    model.item_vocab = IdVocab(meta["item_raw_ids"])
    model.train_rmse = meta["train_rmse"]
    model.train_loss = list(meta.get("train_loss", []))
    model.global_mean = meta["global_mean"]
    model._epochs_done = meta["epochs_done"]
    with np.load(path / "arrays.npz") as npz:
        if params_class == "BiasParams":
            model._params = _bias_params(npz, model._device)
        else:
            model._params = params_from_numpy(
                npz["user_features"], npz["item_features"],
                npz["global_mean"], device=model._device, cfg=model._cfg())
    return model


def fit_resumable(
    model,
    X,
    y,
    ckpt_dir,
    total_epochs: Optional[int] = None,
    segment_epochs: int = 10,
):
    """Train ``model`` (a ``KernelMF``) in checkpointed segments of
    ``segment_epochs``; resumes from ``ckpt_dir`` when it holds a
    checkpoint of the same class, from its ``_epochs_done``. Segments
    after the first continue with ``fit(warm_start=True)``. The restored
    model keeps the caller's ``device``."""
    ckpt_dir = Path(ckpt_dir)
    total = total_epochs or model.n_epochs
    start = 0
    if (ckpt_dir / "meta.pkl").exists():
        restored = load_model(ckpt_dir, device=getattr(model, "device", None))
        if type(restored) is type(model):
            model = restored
            start = model._epochs_done
    while start < total:
        step = min(segment_epochs, total - start)
        model.fit(X, y, n_epochs=step, warm_start=start > 0)
        start += step
        model._epochs_done = start
        save_model(model, ckpt_dir)
    return model
