"""Checkpoints of fitted models, in the JAX package's directory layout.

Counterpart of ``save_model`` / ``load_model`` in
``matrix_factorization_tpu/core/checkpoint.py``, for ``KernelMF`` (SGD or
ALS), ``ImplicitALS``, ``BPR`` and ``NMF``, whose tables are
``MFParams``, ``SVDpp`` (``SVDppParams``), ``BaselineModel``
(``BiasParams``), ``EASE`` (``EASEParams`` and its users' histories) and
``Popularity`` (no params, its item statistics). A checkpoint is a
directory:

* ``arrays.npz`` — the params' fields as host numpy: ``user_features``,
  ``item_features`` and ``global_mean`` (``MFParams``; ``SVDppParams``
  adds ``implicit_features`` and ``user_implicit_sums``), or
  ``user_biases``, ``item_biases`` and ``global_mean`` (``BiasParams``),
  or ``item_weights`` (``EASEParams``); and the ``aux_`` arrays of the
  state outside the params: EASE's history CSR (``aux_hist_indptr``,
  ``aux_hist_i``, ``aux_hist_w``), BPR's training positives
  (``aux_train_pairs_u``, ``aux_train_pairs_i``, which ``auc`` rejects as
  negatives) and Popularity's item statistics (``aux_pop_counts``,
  ``aux_pop_sums``)
* ``meta.pkl``   — ``format_version``, ``model_class``, ``params_class``
  (``None`` for Popularity), the constructor ``config``, the raw user and
  item ids, ``train_rmse``, ``train_loss``, ``global_mean`` and
  ``epochs_done``

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
    """Checkpoint a fitted model to a directory (atomic). The mesh is
    stripped (``strip_runtime_config``), so the checkpoint loads and
    serves on one device. A model that keeps only a rank's shards
    (``KernelMF(keep_sharded=True)`` fit on a mesh by SGD) is gathered
    first, a collective: every rank calls ``save_model``. Under
    ``torch.distributed`` a model with a mesh (``KernelMF``,
    ``BaselineModel``, ``NMF``, ``BPR``, ``SVDpp``: every rank holds the
    same whole tables after a mesh fit) is written by rank 0 alone, so that the ranks never
    race for one directory."""
    params = model._whole_params() if hasattr(model, "_whole_params") \
        else getattr(model, "_params", None)
    if getattr(model, "mesh", None) is not None and _rank() not in (None, 0):
        return
    path = Path(path)
    # the temp dir must live on the same filesystem as the target or the
    # final rename fails (EXDEV); create missing parents up front
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(dir=path.parent))
    try:
        arrays = {} if params is None else {
            name: getattr(params, name).detach().cpu().numpy()
            for name in params._fields}
        np.savez(tmp / "arrays.npz", **arrays, **_aux_arrays(model))
        config = strip_runtime_config(model.get_params())
        config.pop("device", None)
        meta = {
            "format_version": FORMAT_VERSION,
            "model_class": type(model).__name__,
            "params_class": None if params is None else type(params).__name__,
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


def strip_runtime_config(config: dict) -> dict:
    """``config`` without what ties it to a mesh (JAX
    ``_strip_runtime_config``): a ``DeviceMesh`` is a runtime object, so
    the mesh becomes None and the flags that need one (``overlap_psum``,
    ``keep_sharded``, ``psum_every``) their defaults, which a constructor
    without a mesh accepts. (JAX keeps ``psum_every``, whose checkpoints
    then refuse to load.) A model that should train or serve on a mesh
    again is given one after loading."""
    if config.get("mesh") is None:
        return config
    config = dict(config)
    config["mesh"] = None
    for flag, default in (("overlap_psum", False), ("keep_sharded", False),
                          ("psum_every", 1)):
        if flag in config:
            config[flag] = default
    return config


def _aux_arrays(model) -> dict:
    """Model state outside the params, under ``aux_`` names (the JAX
    package's): EASE's history CSR, BPR's training positives and
    Popularity's item statistics."""
    aux = {}
    if getattr(model, "_indptr", None) is not None:
        aux.update(aux_hist_indptr=model._indptr, aux_hist_i=model._hist_i,
                   aux_hist_w=model._hist_w)
    pairs = getattr(model, "_train_pairs", None)
    if pairs is not None:
        aux.update(aux_train_pairs_u=np.asarray(pairs[0]),
                   aux_train_pairs_i=np.asarray(pairs[1]))
    if getattr(model, "_item_counts", None) is not None:
        aux.update(aux_pop_counts=np.asarray(model._item_counts),
                   aux_pop_sums=np.asarray(model._item_sums))
    return aux


def _restore_aux(model, npz) -> None:
    if "aux_hist_indptr" in npz:
        model._indptr = np.asarray(npz["aux_hist_indptr"])
        model._hist_i = np.asarray(npz["aux_hist_i"])
        model._hist_w = np.asarray(npz["aux_hist_w"])
    if "aux_train_pairs_u" in npz:
        model._train_pairs = (np.asarray(npz["aux_train_pairs_u"]),
                              np.asarray(npz["aux_train_pairs_i"]))
    if "aux_pop_counts" in npz:
        model._item_counts = np.asarray(npz["aux_pop_counts"])
        model._item_sums = np.asarray(npz["aux_pop_sums"])
        model._recompute_scores()


def _model_classes() -> dict:
    """Model class name -> (class, the name of its params class)."""
    from matrix_factorization_tpu_torch.models.baseline import BaselineModel
    from matrix_factorization_tpu_torch.models.bpr import BPR
    from matrix_factorization_tpu_torch.models.ease import EASE
    from matrix_factorization_tpu_torch.models.implicit import ImplicitALS
    from matrix_factorization_tpu_torch.models.kernel_mf import KernelMF
    from matrix_factorization_tpu_torch.models.nmf import NMF
    from matrix_factorization_tpu_torch.models.popularity import Popularity
    from matrix_factorization_tpu_torch.models.svdpp import SVDpp

    return {"KernelMF": (KernelMF, "MFParams"),
            "ImplicitALS": (ImplicitALS, "MFParams"),
            "BPR": (BPR, "MFParams"),
            "NMF": (NMF, "MFParams"),
            "SVDpp": (SVDpp, "SVDppParams"),
            "BaselineModel": (BaselineModel, "BiasParams"),
            "EASE": (EASE, "EASEParams"),
            "Popularity": (Popularity, None)}


def _f32_tensor(a, device):
    """An f32 host array as a tensor on ``device``."""
    import torch

    return torch.from_numpy(np.array(a, dtype=np.float32)).to(device)


def _bias_params(npz, device):
    from matrix_factorization_tpu_torch.ops.als import BiasParams

    return BiasParams(*(_f32_tensor(npz[name], device)
                        for name in BiasParams._fields))


def load_model(path, device=None):
    """Restore a model of any class ``_model_classes`` names from a
    checkpoint directory onto ``device`` (``None`` = CUDA, see
    ``core.device``; ``Popularity`` lives on the host and takes none)."""
    from matrix_factorization_tpu_torch.core.ids import IdVocab
    from matrix_factorization_tpu_torch.ops.segment_sgd import params_from_numpy

    path = Path(path)
    with (path / "meta.pkl").open("rb") as f:
        meta = pickle.load(f)
    classes = _model_classes()
    if meta["model_class"] not in classes or \
            classes[meta["model_class"]][1] != meta["params_class"]:
        raise ValueError(
            f"the PyTorch port loads {', '.join(sorted(classes))} "
            f"checkpoints only, not {meta['model_class']!r} "
            f"({meta['params_class']!r})")
    cls, params_class = classes[meta["model_class"]]
    model = (cls(**meta["config"]) if params_class is None
             else cls(**meta["config"], device=device))
    model.user_vocab = IdVocab(meta["user_raw_ids"])
    model.item_vocab = IdVocab(meta["item_raw_ids"])
    model.train_rmse = meta["train_rmse"]
    model.train_loss = list(meta.get("train_loss", []))
    model.global_mean = meta["global_mean"]
    model._epochs_done = meta["epochs_done"]
    with np.load(path / "arrays.npz") as npz:
        if params_class == "BiasParams":
            model._params = _bias_params(npz, model._device)
        elif params_class == "EASEParams":
            from matrix_factorization_tpu_torch.ops.ease import EASEParams

            model._params = EASEParams(_f32_tensor(npz["item_weights"], model._device))
        elif params_class == "SVDppParams":
            from matrix_factorization_tpu_torch.ops.svdpp import svdpp_params_from_numpy

            model._params = svdpp_params_from_numpy(
                *(npz[name] for name in ("user_features", "item_features",
                                         "implicit_features",
                                         "user_implicit_sums",
                                         "global_mean")),
                device=model._device, cfg=model._cfg())
        elif params_class == "MFParams":
            model._params = params_from_numpy(
                npz["user_features"], npz["item_features"],
                npz["global_mean"], device=model._device, cfg=model._cfg())
        _restore_aux(model, npz)
    return model


def fit_resumable(
    model,
    X,
    y,
    ckpt_dir,
    total_epochs: Optional[int] = None,
    segment_epochs: int = 10,
):
    """Train ``model`` (a ``KernelMF`` or a ``BPR``) in checkpointed segments of
    ``segment_epochs``; resumes from ``ckpt_dir`` when it holds a
    checkpoint of the same class, from its ``_epochs_done``. Segments
    after the first continue with ``fit(warm_start=True)``. The restored
    model keeps the caller's ``device`` and mesh (meshes are never
    checkpointed). Under ``torch.distributed`` with a mesh, every rank
    trains and rank 0 alone writes the checkpoint (every rank calls
    ``save_model`` when the model keeps shards, which it gathers)."""
    ckpt_dir = Path(ckpt_dir)
    total = total_epochs or model.n_epochs
    start = 0
    mesh = getattr(model, "mesh", None)
    if (ckpt_dir / "meta.pkl").exists():
        restored = load_model(ckpt_dir, device=getattr(model, "device", None))
        if type(restored) is type(model):
            if mesh is not None and hasattr(restored, "mesh"):
                restored.mesh = mesh
            model = restored
            start = model._epochs_done
    while start < total:
        step = min(segment_epochs, total - start)
        model.fit(X, y, n_epochs=step, warm_start=start > 0)
        start += step
        model._epochs_done = start
        save_model(model, ckpt_dir)  # rank 0 writes (see save_model)
        if mesh is not None and _rank() is not None:
            import torch.distributed as dist

            dist.barrier()  # no rank looks for the checkpoint before it is written
    return model


def _rank():
    """This process's rank, or None outside a ``torch.distributed``
    world."""
    import torch.distributed as dist

    return dist.get_rank() if dist.is_initialized() else None
