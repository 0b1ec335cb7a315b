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

``save_model_sharded`` / ``load_model_sharded`` are the counterparts of
JAX's orbax pair (``save_model_orbax`` / ``load_model_orbax``): a
``torch.distributed.checkpoint`` tree ``arrays_dcp/`` beside ``meta.pkl``,
in which each rank of a ``keep_sharded`` KernelMF writes and reads only its
own shards. Orbax imports JAX, so this tree is the port's own: neither
package reads the other's (``save_model``'s layout is the one they share).

A checkpoint written by either package loads into the other: ``config``
holds the JAX package's constructor arguments, so ``device`` (a runtime
choice of the port) is left out of it. Writes are atomic: a temp
directory beside the target, then a rename. ``meta.pkl`` is a pickle:
load only checkpoints this program or the JAX package wrote.
"""

from __future__ import annotations

import contextlib
import os
import pickle
import shutil
import tempfile
import warnings
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
        with (tmp / "meta.pkl").open("wb") as f:
            pickle.dump(_meta(model, params), f)
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


def _meta(model, params) -> dict:
    """``meta.pkl``'s record of ``model`` (its whole ``params``' class)."""
    config = strip_runtime_config(model.get_params())
    config.pop("device", None)
    return {
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


def _read_meta(path: Path) -> dict:
    with (path / "meta.pkl").open("rb") as f:
        return pickle.load(f)


def _new_model(meta: dict, device):
    """A model of ``meta``'s class, its constructor config, vocabularies
    and training record, with no tables yet; and its params class name."""
    from matrix_factorization_tpu_torch.core.ids import IdVocab

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
    return model, params_class


def _restore_params(model, params_class, arrays) -> None:
    """The model's params from ``arrays`` (field name -> host array), on
    its device."""
    from matrix_factorization_tpu_torch.ops.segment_sgd import params_from_numpy

    if params_class == "BiasParams":
        model._params = _bias_params(arrays, model._device)
    elif params_class == "EASEParams":
        from matrix_factorization_tpu_torch.ops.ease import EASEParams

        model._params = EASEParams(_f32_tensor(arrays["item_weights"], model._device))
    elif params_class == "SVDppParams":
        from matrix_factorization_tpu_torch.ops.svdpp import svdpp_params_from_numpy

        model._params = svdpp_params_from_numpy(
            *(arrays[name] for name in ("user_features", "item_features",
                                        "implicit_features",
                                        "user_implicit_sums",
                                        "global_mean")),
            device=model._device, cfg=model._cfg())
    elif params_class == "MFParams":
        model._params = params_from_numpy(
            arrays["user_features"], arrays["item_features"],
            arrays["global_mean"], device=model._device, cfg=model._cfg())


def load_model(path, device=None):
    """Restore a model of any class ``_model_classes`` names from a
    checkpoint directory onto ``device`` (``None`` = CUDA, see
    ``core.device``; ``Popularity`` lives on the host and takes none)."""
    path = Path(path)
    model, params_class = _new_model(_read_meta(path), device)
    with np.load(path / "arrays.npz") as npz:
        _restore_params(model, params_class, npz)
        _restore_aux(model, npz)
    return model


# -- sharded checkpoints on torch.distributed.checkpoint ---------------------

DCP_DIR = "arrays_dcp"
# the layouts whose shards a rank writes and reads alone: a keep_sharded
# KernelMF's P over the data axes, and with "2d" its Q over the model axis
SHARDED_LAYOUTS = ("1d", "2d")


def _placements(mesh, field: str, sharding: str):
    """The DTensor placements of a sharded KernelMF's table on ``mesh``:
    P (``user_features``) split over the data axes (``slice`` then
    ``data``, the flat data index), Q over the ``model`` axis under "2d",
    whole under "1d"; each replicated over the other axes."""
    from torch.distributed.tensor import Replicate, Shard

    from matrix_factorization_tpu_torch.parallel.mesh import (
        DATA_AXIS,
        DCN_AXIS,
        MODEL_AXIS,
    )

    if field == "user_features":
        split = (DCN_AXIS, DATA_AXIS)
    elif field == "item_features" and sharding == "2d":
        split = (MODEL_AXIS,)
    else:
        split = ()
    return [Shard(0) if name in split else Replicate()
            for name in mesh.mesh_dim_names]


def _mesh_record(mesh) -> dict:
    return {"mesh_shape": tuple(int(x) for x in mesh.shape),
            "mesh_dim_names": tuple(mesh.mesh_dim_names)}


def _write_meta(path: Path, meta: dict) -> None:
    """``meta.pkl`` written atomically: a temporary file, then a rename."""
    fd, tmp = tempfile.mkstemp(dir=path, prefix=".meta.")
    try:
        with os.fdopen(fd, "wb") as f:
            pickle.dump(meta, f)
        os.replace(tmp, path / "meta.pkl")
    except BaseException:
        Path(tmp).unlink(missing_ok=True)
        raise


def save_model_sharded(model, path) -> None:
    """Checkpoint a fitted model as a ``torch.distributed.checkpoint`` (DCP)
    tree: the port's counterpart of JAX's ``save_model_orbax``
    (``core/checkpoint.py:226-270``). ``orbax.checkpoint`` imports JAX, so
    the port can neither write nor read an orbax tree; the port writes a
    DCP tree instead, and neither package reads the other's tree.
    ``save_model`` stays the format the two packages share.

    The directory holds ``arrays_dcp/`` (the params' fields and the
    ``aux_`` arrays, by name) and beside it ``meta.pkl``: JAX's meta keys,
    with JAX's ``shardings`` replaced by ``layout``, the model's
    ``_sharding`` and the mesh's shape and axis names (``None`` for a model
    that holds whole tables).

    A ``keep_sharded`` ``KernelMF`` that keeps only its shards (``_sharding``
    "1d" or "2d") is written by every rank together, a collective that
    every rank calls: P and Q become DTensors on the model's mesh (P split
    over the data axes, Q over the model axis under "2d"), so each rank
    writes only its own shards and nothing is gathered; DCP writes a
    replicated shard once. The shards must be even (the capacities
    ``round_up(n, 8N)`` make them so), else ``ValueError``. Every other
    model is written whole by DCP without collectives (``no_dist``): one
    without a mesh by its caller, one with a mesh (whose ranks hold the
    same whole tables; ``EASE``'s row-sharded ``B`` is gathered first,
    a collective) by rank 0 alone. ``meta.pkl`` is written last, by rank
    0 alone under a world, atomically."""
    import torch
    import torch.distributed.checkpoint as dcp

    path = Path(path)
    sharding = getattr(model, "_sharding", None)
    mesh = getattr(model, "mesh", None)
    sharded = sharding in SHARDED_LAYOUTS
    params = model._params if sharded else model._whole_params()
    rank = _rank()
    if mesh is not None and not sharded and rank not in (None, 0):
        return
    lead = rank in (None, 0) or not sharded  # the process that writes meta.pkl
    tree = path / DCP_DIR
    if lead:
        path.mkdir(parents=True, exist_ok=True)
        shutil.rmtree(tree, ignore_errors=True)
    state = {name: torch.from_numpy(np.ascontiguousarray(a))
             for name, a in _aux_arrays(model).items()}
    if sharded:
        import torch.distributed as dist
        from torch.distributed.tensor import DTensor

        for name in params._fields:
            t = getattr(params, name)
            if name == "global_mean":
                state[name] = t
                continue
            places = _placements(mesh, name, sharding)
            _check_even(t, name)
            state[name] = DTensor.from_local(t.contiguous(), mesh, places,
                                             run_check=False)
        dist.barrier()  # the old tree is gone before any rank writes
        dcp.save(state, checkpoint_id=str(tree))
        dist.barrier()  # every shard is on disk before meta.pkl names it
        layout = {"sharding": sharding, **_mesh_record(mesh)}
    else:
        if params is not None:
            state.update({name: getattr(params, name).detach().cpu()
                          for name in params._fields})
        with _one_process():
            dcp.save(state, checkpoint_id=str(tree), no_dist=True)
        layout = None
    if lead:
        meta = _meta(model, params)
        meta.update(layout=layout, keep_sharded=bool(getattr(model, "keep_sharded", False)))
        _write_meta(path, meta)
    if sharded:
        dist.barrier()  # no rank looks for meta.pkl before it is written


@contextlib.contextmanager
def _one_process():
    """DCP without collectives (``no_dist``), its warning that it assumes
    one process silenced: that is what was asked for."""
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message="torch.distributed is disabled")
        yield


def _check_even(t, name: str) -> None:
    """Every rank's shard of a table has as many rows (a collective)."""
    import torch.distributed as dist

    rows = [None] * dist.get_world_size()
    dist.all_gather_object(rows, tuple(t.shape))
    if len(set(rows)) != 1:
        raise ValueError(f"the ranks' shards of {name} are not even: {rows}")


def load_model_sharded(path, mesh=None, device=None):
    """Restore a checkpoint that ``save_model_sharded`` wrote: the port's
    counterpart of JAX's ``load_model_orbax`` (``core/checkpoint.py:
    273-333``), onto ``device`` (``None`` = CUDA).

    With ``mesh`` and a sharded checkpoint (a ``keep_sharded`` KernelMF's),
    a collective that every rank calls: each table is read straight into
    the saved layout on ``mesh`` (each rank reads only its shards; no rank
    ever holds a whole sharded table), the mesh is attached,
    ``keep_sharded`` set and the sharded catalog rebuilt. A mesh of
    another shape or axes than the saved one raises ``ValueError`` naming
    both (the port does not reshard). Without a mesh the tables are read
    whole onto ``device`` (the shards gathered by DCP's reader, no
    collective) and ``keep_sharded`` is False; a mesh given with a
    checkpoint of whole tables is attached to the model, as JAX's is."""
    import torch
    import torch.distributed.checkpoint as dcp

    path = Path(path)
    meta = _read_meta(path)
    model, params_class = _new_model(meta, device)
    tree = str(path / DCP_DIR)
    saved = dcp.FileSystemReader(tree).read_metadata().state_dict_metadata
    layout = meta.get("layout")
    if mesh is not None and layout is not None:
        if _mesh_record(mesh) != {k: tuple(layout[k])
                                  for k in ("mesh_shape", "mesh_dim_names")}:
            raise ValueError(
                f"the checkpoint's tables are sharded on a mesh of shape "
                f"{tuple(layout['mesh_shape'])} {tuple(layout['mesh_dim_names'])}, "
                f"not {tuple(mesh.shape)} {tuple(mesh.mesh_dim_names)}")
        _load_shards(model, mesh, layout["sharding"], saved, tree)
        model.mesh = mesh
        model.keep_sharded = True
        model._rebuild_serving_catalog()
        return model
    state = {name: torch.empty(tuple(md.size), dtype=md.properties.dtype)
             for name, md in saved.items()}
    with _one_process():
        dcp.load(state, checkpoint_id=tree, no_dist=True)
    arrays = {name: t.numpy() for name, t in state.items()}
    _restore_params(model, params_class, arrays)
    _restore_aux(model, arrays)
    if mesh is not None and hasattr(model, "mesh"):
        model.mesh = mesh
    return model


def _load_shards(model, mesh, sharding: str, saved: dict, tree: str) -> None:
    """A sharded KernelMF's tables read into this rank's shards on
    ``mesh`` (a collective), placed on the model's device."""
    import torch
    import torch.distributed.checkpoint as dcp
    from torch.distributed.tensor import DTensor

    from matrix_factorization_tpu_torch.ops.segment_sgd import MFParams

    state = {}
    for name in MFParams._fields:
        md = saved[name]
        shape = list(md.size)
        if name != "global_mean":  # the saved mesh's shape: even shards
            places = _placements(mesh, name, sharding)
            for size, place in zip(mesh.shape, places):
                if place.is_shard():
                    shape[0] //= size
            state[name] = DTensor.from_local(
                torch.empty(shape, dtype=md.properties.dtype), mesh, places,
                run_check=False)
        else:
            state[name] = torch.empty(shape, dtype=md.properties.dtype)
    dcp.load(state, checkpoint_id=tree)
    local = {name: (t.to_local() if isinstance(t, DTensor) else t)
             for name, t in state.items()}
    model._params = MFParams(*(local[name].to(model._device)
                               for name in MFParams._fields))
    model._sharding = sharding


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
