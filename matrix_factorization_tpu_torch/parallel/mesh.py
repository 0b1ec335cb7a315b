"""Device meshes over the ranks of a ``torch.distributed`` world.

Counterpart of ``matrix_factorization_tpu/parallel/mesh.py``, with its
axis names and order: ``slice`` (the optional outer axis of a multislice
layout), ``data`` (shards the ratings and the user table) and ``model``
(shards the item table). A mesh is a ``DeviceMesh`` over the initialized
default group whose ranks are laid out in that order, rank-major as JAX
lays out ``jax.devices()``: on a (data, model) mesh rank ``d * n_model +
m`` sits at (d, m). One process a device: a rank's device is its own
(``cuda:LOCAL_RANK`` under ``torchrun``), and the mesh says which shards
it holds and which groups its collectives run on.

JAX's ``replicated`` / ``row_sharded`` / ``device_put_*`` have no
counterpart: under SPMD a rank holds its shard as an ordinary tensor on
its device (``parallel/distributed.py::place_params``), and a replicated
tensor is one that every rank holds whole.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

DCN_AXIS = "slice"
DATA_AXIS = "data"
MODEL_AXIS = "model"


def _world_size() -> int:
    if not dist.is_initialized():
        raise RuntimeError(
            "a mesh is built on the default process group: call "
            "torch.distributed.init_process_group first")
    return dist.get_world_size()


def _build(shape: Tuple[int, ...], names: Tuple[str, ...]) -> DeviceMesh:
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    ranks = torch.arange(dist.get_world_size()).reshape(shape)
    mesh = DeviceMesh(device_type, ranks, mesh_dim_names=names)
    if DCN_AXIS in names:
        # one group over (slice, data) for every model index, in the flat
        # rank order: its all-reduces are the flat data mesh's, bit for bit
        me = dist.get_rank()
        for m in range(shape[-1]):
            members = ranks[..., m].reshape(-1).tolist()
            group = dist.new_group(members)
            if me in members:
                mesh._mf_data_group = group
    return mesh


def make_mesh(n_data: int = -1, n_model: int = 1) -> DeviceMesh:
    """A (data, model) mesh over every rank of the world; ``n_data=-1``
    takes the ranks the model axis leaves. Raises ``ValueError`` when the
    world size is not ``n_data * n_model``. Every rank calls it (it makes
    the axes' process groups)."""
    world = _world_size()
    if n_data == -1:
        n_data = world // n_model
    if n_data < 1 or n_model < 1 or n_data * n_model != world:
        raise ValueError(f"mesh {n_data}x{n_model} needs {n_data * n_model} "
                         f"devices, have {world}")
    return _build((n_data, n_model), (DATA_AXIS, MODEL_AXIS))


def make_multislice_mesh(n_slices: int, n_data: int = -1,
                         n_model: int = 1) -> DeviceMesh:
    """A (slice, data, model) mesh, slice-major: the inner axes of a slice
    are consecutive ranks. The data-parallel trainers shard over (slice,
    data) jointly, so it trains as the flat data mesh of the same size."""
    world = _world_size()
    if n_data == -1:
        n_data = world // (n_slices * n_model)
    need = n_slices * n_data * n_model
    if n_slices < 1 or n_data < 1 or n_model < 1 or need != world:
        raise ValueError(f"mesh {n_slices}x{n_data}x{n_model} needs {need} "
                         f"devices, have {world}")
    return _build((n_slices, n_data, n_model), (DCN_AXIS, DATA_AXIS, MODEL_AXIS))


def _sizes(mesh) -> dict:
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def data_axes_of(mesh) -> tuple:
    """The axes the ratings and the user table shard over: ``data``, plus
    ``slice`` when present (slice-major)."""
    names = mesh.mesh_dim_names
    return tuple(a for a in (DCN_AXIS, DATA_AXIS) if a in names)


def data_size_of(mesh) -> int:
    """Ranks across the data axes (1 = no data parallelism)."""
    n = 1
    for a in data_axes_of(mesh):
        n *= _sizes(mesh)[a]
    return n


def model_size_of(mesh) -> int:
    return _sizes(mesh).get(MODEL_AXIS, 1)


def _coordinate(mesh) -> dict:
    return dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))


def device_index(mesh) -> int:
    """This rank's linear index over the data axes (JAX ``device_index``,
    which reads ``lax.axis_index`` inside ``shard_map``)."""
    coord, sizes = _coordinate(mesh), _sizes(mesh)
    dev = 0
    for a in data_axes_of(mesh):
        dev = dev * sizes[a] + coord[a]
    return dev


def model_index(mesh) -> int:
    """This rank's index on the model axis (0 without one)."""
    return _coordinate(mesh).get(MODEL_AXIS, 0)


def data_group(mesh):
    """The process group over the data axes through this rank: the ranks
    that share its model index."""
    group = getattr(mesh, "_mf_data_group", None)
    return group if group is not None else mesh.get_group(DATA_AXIS)


def model_group(mesh):
    """The process group over the model axis through this rank."""
    return mesh.get_group(MODEL_AXIS)


def first_axis(mesh) -> tuple:
    """``(group, size, index)`` of the mesh's first axis through this rank:
    the axis that the row-sharded Newton-Schulz inverse and EASE's ``B``
    shard their rows over (JAX ``mesh.axis_names[0]``; ``data`` on a
    ``make_mesh`` mesh, ``slice`` on a multislice one). The ranks that
    share this rank's index there hold the same rows."""
    name = mesh.mesh_dim_names[0]
    return mesh.get_group(name), _sizes(mesh)[name], _coordinate(mesh)[name]


def flat_index(mesh) -> int:
    """This rank's index over every axis of the mesh, row-major (JAX's
    order of ``mesh.devices``): what shards over all axes jointly (the
    gram's user blocks, the dense CF similarity rows) is split by it."""
    idx = 0
    for name, size in zip(mesh.mesh_dim_names, mesh.shape):
        idx = idx * size + _coordinate(mesh)[name]
    return idx
