"""Multi-device KernelMF on ``torch.distributed`` (PyTorch port).

Counterpart of ``matrix_factorization_tpu/parallel/``. JAX runs a whole
device mesh from one process under ``shard_map``; the port runs one
process per device (SPMD, PyTorch's idiom): every rank runs the same
script, owns one device and the shards that go with it, and the JAX
package's collectives become ``torch.distributed`` calls on the mesh's
process groups (``psum`` an ``all_reduce``, ``all_gather`` an
``all_gather_into_tensor``, ``lax.axis_index`` the rank's coordinate in
the mesh). NCCL carries them between GPUs, gloo between CPU processes.

* ``mesh`` — ``make_mesh`` / ``make_multislice_mesh``: a ``DeviceMesh``
  over the initialized default group, and the groups of its axes;
* ``launch`` — ``spawn_world``: a world of processes on one host, for the
  tests, the chip check and ``dryrun``;
* ``distributed`` — the data-parallel (``dp_fit``: P sharded, Q
  replicated) and 2D (``dp_tp_fit``: both sharded) SGD trainers, on the
  hand-written step and apply kernels of ``ops/cuda_sgd.py`` and
  ``ops/segment_sum.py``;
* ``topk`` / ``serving`` — the item-sharded catalog top-k and
  ``ShardedCatalog``, on the catalog scorer of ``ops/cuda_scores.py``;
* ``dryrun`` — one step of each trainer and one distributed top-k on
  tiny shapes.

The other families' data-parallel trainers sit beside their single-device
trainers (``ops/{als,ials,nmf,bpr,svdpp}.py``) and use this package's
plumbing and windowed epoch.
"""

from matrix_factorization_tpu_torch.parallel.mesh import make_mesh, make_multislice_mesh

__all__ = ["make_mesh", "make_multislice_mesh"]
