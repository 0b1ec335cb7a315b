"""matrix_factorization_tpu_torch — the PyTorch and CUDA port of
``matrix_factorization_tpu``, for NVIDIA Hopper GPUs.

The JAX package stays the reference; this package imports nothing of it
(nor JAX). It keeps the JAX package's module names so that each module's
counterpart is easy to find. It trains and serves:

* ``KernelMF``: ``fit`` and ``update_users`` run mini-batch SGD whose step
  and secondary-side apply are hand-written CUDA kernels
  (``csrc/sgd_step.cu``), or exact ALS sweeps (``method='als'``, and the
  ``als_warm_start`` of an SGD fit) whose SPD solves end in a
  hand-written Gauss-Jordan kernel (``csrc/spd_gj.cu``), which also
  carries the implicit-feedback :class:`ImplicitALS`;
  :func:`grid_search_kernel_mf` trains an (lr, reg) grid over one pack;
* ``BaselineModel`` (biases by exact ALS or SGD), ``UserUserCF`` and
  ``ItemItemCF`` (dense similarity, masked top-k neighbours) and
  ``ContentBasedRecommender`` (item-feature profiles), whose reductions
  by id are the deterministic segment-sum kernel
  (``csrc/segment_sum.cu``).

Checkpoints of either package load here (:func:`load_model`: KernelMF,
ImplicitALS, BaselineModel), and ``predict``, ``recommend``,
``recommend_batch`` and the :class:`CoalescingRecommender` run on the
GPU, KernelMF's catalog scoring in a hand-written CUDA kernel
(``csrc/score_catalog.cu``). Entry points take ``device=None``, which
means CUDA; ``device="cpu"`` runs the plain PyTorch versions of the
kernels instead.
"""

from matrix_factorization_tpu_torch.core.checkpoint import (
    fit_resumable,
    load_model,
    save_model,
)
from matrix_factorization_tpu_torch.models.baseline import BaselineModel
from matrix_factorization_tpu_torch.models.collaborative import ItemItemCF, UserUserCF
from matrix_factorization_tpu_torch.models.content_based import ContentBasedRecommender
from matrix_factorization_tpu_torch.models.grid_search import grid_search_kernel_mf
from matrix_factorization_tpu_torch.models.implicit import ImplicitALS
from matrix_factorization_tpu_torch.models.kernel_mf import KernelMF
from matrix_factorization_tpu_torch.ops.segment_sgd import params_from_numpy
from matrix_factorization_tpu_torch.serve.coalesce import CoalescingRecommender
from matrix_factorization_tpu_torch.utils.splits import train_update_test_split

__all__ = [
    "BaselineModel",
    "CoalescingRecommender",
    "ContentBasedRecommender",
    "ImplicitALS",
    "ItemItemCF",
    "KernelMF",
    "UserUserCF",
    "fit_resumable",
    "grid_search_kernel_mf",
    "load_model",
    "params_from_numpy",
    "save_model",
    "train_update_test_split",
]
