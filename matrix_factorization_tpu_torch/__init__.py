"""matrix_factorization_tpu_torch — the PyTorch and CUDA port of
``matrix_factorization_tpu``, for NVIDIA Hopper GPUs.

The JAX package stays the reference; this package imports nothing of it
(nor JAX). It keeps the JAX package's module names so that each module's
counterpart is easy to find. It trains and serves ``KernelMF`` models:
``fit`` and ``update_users`` run mini-batch SGD whose step and
secondary-side apply are hand-written CUDA kernels
(``csrc/sgd_step.cu``), or exact ALS sweeps (``method='als'``, and the
``als_warm_start`` of an SGD fit) whose SPD solves end in a hand-written
Gauss-Jordan kernel (``csrc/spd_gj.cu``), which also carries the
implicit-feedback :class:`ImplicitALS`. Checkpoints of either package load here
(:func:`load_model`), and ``predict``, ``recommend``,
``recommend_batch`` and the :class:`CoalescingRecommender` run on the
GPU, the catalog scoring in a hand-written CUDA kernel
(``csrc/score_catalog.cu``). Entry points take ``device=None``, which
means CUDA; ``device="cpu"`` runs the plain PyTorch versions of the
kernels instead.
"""

from matrix_factorization_tpu_torch.core.checkpoint import (
    fit_resumable,
    load_model,
    save_model,
)
from matrix_factorization_tpu_torch.models.implicit import ImplicitALS
from matrix_factorization_tpu_torch.models.kernel_mf import KernelMF
from matrix_factorization_tpu_torch.ops.segment_sgd import params_from_numpy
from matrix_factorization_tpu_torch.serve.coalesce import CoalescingRecommender
from matrix_factorization_tpu_torch.utils.splits import train_update_test_split

__all__ = [
    "CoalescingRecommender",
    "ImplicitALS",
    "KernelMF",
    "fit_resumable",
    "load_model",
    "params_from_numpy",
    "save_model",
    "train_update_test_split",
]
