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
  (``csrc/segment_sum.cu``);
* ``BPR`` (pairwise ranking on implicit feedback, with ``auc``),
  ``SVDpp`` (implicit-factor terms) and ``NMF`` (multiplicative updates),
  every scatter of their training on the deterministic segment-sum
  kernels (``mf_segment_apply`` / ``mf_segment_sum``), and the host-side
  ``Popularity`` baseline;
* ``TopKItemItemCF`` and ``TopKUserUserCF`` (top-k neighbour lists from a
  block-tiled sparse gram, for MovieLens-25M-sized catalogs) and
  ``EASE`` (one regularized inverse of the item gram, through the
  Gauss-Jordan leaf), with :func:`grid_search_ease`.

:func:`load_ratings_csv` reads a rating file into dense ids; it and the
rating packs run on the host library of ``csrc/host_loader.cpp``
(threaded parsing and counting sorts).

Checkpoints of either package load here (:func:`load_model`: KernelMF,
ImplicitALS, BPR, SVDpp, NMF, BaselineModel, EASE, Popularity), and
``predict``, ``recommend``, ``recommend_batch`` and the
:class:`CoalescingRecommender` run on the GPU, the factor models' catalog
scoring in a hand-written CUDA kernel (``csrc/score_catalog.cu``). Entry points take ``device=None``, which
means CUDA; ``device="cpu"`` runs the plain PyTorch versions of the
kernels instead.

Around the models, as in the JAX package: the recipe recommender's
serving path (``retrieval`` — dense and TF-IDF item indexes, device top-k;
``rank`` — features, hard filters, diversity, hybrid blend, the reranker;
``serve.service.RecommendService``, ``serve.planner.plan_meals`` and the
HTTP API of ``serve.api``), ``data.synthetic`` and ``utils.metrics``; the
batch pipeline that writes the service's artifacts (``pipeline.*``, each
stage a CLI with ``--platform {cpu,cuda}``), the offline evaluation
(``eval.*``), the meal-planner frontends (``serve.app``) and
``utils.profiling``. With sklearn importable the models are sklearn
estimators.
"""

from matrix_factorization_tpu_torch.core.checkpoint import (
    fit_resumable,
    load_model,
    save_model,
)
from matrix_factorization_tpu_torch.data.loader import load_ratings_csv
from matrix_factorization_tpu_torch.models.base import RecommenderBase
from matrix_factorization_tpu_torch.models.baseline import BaselineModel
from matrix_factorization_tpu_torch.models.bpr import BPR
from matrix_factorization_tpu_torch.models.cf_topk import TopKItemItemCF, TopKUserUserCF
from matrix_factorization_tpu_torch.models.collaborative import ItemItemCF, UserUserCF
from matrix_factorization_tpu_torch.models.content_based import ContentBasedRecommender
from matrix_factorization_tpu_torch.models.ease import EASE
from matrix_factorization_tpu_torch.models.grid_search import grid_search_ease, grid_search_kernel_mf
from matrix_factorization_tpu_torch.models.implicit import ImplicitALS
from matrix_factorization_tpu_torch.models.kernel_mf import KernelMF
from matrix_factorization_tpu_torch.models.nmf import NMF
from matrix_factorization_tpu_torch.models.popularity import Popularity
from matrix_factorization_tpu_torch.models.svdpp import SVDpp
from matrix_factorization_tpu_torch.ops.segment_sgd import params_from_numpy
from matrix_factorization_tpu_torch.ops.svdpp import svdpp_params_from_numpy
from matrix_factorization_tpu_torch.serve.coalesce import CoalescingRecommender
from matrix_factorization_tpu_torch.utils.splits import train_update_test_split

__all__ = [
    "BPR",
    "BaselineModel",
    "CoalescingRecommender",
    "ContentBasedRecommender",
    "EASE",
    "ImplicitALS",
    "ItemItemCF",
    "KernelMF",
    "NMF",
    "Popularity",
    "RecommenderBase",
    "SVDpp",
    "TopKItemItemCF",
    "TopKUserUserCF",
    "UserUserCF",
    "fit_resumable",
    "grid_search_ease",
    "grid_search_kernel_mf",
    "load_model",
    "load_ratings_csv",
    "params_from_numpy",
    "save_model",
    "svdpp_params_from_numpy",
    "train_update_test_split",
]
