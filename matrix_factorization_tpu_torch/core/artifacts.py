"""Reading the serving artifacts (``item_index.pkl``, ``model.pkl``,
``reranker.pkl``) that either package wrote.

The artifacts are pickles, as in the JAX package. The port reads them with
:class:`ArtifactUnpickler`, whose ``find_class``:

* maps the JAX package's two rerankers
  (``matrix_factorization_tpu.rank.reranker.JaxLogisticRegression`` and
  ``JaxMLPReranker``) to the port's (``TorchLogisticRegression``,
  ``TorchMLPReranker``): their state is numpy under the same attribute
  names, so a ``reranker.pkl`` the JAX package wrote loads without JAX;
* refuses every other global of ``matrix_factorization_tpu`` and of
  ``jax`` / ``jaxlib``: a JAX-pickled model holds jax arrays, so it fails
  to load (``pickle.UnpicklingError``) and the service serves retrieval
  only, as the JAX service does for a model that fails to load. A JAX
  model crosses through ``save_model`` / ``load_model`` instead.

Models of the port pickle their tensors as host tensors and put them on
the device :func:`load_pickle` names (``core.device.load_device``).
Unpickling runs code: load only artifacts this program or the JAX package
wrote.
"""

from __future__ import annotations

import pickle
from pathlib import Path

from matrix_factorization_tpu_torch.core.device import load_device

_JAX_PACKAGE = "matrix_factorization_tpu"
_RERANKERS = {"JaxLogisticRegression": "TorchLogisticRegression",
              "JaxMLPReranker": "TorchMLPReranker"}


def _refused(module: str) -> bool:
    top = module.split(".")[0]
    return top in (_JAX_PACKAGE, "jax", "jaxlib")


class ArtifactUnpickler(pickle.Unpickler):
    """``pickle.Unpickler`` with the JAX package's rerankers remapped to
    the port's and every other JAX global refused."""

    def find_class(self, module, name):
        if module == f"{_JAX_PACKAGE}.rank.reranker" and name in _RERANKERS:
            from matrix_factorization_tpu_torch.rank import reranker

            return getattr(reranker, _RERANKERS[name])
        if _refused(module):
            raise pickle.UnpicklingError(
                f"{module}.{name} is the JAX package's; the PyTorch port loads "
                "JAX models through save_model / load_model")
        return super().find_class(module, name)


def load_pickle(path, device=None):
    """Unpickle ``path`` with :class:`ArtifactUnpickler`; the port's models
    inside put their tensors on ``device`` (``None`` = CUDA)."""
    with Path(path).open("rb") as f, load_device(device):
        return ArtifactUnpickler(f).load()


def reranker_from_numpy(kind: str, state: dict):
    """The port's reranker of ``kind`` ('logreg' or 'mlp', the JAX
    payload's ``model_type``) built from numpy state under the JAX
    model's attribute names: its constructor arguments (those present)
    and ``coef_`` / ``intercept_`` (logreg) or ``_params`` (mlp), with
    ``_mean`` and ``_scale``."""
    from matrix_factorization_tpu_torch.rank import reranker

    cls = {"logreg": reranker.TorchLogisticRegression,
           "mlp": reranker.TorchMLPReranker}[kind]
    model = cls()
    for name, value in state.items():
        if not hasattr(model, name):
            raise ValueError(f"{cls.__name__} has no attribute {name!r}")
        setattr(model, name, value)
    return model
