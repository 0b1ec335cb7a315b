"""Batched kernel forwards and gradients for kernel matrix factorization
(PyTorch port).

Counterpart of ``matrix_factorization_tpu/ops/kernels.py``. Every
function is batched over a vector of (user, item) pairs: ``pu, qi`` are
``(B, K)`` factor rows, ``bu, bi`` ``(B,)`` biases, and the results are
``(B,)`` predictions and per-pair gradients.

Gradient convention (PARITY.md #4): the reference's sigmoid and rbf
updates leave the kernel's outer scale ``c`` out of ``deriv_base``
(``kernels.py:236`` and ``:310``); the learning rate absorbs it, and the
port keeps the same convention so that one set of hyper-parameters gives
one trajectory in all three implementations.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

KERNELS = ("linear", "sigmoid", "rbf")


class KernelGrads(NamedTuple):
    """d(pred)/d(param) per pair; ``d_bias`` broadcasts to both biases."""

    d_bias: torch.Tensor  # (B,)
    d_pu: torch.Tensor  # (B, K)
    d_qi: torch.Tensor  # (B, K)


def _pair_dot(pu: torch.Tensor, qi: torch.Tensor) -> torch.Tensor:
    # f32 accumulation regardless of storage dtype
    return torch.sum(pu.float() * qi.float(), dim=-1)


def linear_forward(mu, bu, bi, pu, qi) -> torch.Tensor:
    """mu + b_u + b_i + <p_u, q_i>   (reference kernels.py:21-45)."""
    return mu + bu + bi + _pair_dot(pu, qi)


def sigmoid_forward(mu, bu, bi, pu, qi, a, c) -> torch.Tensor:
    """a + c * sigma(linear_sum)   (reference kernels.py:48-78)."""
    x = mu + bu + bi + _pair_dot(pu, qi)
    return a + c * torch.sigmoid(x)


def rbf_forward(pu, qi, gamma, a, c) -> torch.Tensor:
    """a + c * exp(-gamma * ||p-q||^2); no bias/mean terms
    (reference kernels.py:81-105)."""
    d = pu.float() - qi.float()
    power = -gamma * torch.sum(d * d, dim=-1)
    return a + c * torch.exp(power)


def forward(kernel: str, mu, bu, bi, pu, qi, gamma, a, c) -> torch.Tensor:
    if kernel == "linear":
        return linear_forward(mu, bu, bi, pu, qi)
    if kernel == "sigmoid":
        return sigmoid_forward(mu, bu, bi, pu, qi, a, c)
    if kernel == "rbf":
        return rbf_forward(pu, qi, gamma, a, c)
    raise ValueError(f"Kernel must be one of {KERNELS}, got {kernel!r}")


def forward_and_grads(
    kernel: str, mu, bu, bi, pu, qi, gamma, a, c
) -> Tuple[torch.Tensor, KernelGrads]:
    """Predictions plus reference-parity prediction gradients.

    linear  (kernels.py:108-180):  d_bias=1, d_pu=q_i, d_qi=p_u
    sigmoid (kernels.py:183-262):  deriv_base = sigma(x)(1-sigma(x))
    rbf     (kernels.py:265-327):  deriv_base = 2*gamma*exp(power);
                                   d_pu = deriv_base*(q-p); no bias grads
    """
    pu32, qi32 = pu.float(), qi.float()
    if kernel == "linear":
        pred = mu + bu + bi + torch.sum(pu32 * qi32, dim=-1)
        return pred, KernelGrads(torch.ones_like(pred), qi32, pu32)
    if kernel == "sigmoid":
        x = mu + bu + bi + torch.sum(pu32 * qi32, dim=-1)
        sig = torch.sigmoid(x)
        pred = a + c * sig
        deriv_base = sig * (1.0 - sig)
        return pred, KernelGrads(deriv_base, qi32 * deriv_base[:, None],
                                 pu32 * deriv_base[:, None])
    if kernel == "rbf":
        d = pu32 - qi32
        power = -gamma * torch.sum(d * d, dim=-1)
        e = torch.exp(power)
        pred = a + c * e
        d_pu = -d * ((2.0 * gamma) * e)[:, None]  # (q - p) * deriv_base
        return pred, KernelGrads(torch.zeros_like(pred), d_pu, -d_pu)
    raise ValueError(f"Kernel must be one of {KERNELS}, got {kernel!r}")
