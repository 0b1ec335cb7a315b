"""Where the port's tensors live.

Every entry point takes ``device=None``, which means the GPU. A missing
GPU is an error, not a reason to run on the CPU: the CPU is used only
when the caller asks for it (``device="cpu"``), as the tests do.

A pickled model holds host tensors; :func:`load_device` names the device
that the models unpickled inside it move their tensors to.
"""

from __future__ import annotations

import contextlib
import contextvars

import torch

_NOT_SET = object()
_LOAD_DEVICE = contextvars.ContextVar("load_device", default=_NOT_SET)


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``; raises ``RuntimeError`` for CUDA without a GPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return dev


@contextlib.contextmanager
def load_device(device=None):
    """Models unpickled inside this block put their tensors on ``device``
    (``None`` = CUDA), whatever device they were pickled from."""
    token = _LOAD_DEVICE.set(device)
    try:
        yield
    finally:
        _LOAD_DEVICE.reset(token)


def load_device_for(own_device):
    """(device argument, resolved device) for a model being unpickled: the
    one :func:`load_device` names, else the model's own ``device``."""
    device = _LOAD_DEVICE.get()
    if device is _NOT_SET:
        device = own_device
    return device, resolve_device(device)


def to_device(obj, device):
    """``obj`` with every tensor inside its tuples (named or not), lists
    and dicts moved to ``device``; anything else as it is."""
    if isinstance(obj, torch.Tensor):
        return obj.to(device)
    if isinstance(obj, tuple):
        items = [to_device(x, device) for x in obj]
        return type(obj)._make(items) if hasattr(obj, "_fields") else tuple(items)
    if isinstance(obj, list):
        return [to_device(x, device) for x in obj]
    if isinstance(obj, dict):
        return {k: to_device(v, device) for k, v in obj.items()}
    return obj
