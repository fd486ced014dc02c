"""Activation functions (reference: utils.h:15-23), the PyTorch port of
``ffcnn_tpu/ops/activations.py``.  Elementwise on any float tensor; the
activation id is a plain int fixed by the cfg."""

from __future__ import annotations

import functools

import torch

from ..darknet.ir import Activation


@functools.cache
def in_dtype(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to ``dtype``, as a Python float: a tensor times
    this scalar computes as JAX's ``x * jnp.asarray(value, x.dtype)`` does
    (the product of two values of the dtype, rounded once), and no tensor
    is built from a host value on the call, which on the card would copy
    it over and synchronise the stream."""
    return torch.tensor(value, dtype=dtype).item()


def activate(x: torch.Tensor, act: int) -> torch.Tensor:
    """Dispatch on the activation id.  Unknown ids fall through to linear,
    matching the reference's switch default."""
    if act == Activation.RELU:
        return torch.clamp_min(x, 0)
    if act == Activation.LEAKY:
        # slope 0.1 in the tensor's own dtype (utils.h:19)
        return torch.where(x > 0, x, x * in_dtype(0.1, x.dtype))
    if act in (Activation.SIGMOID, Activation.LOGISTIC):
        return torch.reciprocal(1 + torch.exp(-x))
    if act == Activation.MISH:
        # yolov4 extension: x * tanh(softplus(x))
        return x * torch.tanh(torch.log1p(torch.exp(x)))
    if act == Activation.SWISH:
        return x * torch.reciprocal(1 + torch.exp(-x))
    return x
