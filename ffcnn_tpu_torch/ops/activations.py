"""Activation functions (reference: utils.h:15-23), the PyTorch port of
``ffcnn_tpu/ops/activations.py``.  Elementwise on any float tensor; the
activation id is a plain int fixed by the cfg."""

from __future__ import annotations

import torch

from ..darknet.ir import Activation


def activate(x: torch.Tensor, act: int) -> torch.Tensor:
    """Dispatch on the activation id.  Unknown ids fall through to linear,
    matching the reference's switch default."""
    if act == Activation.RELU:
        return torch.clamp_min(x, 0)
    if act == Activation.LEAKY:
        # slope 0.1 in the tensor's own dtype (utils.h:19)
        return torch.where(x > 0, x,
                           x * torch.tensor(0.1, dtype=x.dtype,
                                            device=x.device))
    if act in (Activation.SIGMOID, Activation.LOGISTIC):
        return torch.reciprocal(1 + torch.exp(-x))
    if act == Activation.MISH:
        # yolov4 extension: x * tanh(softplus(x))
        return x * torch.tanh(torch.log1p(torch.exp(x)))
    if act == Activation.SWISH:
        return x * torch.reciprocal(1 + torch.exp(-x))
    return x
