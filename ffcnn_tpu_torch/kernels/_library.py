"""The ``ffcnn::`` operator namespace: each kernel a ``Net`` path launches is
a ``torch.library`` op with three implementations, so that
``torch.export`` can trace a pipeline through it (a ``data_ptr()`` handed
to a C library is invisible to fake tensors):

* CUDA: the ctypes launch of the kernel, which counts it;
* CPU: the kernel's plain PyTorch version;
* fake: an empty tensor of the output's exact shape, dtype and strides
  (every output is a new contiguous tensor), for ``torch.export``'s and
  ``torch.compile``'s fake tensors.

A tensor on any other device (``meta`` included) raises: no fallback.

A schema takes tensors, scalars and lists of them, so each wrapper
flattens its bundle of parameters (``BlockParams``, ``HeadParams``, ...)
at the call and the implementations rebuild it.  The ops are functional:
none mutates an input.  ``kernels/ops.py`` imports every module that
defines one.
"""

from __future__ import annotations

import functools

import torch

NAMESPACE = "ffcnn"
LIB = torch.library.Library(NAMESPACE, "DEF")
# torch before 2.4 names it impl_abstract
_register_fake = getattr(torch.library, "register_fake", None) or \
    torch.library.impl_abstract


def _tensors(args):
    for a in args:
        if isinstance(a, torch.Tensor):
            yield a
        elif isinstance(a, (list, tuple)):
            yield from _tensors(a)


def _fake_or_refuse(name, fake, *args):
    """The fake implementation, which also serves the meta device: a fake
    tensor reports the device it stands for, so a tensor on ``meta`` here
    is a real meta tensor, and it is refused."""
    devices = {t.device.type for t in _tensors(args)}
    if "meta" in devices:
        raise ValueError(f"{NAMESPACE}::{name} takes CPU or CUDA tensors, "
                         f"got {sorted(devices)}")
    return fake(*args)


def define(schema: str, *, cpu, cuda, fake) -> torch._ops.OpOverload:
    """Define ``ffcnn::<schema>`` with its CPU, CUDA and fake
    implementations; returns the op's default overload."""
    name = schema.split("(", 1)[0]
    LIB.define(schema)
    LIB.impl(name, cpu, "CPU")
    LIB.impl(name, cuda, "CUDA")
    _register_fake(f"{NAMESPACE}::{name}",
                   functools.partial(_fake_or_refuse, name, fake), lib=LIB)
    return getattr(getattr(torch.ops, NAMESPACE), name).default
