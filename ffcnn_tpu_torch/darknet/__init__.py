"""The port's Darknet host code: cfg parser, IR and weights reader, copies
of ``ffcnn_tpu/darknet/`` with the same names (the port imports nothing of
the JAX package).  The names below load at their first use, so that the
kernels' modules, which read the IR, do not import the cfg parser."""

import importlib

_EXPORTS = {**dict.fromkeys(("Activation", "BlobShape", "Layer", "LayerType",
                             "NetIR", "ACTIVATION_NAMES",
                             "LAYER_TYPE_NAMES"), "ir"),
            "parse_cfg": "cfg", "dump": "cfg",
            "load_weights": "weights", "FoldedConvParams": "weights"}

__all__ = list(_EXPORTS)


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f".{_EXPORTS[name]}", __name__),
                   name)
