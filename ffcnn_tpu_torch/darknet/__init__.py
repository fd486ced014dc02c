"""The port's Darknet host code: cfg parser, IR and weights reader, copies
of ``ffcnn_tpu/darknet/`` with the same names (the port imports nothing of
the JAX package)."""

from .ir import (Activation, BlobShape, Layer, LayerType, NetIR,
                 ACTIVATION_NAMES, LAYER_TYPE_NAMES)
from .cfg import parse_cfg, dump
from .weights import load_weights, FoldedConvParams

__all__ = ["Activation", "BlobShape", "Layer", "LayerType", "NetIR",
           "ACTIVATION_NAMES", "LAYER_TYPE_NAMES", "parse_cfg", "dump",
           "load_weights", "FoldedConvParams"]
