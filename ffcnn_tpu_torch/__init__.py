"""ffcnn-tpu on PyTorch and CUDA: the port of ``ffcnn_tpu`` to an NVIDIA
Hopper card.  Imports torch, never jax; the host-side darknet and BMP code
comes from ``ffcnn_tpu.darknet`` and ``ffcnn_tpu.imageio`` unchanged and is
re-exported here, so a caller of the port names only this package."""

from ffcnn_tpu.darknet.cfg import parse_cfg
from ffcnn_tpu.darknet.ir import LayerType
from ffcnn_tpu.darknet.weights import synth_weights_bytes
from ffcnn_tpu.imageio.bmp import bmp_load

from .net import DEFAULT_MEAN, DEFAULT_NORM, Detection, Net, load

__all__ = ["Net", "Detection", "load", "DEFAULT_MEAN", "DEFAULT_NORM",
           "LayerType", "bmp_load", "parse_cfg", "synth_weights_bytes"]
