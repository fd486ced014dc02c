"""ffcnn-tpu on PyTorch and CUDA: the port of ``ffcnn_tpu`` to an NVIDIA
Hopper card.  Imports torch and numpy, never jax and nothing of the JAX
package: the darknet and BMP host code are the port's own copies
(``darknet/``, ``imageio/``), re-exported here, so a caller of the port names
only this package.  ``Net`` and ``load`` run on the card unless the caller
passes ``device="cpu"``."""

from .darknet.cfg import parse_cfg
from .darknet.ir import LayerType
from .darknet.weights import synth_weights_bytes
from .imageio.bmp import bmp_load
from .net import DEFAULT_MEAN, DEFAULT_NORM, Detection, Net, load

__all__ = ["Net", "Detection", "load", "DEFAULT_MEAN", "DEFAULT_NORM",
           "LayerType", "bmp_load", "parse_cfg", "synth_weights_bytes"]
