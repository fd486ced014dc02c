"""ffcnn-tpu on PyTorch and CUDA: the port of ``ffcnn_tpu`` to an NVIDIA
Hopper card.  Imports torch and numpy, never jax and nothing of the JAX
package: the darknet and BMP host code are the port's own copies
(``darknet/``, ``imageio/``), re-exported here, so a caller of the port names
only this package.  ``Net`` and ``load`` run on the card unless the caller
passes ``device="cpu"``.

The names below load at their first use, so that importing a submodule
(``ffcnn_tpu_torch.export`` in a serving process that holds only
artifacts) does not import the graph builder.
"""

import importlib

_EXPORTS = {"Net": "net", "Detection": "runtime", "load": "net",
            "DEFAULT_MEAN": "net", "DEFAULT_NORM": "net",
            "LayerType": "darknet.ir", "bmp_load": "imageio.bmp",
            "parse_cfg": "darknet.cfg",
            "synth_weights_bytes": "darknet.weights"}

__all__ = list(_EXPORTS)


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f".{_EXPORTS[name]}", __name__),
                   name)
