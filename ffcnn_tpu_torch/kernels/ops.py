"""Every ``ffcnn::`` op a ``Net`` path launches, registered by importing
the modules that define them (``_library.define``).  An artifact loader
imports this module before ``torch.export.load``; it imports no graph
builder, no ``net.py`` and no cfg parser.

    ffcnn::fused_block       K1  kernels/block_fused.py  csrc/block_fused.cu
    ffcnn::fused_down_block  K3  kernels/block_fused.py  csrc/block_down.cu
    ffcnn::fused_cascade     K4  kernels/block_fused.py  csrc/block_cascade.cu
    ffcnn::fused_mega        K5  kernels/block_fused.py  csrc/block_mega.cu
    ffcnn::conv0_cs          K6  kernels/conv0_fused.py  csrc/conv0_fused.cu
    ffcnn::head_run          K7  kernels/head_fused.py   csrc/head_fused.cu
    ffcnn::nms_keep_mask     K2  kernels/nms.py          csrc/nms.cu
    ffcnn::conv_int8             kernels/conv_int8.py    csrc/conv_int8.cu

One more op carries no kernel of the port, only a precision: a conv that
the float32 knobs force, cuDNN with TF32 off (``PRECISION_OPS``).

    ffcnn::conv2d_f32            ops/conv.py             (cuDNN)
"""

from __future__ import annotations

from ..ops import conv as _conv
from . import block_fused, conv0_fused, conv_int8, head_fused, nms
from ._library import NAMESPACE

OPS = {"fused_block": block_fused.FUSED_BLOCK_OP,
       "fused_down_block": block_fused.FUSED_DOWN_BLOCK_OP,
       "fused_cascade": block_fused.FUSED_CASCADE_OP,
       "fused_mega": block_fused.FUSED_MEGA_OP,
       "conv0_cs": conv0_fused.CONV0_OP,
       "head_run": head_fused.HEAD_OP,
       "nms_keep_mask": nms.NMS_OP,
       "conv_int8": conv_int8.CONV_INT8_OP}

PRECISION_OPS = {"conv2d_f32": _conv.CONV2D_F32_OP}

__all__ = ["NAMESPACE", "OPS", "PRECISION_OPS"]
