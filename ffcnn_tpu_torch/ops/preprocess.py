"""Letterbox preprocess on the device, the PyTorch port of
``ffcnn_tpu/ops/preprocess.py``.

Replicates ``net_input`` (ffcnn.c:259-289): aspect-preserving nearest resize
anchored top-left with integer source-index math, zero pad right/bottom,
BGR->RGB, per-channel ``(px - mean) * norm``.  Raw uint8 frames are the only
host->device transfer.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch


def letterbox_params(img_w: int, img_h: int, net_w: int, net_h: int
                     ) -> Tuple[int, int, int, int]:
    """(sw, sh, s1, s2) per ffcnn.c:267-273 (integer math)."""
    if img_w * net_h > img_h * net_w:
        sw = net_w
        sh = sw * img_h // img_w
        s1, s2 = img_w, sw
    else:
        sh = net_h
        sw = sh * img_w // img_h
        s1, s2 = img_h, sh
    return sw, sh, s1, s2


@functools.cache
def _source_rows(n: int, s1: int, s2: int, device: torch.device
                 ) -> torch.Tensor:
    """The source index of each of ``n`` resized rows (or columns),
    ``i * s1 // s2`` (ffcnn.c:276-277), on ``device``: made once per
    geometry and device, not copied over per call."""
    return torch.from_numpy((np.arange(n) * s1) // s2).to(device)


@functools.cache
def _channel_constants(mean, norm, dtype: torch.dtype,
                       device: torch.device):
    """``mean`` and ``norm`` as (3,) tensors of ``dtype`` on ``device``,
    made once per value, dtype and device."""
    return (torch.as_tensor(mean, dtype=dtype, device=device),
            torch.as_tensor(norm, dtype=dtype, device=device))


def _resize_pad(bgr: torch.Tensor, net_w: int, net_h: int) -> torch.Tensor:
    """Nearest resize (top-left anchored) + zero pad right/bottom, in the
    input dtype.  Identity when the image already has the net dims."""
    n, h, w, c = bgr.shape
    sw, sh, s1, s2 = letterbox_params(w, h, net_w, net_h)
    if (sw, sh) != (w, h):
        ys = _source_rows(sh, s1, s2, bgr.device)
        xs = _source_rows(sw, s1, s2, bgr.device)
        bgr = bgr[:, ys][:, :, xs]                    # (N, sh, sw, 3) BGR
    if (sw, sh) != (net_w, net_h):
        out = torch.zeros((n, net_h, net_w, c), dtype=bgr.dtype,
                          device=bgr.device)
        out[:, :sh, :sw] = bgr
        bgr = out
    return bgr


def letterbox_uint8(bgr: torch.Tensor, net_w: int, net_h: int) -> torch.Tensor:
    """Fast-path preprocess: uint8 resize+pad only.  BGR->RGB, normalize and
    the float cast are folded into the first conv
    (graph/build.py:fold_input_transform)."""
    return _resize_pad(bgr, net_w, net_h)


def letterbox(bgr: torch.Tensor, net_w: int, net_h: int,
              mean=(0.0, 0.0, 0.0), norm=(1 / 255.0, 1 / 255.0, 1 / 255.0),
              dtype=torch.float32) -> torch.Tensor:
    """uint8 (N, H, W, 3) BGR -> (N, net_h, net_w, 3) float RGB net input."""
    n, h, w, _ = bgr.shape
    sw, sh, s1, s2 = letterbox_params(w, h, net_w, net_h)
    patch = _resize_pad(bgr, net_w, net_h)
    rgb = patch.flip(-1).to(dtype)
    mean_t, norm_t = _channel_constants(
        *(tuple(float(v) for v in np.asarray(c).reshape(3))
          for c in (mean, norm)), dtype, bgr.device)
    val = (rgb - mean_t) * norm_t
    if (sw, sh) == (net_w, net_h):
        return val
    # zero the padded border exactly (the pad ran on raw uint8)
    val[:, sh:] = 0
    val[:, :, sw:] = 0
    return val
