"""Vectorized YOLO head decode, the PyTorch port of ``ffcnn_tpu/ops/yolo.py``
(the anchor-slice formulation).

Numerical quirks reproduced from the reference (layer_yolo_forward,
ffcnn.c:438-474):

  * combined confidence ``1 / (1 + exp(-bs) * (1 + exp(-cs)))`` (ffcnn.c:451),
    an approximation of sigmoid(bs)*sigmoid(cs), not the darknet formula
  * ``scale_x_y`` multiplies box w/h (ffcnn.c:459-460)
  * class = argmax with first-max tie-breaking (the C ``cs < val`` scan)
  * candidate order = (row, col, anchor) scan order, heads in graph order

Boxes below ``ignore_thres`` get score 0; NMS treats score 0 as absent.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..darknet.ir import Layer


class DecodedBoxes(NamedTuple):
    boxes: torch.Tensor     # (N, M, 4) x1,y1,x2,y2 in net-input pixels
    scores: torch.Tensor    # (N, M) confidence, 0 where below threshold
    classes: torch.Tensor   # (N, M) float32 argmax class (integral values)


def _argmax_max(x: torch.Tensor):
    """(first-max argmax, max) over the last axis in the head's own dtype;
    both come back as float32."""
    val, idx = torch.max(x, dim=-1)
    return idx.float(), val.float()


@functools.cache
def _anchor_wh(anchors: Tuple[Tuple[int, int], ...], scale_x_y: float,
               device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """A head's anchor widths and heights times ``scale_x_y``, float32 on
    ``device``: made once per head and device, not copied over per call."""
    a = np.asarray(anchors, np.float32)                  # (3, 2)
    return (torch.from_numpy(a[:, 0] * scale_x_y).to(device),
            torch.from_numpy(a[:, 1] * scale_x_y).to(device))


def decode_head(feat: torch.Tensor, layer: Layer, net_w: int, net_h: int
                ) -> DecodedBoxes:
    """feat: (N, h, w, 3*(5+classes)) raw conv output of a yolo head.  Box
    and confidence fields are lifted to float32; the class argmax runs in
    the head's dtype (comparisons are exact in any float format)."""
    n, h, w, _ = feat.shape
    per = 5 + layer.class_num
    tx, ty, tw, th, bs = (torch.stack([feat[..., a * per + k]
                                       for a in range(3)], dim=-1).float()
                          for k in range(5))            # (N, h, w, 3) each
    am = [_argmax_max(feat[..., a * per + 5:(a + 1) * per]) for a in range(3)]
    cidx = torch.stack([a for a, _ in am], dim=-1)
    cs = torch.stack([c for _, c in am], dim=-1)

    conf = torch.reciprocal(1.0 + torch.exp(-bs) * (1.0 + torch.exp(-cs)))
    conf = torch.where(conf >= layer.ignore_thres, conf,
                       torch.zeros((), dtype=conf.dtype, device=conf.device))

    dev = feat.device
    jj = torch.arange(w, dtype=torch.float32, device=dev)[None, None, :, None]
    ii = torch.arange(h, dtype=torch.float32, device=dev)[None, :, None, None]
    sig = lambda v: torch.reciprocal(1.0 + torch.exp(-v))
    cx = (jj + sig(tx)) * (net_w / w)
    cy = (ii + sig(ty)) * (net_h / h)
    aw, ah = _anchor_wh(tuple(map(tuple, layer.anchors)), layer.scale_x_y,
                        dev)
    bw = torch.exp(tw) * aw
    bh = torch.exp(th) * ah

    boxes = torch.stack([cx - bw * 0.5, cy - bh * 0.5,
                         cx + bw * 0.5, cy + bh * 0.5], dim=-1)
    m = h * w * 3
    return DecodedBoxes(boxes.reshape(n, m, 4), conf.reshape(n, m),
                        cidx.reshape(n, m))


def concat_heads(heads) -> DecodedBoxes:
    return DecodedBoxes(
        boxes=torch.cat([h.boxes for h in heads], dim=1),
        scores=torch.cat([h.scores for h in heads], dim=1),
        classes=torch.cat([h.classes for h in heads], dim=1))


def arena_capacity(net_w: int, net_h: int, net_c: int) -> int:
    """The reference's bbox arena aliases the input blob (ffcnn.c:242-244):
    capacity = input bytes / sizeof(BBOX), BBOX being 24 bytes."""
    return (net_w * net_h * net_c * 4) // 24


def apply_arena_cap(decoded: DecodedBoxes, cap: int) -> DecodedBoxes:
    """Reference bbox-arena overflow (ffcnn.c:461): once ``cap``
    above-threshold candidates were appended, later ones are dropped, in the
    (head, row, col, anchor) append order.  A no-op when the model cannot
    overflow."""
    if decoded.scores.shape[1] <= cap:
        return decoded
    drop = torch.cumsum((decoded.scores > 0).to(torch.int32), dim=1) > cap
    return DecodedBoxes(boxes=decoded.boxes,
                        scores=decoded.scores.masked_fill(drop, 0.0),
                        classes=decoded.classes)
