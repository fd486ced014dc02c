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

``decode_head_v8`` decodes the anchor-free ``[yolov8]`` head (an extension
with no reference counterpart): the DFL expectation over ``reg_max`` bins a
box side, one candidate a cell.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..darknet.ir import Layer, LayerType


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


def decode_head_v8(feat: torch.Tensor, layer: Layer, net_w: int, net_h: int
                   ) -> DecodedBoxes:
    """feat: (N, h, w, 4*reg_max + classes), the box branch's DFL logits
    (4 sides x reg_max bins) then the class logits, as
    ``ffcnn_tpu/ops/yolo.py::decode_head_v8`` decodes it:

      * DFL in float32 whatever the feat's dtype: the logits less their
        logsumexp, exponentiated and dotted with the bin indices, giving
        the (l, t, r, b) distances in stride units (not ``torch.softmax``,
        whose rounding differs);
      * anchor points at the cell centres, ``(j + 0.5, i + 0.5) * stride``;
      * score = sigmoid(the largest class logit), class = its first-max
        index, in the feat's own dtype; no objectness term; scores below
        ``ignore_thres`` (the cfg's ``conf``) give 0.

    Boxes come out in net-input pixels, as ``decode_head``'s do."""
    n, h, w, _ = feat.shape
    rm, stride = layer.reg_max, layer.stride
    box = feat[..., :4 * rm].float().reshape(n, h, w, 4, rm)
    box = box - torch.logsumexp(box, dim=-1, keepdim=True)
    bins = torch.arange(rm, dtype=torch.float32, device=feat.device)
    dist = torch.sum(torch.exp(box) * bins, dim=-1)      # (N, h, w, 4)
    cidx, cs = _argmax_max(feat[..., 4 * rm:])
    conf = torch.reciprocal(1.0 + torch.exp(-cs))
    conf = torch.where(conf >= layer.ignore_thres, conf,
                       torch.zeros((), dtype=conf.dtype, device=conf.device))
    dev = feat.device
    jj = (torch.arange(w, dtype=torch.float32, device=dev) + 0.5)[None, None]
    ii = (torch.arange(h, dtype=torch.float32, device=dev) + 0.5)[None, :,
                                                                   None]
    boxes = torch.stack([(jj - dist[..., 0]) * stride,
                         (ii - dist[..., 1]) * stride,
                         (jj + dist[..., 2]) * stride,
                         (ii + dist[..., 3]) * stride], dim=-1)
    m = h * w
    return DecodedBoxes(boxes.reshape(n, m, 4), conf.reshape(n, m),
                        cidx.reshape(n, m))


def decode_heads(ir, feats, net_w: int, net_h: int) -> DecodedBoxes:
    """Every head's candidates, each decoded by its type (``[yolo]`` or
    ``[yolov8]``), in graph order: the list ``forward_features`` returns."""
    heads = [l for l in ir.layers
             if l.type in (LayerType.YOLO, LayerType.YOLOV8)]
    return concat_heads([
        decode_head_v8(f, l, net_w, net_h) if l.type == LayerType.YOLOV8
        else decode_head(f, l, net_w, net_h) for f, l in zip(feats, heads)])


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
