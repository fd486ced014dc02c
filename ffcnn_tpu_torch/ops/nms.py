"""Top-k + greedy NMS on fixed-size tensors, the PyTorch port of
``ffcnn_tpu/ops/nms.py::nms``.

The reference (ffcnn.c:298-335) sorts candidates by score and greedily
suppresses later same-class boxes whose IoU exceeds the threshold (strict
``>``), then rescales survivors to original-image pixels by ``s1/s2``.
Here a stable descending sort picks the top K (equal scores keep their
(head, row, col, anchor) order, which ``torch.topk`` does not promise), and
the keep mask comes from ``kernels/nms.py`` (one launch on the card).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..kernels.nms import nms_keep_mask
from ..tuning import get_flag

V8_NMS_THRESHOLD = 0.7     # pure-YOLOv8 graphs: the public default IoU


def v8_nms_threshold() -> float:
    """The union-IoU threshold of a pure-v8 graph: ``FFCNN_V8_NMS_IOU``,
    else V8_NMS_THRESHOLD (``ffcnn_tpu/ops/nms.py::v8_nms_threshold``).  A
    ``Net`` reads it once, when it is built."""
    return float(get_flag("FFCNN_V8_NMS_IOU", str(V8_NMS_THRESHOLD)))


class NMSResult(NamedTuple):
    boxes: torch.Tensor      # (N, K, 4) original-image pixel coords
    scores: torch.Tensor     # (N, K), 0 for empty/suppressed slots
    classes: torch.Tensor    # (N, K) int32
    count: torch.Tensor      # (N,) int32 number of valid detections
    saturated: torch.Tensor  # (N,) bool: more above-threshold candidates
    #                          than K, so top-k dropped some before NMS


def nms(boxes: torch.Tensor, scores: torch.Tensor, classes: torch.Tensor, *,
        k: int = 128, threshold: float = 0.5, scale1: int = 1,
        scale2: int = 1, iou_kind: str = "min") -> NMSResult:
    """boxes (N, M, 4), scores (N, M) with 0 = absent, classes (N, M).

    ``iou_kind``: 'min' = the reference's inter/min(area) quirk (default);
    'union' = the standard metric."""
    n, m, _ = boxes.shape
    k = min(k, m)
    # census before truncation: the reference NMS-es every above-threshold
    # box, so more than K of them means top-k may change the result
    saturated = torch.sum(scores > 0, dim=1) > k
    top_scores, idx = torch.sort(scores, dim=1, descending=True, stable=True)
    top_scores, idx = top_scores[:, :k].contiguous(), idx[:, :k]
    top_boxes = torch.gather(boxes, 1, idx[..., None].expand(n, k, 4))
    top_classes = torch.gather(classes, 1, idx).to(torch.int32)
    keep = nms_keep_mask(top_boxes.contiguous(), top_scores,
                         top_classes.contiguous(), threshold=threshold,
                         iou_kind=iou_kind)
    rescale = float(np.float32(scale1) / np.float32(scale2))  # ffcnn.c:327
    return NMSResult(boxes=top_boxes * rescale,
                     scores=torch.where(keep, top_scores,
                                        torch.zeros((), device=keep.device)),
                     classes=top_classes,
                     count=keep.sum(dim=1).to(torch.int32),
                     saturated=saturated)
