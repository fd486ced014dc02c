"""Greedy NMS keep mask (K2): the CUDA kernel's wrapper and its plain
PyTorch version.

Replaces ``ffcnn_tpu/kernels/nms_pallas.py::_nms_kernel`` (``nms_keep_mask``).
In JAX the greedy scan is one compiled program; eager PyTorch would launch
about a dozen kernels per candidate, so on the card the whole recurrence runs
in one launch (``csrc/nms.cu``: one CTA per image, keep flags in shared
memory, the recurrence resolved 32 anchors at a time on one warp's register
bitset, so 1 + 2 * ceil(K / 32) barriers in place of K - 1).  The kernel and
the plain version give the same mask bit for bit (IEEE division, no FMA
contraction).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build, _library


def _iou(box: torch.Tensor, others: torch.Tensor, kind: str) -> torch.Tensor:
    """IoU of ``box`` (N, 4) against ``others`` (N, K, 4) -> (N, K)."""
    x1 = torch.maximum(box[:, None, 0], others[..., 0])
    y1 = torch.maximum(box[:, None, 1], others[..., 1])
    x2 = torch.minimum(box[:, None, 2], others[..., 2])
    y2 = torch.minimum(box[:, None, 3], others[..., 3])
    inter = torch.where((x1 < x2) & (y1 < y2), (x2 - x1) * (y2 - y1),
                        torch.zeros((), dtype=x1.dtype, device=x1.device))
    a1 = (box[:, 2] - box[:, 0]) * (box[:, 3] - box[:, 1])
    a2 = (others[..., 2] - others[..., 0]) * (others[..., 3] - others[..., 1])
    if kind == "union":
        return inter / (a1[:, None] + a2 - inter)
    return inter / torch.minimum(a1[:, None], a2)


def keep_mask_plain(boxes: torch.Tensor, scores: torch.Tensor,
                    classes: torch.Tensor, threshold: float,
                    iou_kind: str = "min") -> torch.Tensor:
    """The greedy scan of ``ffcnn_tpu/ops/nms.py::_keep_mask_scan``: K steps,
    each suppressing later same-class boxes that overlap a kept anchor."""
    k = boxes.shape[1]
    slot = torch.arange(k, device=boxes.device)
    keep = scores > 0                  # only ever cleared: keep => score > 0
    # an anchor no image keeps suppresses nothing: on the CPU, where the
    # test is free, the scan skips it (on the card it would wait for the
    # device at every step)
    skip = keep.device.type == "cpu"
    for i in range(k):
        if skip and not bool(keep[:, i].any()):
            continue
        iou = _iou(boxes[:, i], boxes, iou_kind)
        same = classes == classes[:, i:i + 1]
        keep = keep & ~(keep[:, i:i + 1] & same & (slot > i)[None]
                        & (iou > threshold))
    return keep


def _nms_cuda(boxes, scores, classes, threshold, union_iou):
    n, k = scores.shape
    for name, t, dt, shape in (("boxes", boxes, torch.float32, (n, k, 4)),
                               ("scores", scores, torch.float32, (n, k)),
                               ("classes", classes, torch.int32, (n, k))):
        if t.device != scores.device or t.device.type != "cuda":
            raise ValueError(f"{name} must be on the same CUDA device")
        if t.dtype != dt or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous {dt} {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
    if boxes.data_ptr() % 16:
        raise ValueError("boxes must be 16-byte aligned")
    keep = torch.empty((n, k), dtype=torch.bool, device=boxes.device)
    lib = build()
    err = lib.ffcnn_nms_keep(boxes.data_ptr(), scores.data_ptr(),
                             classes.data_ptr(), keep.data_ptr(), n, k,
                             float(threshold), int(union_iou),
                             _build.stream_ptr())
    nms_keep_mask.launches += 1
    if err:
        raise RuntimeError("nms keep-mask launch failed: "
                           + lib.ffcnn_nms_error_string(err).decode())
    return keep


NMS_OP = _library.define(
    "nms_keep_mask(Tensor boxes, Tensor scores, Tensor classes, "
    "float threshold, bool union_iou) -> Tensor",
    cpu=lambda b, s, c, t, u: keep_mask_plain(b, s, c, t,
                                              "union" if u else "min"),
    cuda=_nms_cuda,
    fake=lambda b, s, c, t, u: s.new_empty(s.shape, dtype=torch.bool))


def nms_keep_mask(boxes: torch.Tensor, scores: torch.Tensor,
                  classes: torch.Tensor, *, threshold: float,
                  iou_kind: str = "min") -> torch.Tensor:
    """boxes (N, K, 4) f32, scores (N, K) f32 sorted descending (0 = absent),
    classes (N, K) int32 -> keep mask (N, K) bool, through
    ``ffcnn::nms_keep_mask``.

    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    if iou_kind not in ("min", "union"):
        raise ValueError(f"iou_kind must be 'min' or 'union', got {iou_kind!r}")
    return NMS_OP(boxes, scores, classes, float(threshold),
                  iou_kind == "union")


nms_keep_mask.launches = 0


@functools.cache
def build() -> ctypes.CDLL:
    """Build (if needed) and load the kernel's library."""
    lib = _build.load_library("nms")
    fn = lib.ffcnn_nms_keep
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_int,
                                           ctypes.c_float, ctypes.c_int,
                                           ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.ffcnn_nms_error_string.argtypes = [ctypes.c_int]
    lib.ffcnn_nms_error_string.restype = ctypes.c_char_p
    return lib
