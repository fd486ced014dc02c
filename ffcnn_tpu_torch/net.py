"""ffcnn-shaped public API on PyTorch: ``Net.load(cfg, weights)`` ->
``net.detect(images)``, the port of ``ffcnn_tpu/net.py``.

    net_load    -> Net.load   (parse cfg, fold BN, params to the device)
    net_input   -> detect     (letterbox on the device)
    net_forward -> detect     (forward, YOLO decode, NMS, batched)
    net_dump    -> Net.dump   (byte-identical layer table)

Modes:
  * ``parity``: float32 with TF32 off for convs and matmuls (the JAX
    package's ``Precision.HIGHEST``); no fused kernels.
  * ``fast``: bfloat16 blobs with float32 accumulation; BGR swap and
    normalize folded into conv-1; the fused inverted-residual runs go
    through the block kernels at every batch size.

Fast mode reads the JAX package's fusion flags once, when the Net is built:
``FFCNN_FUSED=0`` (the kill switch: no fused block run is planned, and the
stem then runs as a plain conv, as in JAX; the head chains keep their own
flag), ``FFCNN_FUSED_MINC`` and ``FFCNN_FUSED_DOWN`` (the planned runs; with
``DOWN=1, MINC=8`` they span whole backbone regions, stride-2 blocks
included), ``FFCNN_CONV0_PALLAS`` (the uint8 stem kernel, feeding a run at
layer 1) and ``FFCNN_FUSED_HEADS`` (the fused yolo-head chains).  All four
set is the region configuration; none set plans the default runs.  Three
more choose how a run's blocks launch: ``FFCNN_FUSED_CASCADE=k`` (up to k
consecutive stride-1 blocks in one launch, K4), ``FFCNN_FUSED_MEGA`` (a run
of stride-1 blocks that passes ``mega_fits`` in one launch, K5) and
``FFCNN_FUSED_STORE=f32`` (the boundaries between launches in float32).
``FFCNN_HEAD_F32``, ``FFCNN_F32_STAGES`` and ``FFCNN_CONV0_INT8=1`` (conv-1
in int8) are not ported: a fast Net refuses them.  A parity Net refuses
``FFCNN_PARITY_PRECISION=high`` (JAX's 3-pass bf16 convs; TF32 would be a
different rounding, not the same one).
"""

from __future__ import annotations

import contextlib
import os
import typing
import warnings
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from .darknet import cfg as cfg_mod
from .darknet import weights as weights_mod
from .darknet.ir import LayerType, NetIR
from .graph.build import (fold_input_transform, forward_features,
                          params_from_numpy)
from .kernels.block_fused import (block_params, cascade_groups,
                                  check_chain_fits, mega_fits, plan_runs)
from .kernels.conv0_fused import conv0_params
from .kernels.head_fused import check_fits, head_params, plan_head_runs
from .ops.nms import NMSResult, nms
from .ops.preprocess import letterbox, letterbox_params, letterbox_uint8
from .ops.yolo import (apply_arena_cap, arena_capacity, concat_heads,
                       decode_head)
from .tuning import get_flag

# Demo defaults (ffcnn.c:556-557)
DEFAULT_MEAN = (0.0, 0.0, 0.0)
DEFAULT_NORM = (1 / 255.0, 1 / 255.0, 1 / 255.0)
NMS_THRESHOLD = 0.5          # hardcoded in the reference (ffcnn.c:519)


class Detection(typing.NamedTuple):
    """One detection in original-image pixel coords (reference BBOX,
    ffcnn.h:29-32)."""
    score: float
    class_id: int
    x1: float
    y1: float
    x2: float
    y2: float


@contextlib.contextmanager
def _tf32(allow: bool):
    """Set cuDNN's and cuBLAS's TF32 switches for the block, then restore
    them (they are process-wide)."""
    old = (torch.backends.cudnn.allow_tf32,
           torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = allow
    torch.backends.cuda.matmul.allow_tf32 = allow
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = old


class Net:
    def __init__(self, ir: NetIR, params: Dict, *, mode: str = "fast",
                 topk: int = 128, device="cuda"):
        if mode == "int8":
            raise NotImplementedError("int8 mode is not ported yet")
        if mode not in ("fast", "parity"):
            raise ValueError(f"mode must be 'fast' or 'parity', got {mode!r}")
        if any(l.type == LayerType.YOLOV8 for l in ir.layers):
            raise NotImplementedError("[yolov8] heads are not ported yet")
        fast = mode == "fast"
        # the JAX package's float32 accuracy knobs change what fast mode
        # computes (parity mode ignores them, as there)
        if fast and get_flag("FFCNN_HEAD_F32", "0") == "1":
            raise NotImplementedError("FFCNN_HEAD_F32 (head chains in "
                                      "float32) is not ported yet")
        if fast and get_flag("FFCNN_F32_STAGES", ""):
            raise NotImplementedError("FFCNN_F32_STAGES (float32 stages) is "
                                      "not ported yet")
        if fast and get_flag("FFCNN_CONV0_INT8", "0") == "1":
            raise NotImplementedError("FFCNN_CONV0_INT8 (conv-1 in int8) is "
                                      "not ported yet")
        if not fast and get_flag("FFCNN_PARITY_PRECISION",
                                 "highest").lower() == "high":
            raise NotImplementedError("FFCNN_PARITY_PRECISION=high (3-pass "
                                      "bf16 parity convs) is not ported")
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device='cuda' but CUDA is not available")
        self.ir = ir
        self.mode = mode
        self.topk = topk
        self.params = params_from_numpy(params, self.device)
        self._dtype = torch.float32 if mode == "parity" else torch.bfloat16
        # parity mode runs no fused kernel, for parity with the reference;
        # fast mode resolves the flags here, as the JAX Net does in its
        # constructor and when it traces a pipeline (FFCNN_FUSED=0: JAX's
        # runs_usable turns every run off)
        self._fused_runs = plan_runs(ir) if fast and os.environ.get(
            "FFCNN_FUSED", "1") != "0" else []
        self._fused_params = {r.start: [block_params(ir, self.params, b)
                                        for b in r.blocks]
                              for r in self._fused_runs}
        # how each run launches: groups of up to FFCNN_FUSED_CASCADE blocks
        # (read as JAX's run_blocks_cs reads it), the whole run where
        # FFCNN_FUSED_MEGA is set and the JAX mega gate holds (read from the
        # environment, as JAX's apply_run does), and the boundary storage
        casc = int(get_flag("FFCNN_FUSED_CASCADE", "0"))
        self._fused_groups = {r.start: cascade_groups(r, casc)
                              for r in self._fused_runs}
        mega = os.environ.get("FFCNN_FUSED_MEGA", "0") != "0"
        self._mega_runs = frozenset(
            r.start for r in self._fused_runs
            if mega and not any(b.down for b in r.blocks)
            and mega_fits(ir, r))
        self._mid_dtype = torch.float32 if get_flag(
            "FFCNN_FUSED_STORE", "input") == "f32" else None
        self._head_runs = plan_head_runs(ir) if fast and os.environ.get(
            "FFCNN_FUSED_HEADS", "0") == "1" else []
        self._head_params = {r.start: head_params(ir, self.params, r)
                             for r in self._head_runs}
        if self.device.type == "cuda":
            for hp in self._head_params.values():
                check_fits(hp)
            self._check_chains_fit()
        self._conv0_pallas = fast and get_flag("FFCNN_CONV0_PALLAS",
                                               "0") == "1"
        # (folded params, their stem params) per (mean, norm); the demo
        # default's are made now, with every other kernel's params
        self._folded: Dict[tuple, tuple] = {}
        if self._can_fold_input():
            self._folded_params(DEFAULT_MEAN, DEFAULT_NORM)

    def _check_chains_fit(self) -> None:
        """Raise if a cascade group or a mega run cannot run on the card
        (the chained kernels' shared memory), as ``check_fits`` does for
        the head chains."""
        for r in self._fused_runs:
            b = self.ir.blobs[r.start]
            bps = self._fused_params[r.start]
            if r.start in self._mega_runs:
                # one CTA an image (large batches) holds the larger map
                check_chain_fits(b.h, b.w, bps, mega=True, cluster=1)
                continue
            i = 0
            for g in self._fused_groups[r.start]:
                if len(g) > 1:
                    gb = self.ir.blobs[g[0].start]
                    check_chain_fits(gb.h, gb.w, bps[i:i + len(g)])
                i += len(g)

    # ------------------------------------------------------------------ load
    @classmethod
    def load(cls, cfg_path: str, weights=None, input_w: int = 0,
             input_h: int = 0, *, mode: str = "fast", topk: int = 128,
             allow_missing_weights: bool = False, device="cuda") -> "Net":
        """Parse cfg + weights (a path or the file's bytes).  ``input_w/h``
        override the [net] dims with ALIGN(dim, 32) like net_load
        (ffcnn.c:133-134).  ``device``: the card unless the caller asks
        for ``"cpu"``."""
        ir = cfg_mod.parse_cfg(cfg_path, input_w, input_h)
        if weights is None:
            if not allow_missing_weights:
                raise ValueError("weights required "
                                 "(or pass allow_missing_weights=True)")
            params = weights_mod.zero_weights(ir)
        else:
            params, _ = weights_mod.load_weights(ir, weights)
        return cls(ir, params, mode=mode, topk=topk, device=device)

    def dump(self) -> str:
        """net_dump-compatible layer table (ffcnn.c:522-548)."""
        return cfg_mod.dump(self.ir)

    # ------------------------------------------------------------- pipeline
    def _can_fold_input(self) -> bool:
        first = self.ir.layers[0]
        return (self.mode == "fast" and first.type == LayerType.CONV
                and first.groups == 1)

    def _folded_params(self, mean, norm):
        """Conv-1 with the input transform folded in, and the stem kernel's
        params made from it (None without ``FFCNN_CONV0_PALLAS``), cached
        per (mean, norm)."""
        key = (mean, norm)
        if key not in self._folded:
            params = fold_input_transform(self.ir, self.params, mean, norm)
            l0 = self.ir.layers[0]
            c0 = conv0_params(self.ir, params) if (
                self._conv0_pallas and 1 in self._fused_params
                and (l0.fs, l0.stride, l0.pad) == (3, 2, 1)) else None
            self._folded[key] = (params, c0)
        return self._folded[key]

    def _max_candidates(self) -> int:
        """Most head candidates the model can emit at its input size,
        clamped by the reference's bbox arena (ffcnn.c:243)."""
        total = sum(self.ir.blobs[li].w * self.ir.blobs[li].h * 3
                    for li, l in enumerate(self.ir.layers)
                    if l.type == LayerType.YOLO)
        b0 = self.ir.blobs[0]
        return min(total, arena_capacity(b0.w, b0.h, b0.c))

    def forward_heads(self, batch: torch.Tensor, mean=DEFAULT_MEAN,
                      norm=DEFAULT_NORM) -> List[torch.Tensor]:
        """uint8 (N, H, W, 3) BGR on the net's device -> the raw yolo head
        maps, after the same letterbox and forward that detect runs."""
        ir = self.ir
        net_w, net_h = ir.blobs[0].w, ir.blobs[0].h
        mean = tuple(float(v) for v in np.asarray(mean).reshape(3))
        norm = tuple(float(v) for v in np.asarray(norm).reshape(3))
        with _tf32(self.mode == "fast"):
            if self._can_fold_input() and mean == DEFAULT_MEAN:
                params, c0 = self._folded_params(mean, norm)
                x = letterbox_uint8(batch, net_w, net_h)
            else:
                params, c0 = self.params, None
                x = letterbox(batch, net_w, net_h, mean, norm,
                              dtype=self._dtype)
            return forward_features(ir, params, x, input_dtype=self._dtype,
                                    fused_runs=self._fused_runs,
                                    fused_params=self._fused_params,
                                    fused_groups=self._fused_groups,
                                    mega_runs=self._mega_runs,
                                    fused_mid_dtype=self._mid_dtype,
                                    head_runs=self._head_runs,
                                    head_params=self._head_params,
                                    conv0_pallas=c0 is not None,
                                    conv0_params=c0)

    def detect_device(self, batch, mean=DEFAULT_MEAN, norm=DEFAULT_NORM,
                      topk: Optional[int] = None) -> NMSResult:
        """Device-level entry: uint8 (N, H, W, 3) BGR (numpy or a tensor) ->
        NMSResult tensors on the net's device (no host sync)."""
        batch = torch.as_tensor(np.asarray(batch) if not isinstance(
            batch, torch.Tensor) else batch).to(self.device)
        n, h, w, _ = batch.shape
        ir = self.ir
        net_w, net_h = ir.blobs[0].w, ir.blobs[0].h
        _, _, s1, s2 = letterbox_params(w, h, net_w, net_h)
        feats = self.forward_heads(batch, mean, norm)
        heads = [l for l in ir.layers if l.type == LayerType.YOLO]
        decoded = concat_heads([decode_head(f, l, net_w, net_h)
                                for f, l in zip(feats, heads)])
        decoded = apply_arena_cap(decoded,
                                  arena_capacity(net_w, net_h, ir.blobs[0].c))
        return nms(decoded.boxes, decoded.scores, decoded.classes,
                   k=self.topk if topk is None else topk,
                   threshold=NMS_THRESHOLD, scale1=s1, scale2=s2,
                   iou_kind="min")

    # ----------------------------------------------------------------- detect
    def detect(self, images, mean=DEFAULT_MEAN, norm=DEFAULT_NORM,
               ) -> Union[List[Detection], List[List[Detection]]]:
        """Run detection.  ``images``: one (H, W, 3) uint8 BGR array or a
        batch (N, H, W, 3).  Returns a Detection list (single image) or a
        list of lists (batch)."""
        single = isinstance(images, np.ndarray) and images.ndim == 3
        batch = np.asarray(images)[None] if single else np.asarray(images)
        if batch.ndim != 4 or batch.shape[-1] != 3:
            raise ValueError(f"expected (N, H, W, 3) uint8, got {batch.shape}")
        res = self.detect_device(batch, mean, norm)
        out = self._finish(res, batch, mean, norm)
        return out[0] if single else out

    def _finish(self, res: NMSResult, batch, mean, norm
                ) -> List[List[Detection]]:
        """Resolve a result to Detection lists.  If a frame had more
        above-threshold candidates than topk, top-k truncated before
        suppression: parity mode grows K and retries until the census fits;
        fast mode warns."""
        max_k = self._max_candidates()
        k = min(self.topk, max_k)
        while bool(res.saturated.any()) and k < max_k:
            k = min(max_k, k * 4)
            if self.mode != "parity":
                warnings.warn(
                    f"NMS top-k saturated (k={self.topk}); some candidates "
                    f"were dropped pre-suppression. Raise topk (model max "
                    f"{max_k}) for crowded scenes.", RuntimeWarning,
                    stacklevel=3)
                break
            res = self.detect_device(batch, mean, norm, topk=k)
        return self._to_detections(res)

    @staticmethod
    def _to_detections(res: NMSResult) -> List[List[Detection]]:
        scores = res.scores.cpu().numpy()
        ii, jj = np.nonzero(scores > 0)
        sel_scores = scores[ii, jj].astype(float)
        sel_classes = res.classes.cpu().numpy()[ii, jj]
        sel_boxes = res.boxes.cpu().numpy()[ii, jj].astype(float)
        counts = res.count.cpu().numpy()
        out: List[List[Detection]] = [[] for _ in range(scores.shape[0])]
        for i, s, c, (x1, y1, x2, y2) in zip(
                ii.tolist(), sel_scores.tolist(), sel_classes.tolist(),
                sel_boxes.tolist()):
            out[i].append(Detection(s, int(c), x1, y1, x2, y2))
        if any(len(d) != n for d, n in zip(out, counts.tolist())):
            raise RuntimeError("NMS count disagrees with its score mask")
        return out


def load(cfg_path: str, weights=None, *, input_w: int = 0, input_h: int = 0,
         mode: str = "fast", device="cuda", **kw) -> Net:
    """Module-level convenience mirroring ``net_load`` (ffcnn.h:48); on the
    card unless ``device="cpu"``."""
    return Net.load(cfg_path, weights, input_w, input_h, mode=mode,
                    device=device, **kw)
