"""ffcnn-shaped public API on PyTorch: ``Net.load(cfg, weights)`` ->
``net.detect(images)``, the port of ``ffcnn_tpu/net.py``.

    net_load    -> Net.load   (parse cfg, fold BN, params to the device)
    net_input   -> detect     (letterbox on the device)
    net_forward -> detect     (forward, YOLO decode, NMS, batched)
    net_dump    -> Net.dump   (byte-identical layer table)
    net_profile -> Net.profile, Net.profile_layers (per layer, profiling.py)

``detect_device`` runs one pixels-to-boxes pipeline per (image size, top-k,
mean/norm) bucket, as the JAX package compiles one program per bucket.  On
the card each bucket captures itself as one CUDA graph per batch size
(letterbox, forward, decode, arena cap, top-k and the keep mask), fed from
a static input buffer; a call copies its batch in, replays the graph and
returns clones of the outputs.  ``warmup`` builds the buckets ahead of
traffic; ``detect_async`` and ``detect_stream`` keep batches in flight;
``forward_heads`` stays the eager path.

Modes:
  * ``parity``: float32 with TF32 off for convs and matmuls (the JAX
    package's ``Precision.HIGHEST``); no fused kernels.
  * ``fast``: bfloat16 blobs with float32 accumulation; BGR swap and
    normalize folded into conv-1; the fused inverted-residual runs go
    through the block kernels at every batch size.
  * ``int8``: fast mode's dtype, fold and block runs under an int8 plan
    (``quant.py``, from ``calibrate`` or ``set_quant_plan``; a first
    ``detect_device`` without one calibrates on its first 8 frames): the
    blobs the plan marks int8 are stored as int8 codes, the convs on them
    run through the int8 conv kernel, and a run's interior int8 boundaries
    go through K1/K3/K4 as codes.  No head chain runs, and no run takes the
    mega route, as in the JAX package.  ``FFCNN_INT8_MINC``,
    ``FFCNN_INT8_PERCH`` and ``FFCNN_INT8_PCT`` shape the calibration.

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

Two float32 accuracy knobs change what fast mode computes (parity mode
ignores them, as the JAX package does).  JAX reads them when it traces a
pipeline; a Net here reads them once, when it is built:
``FFCNN_HEAD_F32=1`` computes the conv chains feeding each ``[yolo]`` head
in float32 and supersedes the fused head chains (K7);
``FFCNN_F32_STAGES=20`` (a comma list of widths) computes every conv and
shortcut whose output has that width in float32, stage-locally, and drops
every fused run (K1/K3/K4/K5, K7) that overlaps a forced layer.  The two
compose by union.  A forced conv is one op, ``ffcnn::conv2d_f32``, which on
the card runs with cuDNN's TF32 off (so an exported program keeps it).
``FFCNN_CONV0_INT8=1`` (read once, when a fast or int8 Net is built; parity
mode ignores it, as JAX does) runs conv-1 straight off the uint8 pixels
through the int8 conv's uint8 mode on the folded path, before the stem
kernel, which it displaces.  A parity Net refuses
``FFCNN_PARITY_PRECISION=high`` (JAX's 3-pass bf16 convs; TF32 would be a
different rounding, not the same one).

``export`` writes a bucket as a ``torch.export`` artifact (``export.py``),
for the card, the CPU or both (``platforms``).

YOLOv8 graphs (``[yolov8]`` heads, from ``yolov8.py``'s converter) decode
by ``decode_head_v8``; a graph with no ``[yolo]`` head skips the
reference's bbox arena and suppresses by union IoU at
``ops.nms.v8_nms_threshold()`` (``FFCNN_V8_NMS_IOU``, read when the Net is
built), as ``ffcnn_tpu/net.py`` does.
"""

from __future__ import annotations

import copy
import os
import threading
import time
import warnings
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from . import profiling, roofline
from .darknet import cfg as cfg_mod
from .darknet import weights as weights_mod
from .darknet.ir import LayerType, NetIR
from .graph.build import (fold_input_transform, forward_features,
                          head_chain_layers, params_from_numpy,
                          stage_layer_set)
from .kernels.block_fused import (block_params, cascade_groups,
                                  check_chain_fits, mega_fits, plan_runs)
from .kernels.conv0_fused import conv0_params
from .kernels.conv_int8 import prepare_conv0
from .kernels.head_fused import check_fits, head_params, plan_head_runs
from .ops.nms import NMSResult, nms, v8_nms_threshold
from .ops.preprocess import letterbox, letterbox_params, letterbox_uint8
from .ops.yolo import apply_arena_cap, arena_capacity, decode_heads
from .quant import QuantPlan, quant_state
from .runtime import (WARMUP_RUNS, Detection, Graph, capture,  # noqa: F401
                      stream_detections, to_detections)
from .runtime import tf32 as _tf32
from .tuning import get_flag

# Demo defaults (ffcnn.c:556-557)
DEFAULT_MEAN = (0.0, 0.0, 0.0)
DEFAULT_NORM = (1 / 255.0, 1 / 255.0, 1 / 255.0)
NMS_THRESHOLD = 0.5          # hardcoded in the reference (ffcnn.c:519)

def float32_layers(ir: NetIR, fast: bool = True) -> Optional[frozenset]:
    """The layers the float32 knobs force, as the flags stand (None where
    neither is set, and in parity mode): ``FFCNN_HEAD_F32=1`` the head
    chains (``head_chain_layers``), ``FFCNN_F32_STAGES`` its stages
    (``stage_layer_set``), the two by union, as JAX's ``_build_pipeline``
    composes them."""
    if not fast:
        return None
    f32set = (head_chain_layers(ir)
              if get_flag("FFCNN_HEAD_F32", "0") == "1" else None)
    stages = get_flag("FFCNN_F32_STAGES", "")
    if stages:
        f32set = frozenset(stage_layer_set(ir, stages) | set(f32set or ()))
    return f32set


def planned_runs(ir: NetIR, fast: bool = True, int8: bool = False):
    """(block runs, head chains) a Net of ``ir`` plans, from the JAX
    package's flags as they stand: none in parity mode (``fast`` False);
    ``FFCNN_FUSED=0`` plans no block run, ``FFCNN_FUSED_HEADS=1`` the head
    chains (never in int8 mode, ``int8``: a plan may make a chain's
    interior blobs int8).  The float32 knobs drop runs as JAX's pipeline
    drops them: ``FFCNN_HEAD_F32=1`` every head chain, ``FFCNN_F32_STAGES``
    every run that overlaps a forced layer."""
    runs = plan_runs(ir) if fast and os.environ.get(
        "FFCNN_FUSED", "1") != "0" else []
    heads = plan_head_runs(ir) if fast and not int8 and os.environ.get(
        "FFCNN_FUSED_HEADS", "0") == "1" else []
    if fast and get_flag("FFCNN_HEAD_F32", "0") == "1":
        heads = []
    if fast and get_flag("FFCNN_F32_STAGES", ""):
        f32set = float32_layers(ir, fast)
        runs, heads = ([r for r in rs
                        if not any(li in f32set
                                   for li in range(r.start, r.end + 1))]
                       for rs in (runs, heads))
    return runs, heads


class _Pipeline:
    """One bucket: the pixels-to-boxes pipeline for one original image size,
    mean/norm and top-k, the counterpart of a program that
    ``ffcnn_tpu/net.py::_build_pipeline`` compiles.  On the CPU a call runs
    it eagerly; on the card each batch size is captured once as a
    ``runtime.Graph`` and replayed."""

    def __init__(self, net: "Net", img_h: int, img_w: int, topk: int,
                 mean, norm):
        self.net, self.h, self.w = net, img_h, img_w
        self.topk, self.mean, self.norm = topk, mean, norm
        ir = net.ir
        net_w, net_h = ir.blobs[0].w, ir.blobs[0].h
        _, _, self.s1, self.s2 = letterbox_params(img_w, img_h, net_w, net_h)
        self.graphs: Dict[int, Graph] = {}

    def run(self, batch: torch.Tensor) -> NMSResult:
        """The eager pipeline: letterbox, forward, decode, arena cap, top-k
        and the keep mask, on ``batch``'s device."""
        net = self.net
        net_w, net_h = net.ir.blobs[0].w, net.ir.blobs[0].h
        feats = net.forward_heads(batch, self.mean, self.norm)
        return net.postprocess(decode_heads(net.ir, feats, net_w, net_h),
                               self.topk, self.s1, self.s2)

    def graph(self, n: int) -> Graph:
        """The graph at batch ``n``, captured at its first use (the caller
        holds the Net's lock).  A capture that fails raises."""
        g = self.graphs.get(n)
        if g is None:
            g = self.graphs[n] = Graph(self.run, n, self.h, self.w,
                                        self.net.device,
                                        self.net._graph_pool)
        return g

    def __call__(self, batch: torch.Tensor) -> NMSResult:
        if batch.device.type != "cuda":
            return self.run(batch)
        net = self.net
        with net._lock:
            g = self.graph(batch.shape[0])
            # the buckets share one graph pool: a replay waits for the
            # last one, whichever stream that ran on
            stream = torch.cuda.current_stream(net.device)
            stream.wait_event(net._replayed)
            res = g.replay(batch)
            net._replayed.record(stream)
        return res


class Net:
    def __init__(self, ir: NetIR, params: Dict, *, mode: str = "fast",
                 topk: int = 128, device="cuda"):
        if mode not in ("fast", "parity", "int8"):
            raise ValueError(f"mode must be 'fast', 'parity' or 'int8', got "
                             f"{mode!r}")
        # int8 mode is fast mode under an int8 plan
        fast = mode in ("fast", "int8")
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
        self._fused_runs, self._head_runs = planned_runs(ir, fast,
                                                         mode == "int8")
        # the float32 knobs (read here; JAX reads them at trace time), whose
        # runs planned_runs has dropped
        self._f32_layers = float32_layers(ir, fast)
        self._has_yolo_heads = any(l.type == LayerType.YOLO
                                   for l in ir.layers)
        self._v8_iou = v8_nms_threshold()
        # how each run launches: groups of up to FFCNN_FUSED_CASCADE blocks
        # (read as JAX's run_blocks_cs reads it), the whole run where
        # FFCNN_FUSED_MEGA is set and the JAX mega gate holds (read from the
        # environment, as JAX's apply_run does), and the boundary storage
        casc = int(get_flag("FFCNN_FUSED_CASCADE", "0"))
        self._fused_groups = {r.start: cascade_groups(r, casc)
                              for r in self._fused_runs}
        # (never in int8 mode: the JAX mega route refuses a plan)
        mega = (os.environ.get("FFCNN_FUSED_MEGA", "0") != "0"
                and mode != "int8")
        self._mega_runs = frozenset(
            r.start for r in self._fused_runs
            if mega and not any(b.down for b in r.blocks)
            and mega_fits(ir, r))
        self._mid_dtype = torch.float32 if get_flag(
            "FFCNN_FUSED_STORE", "input") == "f32" else None
        self._conv0_pallas = fast and get_flag("FFCNN_CONV0_PALLAS",
                                               "0") == "1"
        # conv-1 in int8 (JAX reads the flag at trace, on the folded path)
        self._conv0_int8 = fast and get_flag("FFCNN_CONV0_INT8", "0") == "1"
        # int8 mode's plan, from calibrate() or set_quant_plan()
        self.quant: Optional[QuantPlan] = None
        self._place()

    def _place(self) -> None:
        """What this Net holds on its device, made from ``params`` and the
        resolved flags: every kernel's params, the folded conv-1 of the
        demo default, the buckets, the lock and the graph pool."""
        ir = self.ir
        self._fused_params = {r.start: [block_params(ir, self.params, b)
                                        for b in r.blocks]
                              for r in self._fused_runs}
        self._head_params = {r.start: head_params(ir, self.params, r)
                             for r in self._head_runs}
        if self.device.type == "cuda":
            for hp in self._head_params.values():
                check_fits(hp)
            self._check_chains_fit()
        # (folded params, stem params, conv-1 int8 params) per (mean,
        # norm; _folded_all); the demo
        # default's are made now, with every other kernel's params
        self._folded: Dict[tuple, tuple] = {}
        if self._can_fold_input():
            self._folded_params(DEFAULT_MEAN, DEFAULT_NORM)
        # the buckets, keyed as JAX keys its pipelines (topk at index 3)
        self._pipelines: Dict[tuple, _Pipeline] = {}
        self.timeused: Dict[str, float] = {}
        # One lock serialises making a bucket and each "copy in, replay,
        # clone out": the buckets' graphs share one memory pool, so no two
        # may run at once, and a replay overwrites its graph's outputs.
        self._lock = threading.Lock()
        if self.device.type == "cuda":
            self._graph_pool = torch.cuda.graph_pool_handle()
            self._replayed = torch.cuda.Event()

    def replica(self, device) -> "Net":
        """A Net on ``device`` with this one's IR, params, mode, top-k and
        int8 plan, and its flags as this Net resolved them when it was
        built: one replica of a data-parallel mesh (``parallel/dp.py``).
        Its buckets, graph pool and lock are its own; on this Net's device
        it shares the params' tensors."""
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device='cuda' but CUDA is not available")
        r = copy.copy(self)
        r.device = device
        r.params = {li: {k: v.to(device) for k, v in p.items()}
                    for li, p in self.params.items()}
        r.quant = None
        r._place()
        if self.quant is not None:
            r._install(self.quant.to(device))
        return r

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
             allow_missing_weights: bool = False,
             cache_dir: Optional[str] = None, device="cuda") -> "Net":
        """Parse cfg + weights (a path or the file's bytes).  ``input_w/h``
        override the [net] dims with ALIGN(dim, 32) like net_load
        (ffcnn.c:133-134).  ``cache_dir`` turns on the folded-params cache
        (``darknet/cache.py``), keyed by the cfg+weights content hash.
        ``device``: the card unless the caller asks for ``"cpu"``."""
        ir = cfg_mod.parse_cfg(cfg_path, input_w, input_h)
        if weights is None:
            if not allow_missing_weights:
                raise ValueError("weights required "
                                 "(or pass allow_missing_weights=True)")
            params = weights_mod.zero_weights(ir)
        elif cache_dir is not None:
            from .darknet.cache import load_or_build
            params, _ = load_or_build(ir, cfg_path, weights, cache_dir)
        else:
            params, _ = weights_mod.load_weights(ir, weights)
        return cls(ir, params, mode=mode, topk=topk, device=device)

    def dump(self) -> str:
        """net_dump-compatible layer table (ffcnn.c:522-548)."""
        return cfg_mod.dump(self.ir)

    # ----------------------------------------------------------- observability
    def profile(self, per_type: bool = False, batch=None) -> str:
        """net_profile-style report (ffcnn.c:550): cumulative host wall ms
        per API bucket across detect() calls; ``per_type=True`` adds the
        per-layer-TYPE table of a short profiled burst
        (:meth:`profile_layers`)."""
        lines = [f"{k:>12s}: {v * 1000:8.1f} ms" for k, v in
                 self.timeused.items()]
        out = "\n".join(lines) + ("\n" if lines else "")
        if per_type:
            out += self.profile_layers(batch=batch).render(per_layer=False)
        return out

    def roofline_costs(self, batch_size: int):
        """Static per-layer bytes/FLOP costs (``roofline.py``) of this Net's
        plan at ``batch_size``: its block runs and head chains (the port
        runs them at every batch; the float32 knobs' drops already made)
        and its run boundary storage."""
        runs = list(self._fused_runs) + list(self._head_runs)
        return roofline.layer_costs(
            self.ir, batch_size,
            dtype="f32" if self.mode == "parity" else "bf16",
            fused_runs=runs or None, quant=self.quant,
            store_dtype="f32" if self._mid_dtype == torch.float32 else None)

    def profile_layers(self, batch=None, iters: int = 10):
        """Per-layer profile (``profiling.py``) of ``iters`` runs of the
        eager pipeline on ``batch`` (default 8 blank frames at the net's
        size), with the roofline floors attached (a fused region's row gets
        the region's floor).  A CUDA graph's replay runs no Python, so no
        layer range encloses its kernels: the eager pipeline
        (``_Pipeline.run``) is profiled, and on the card the report also
        carries the bucket's replay device time on the same batch."""
        if batch is None:
            net_w, net_h = self.ir.blobs[0].w, self.ir.blobs[0].h
            batch = np.zeros((8, net_h, net_w, 3), np.uint8)
        if not isinstance(batch, torch.Tensor):
            batch = torch.from_numpy(np.ascontiguousarray(batch))
        if self.mode == "int8" and self.quant is None:
            # the eager pipeline does not pass detect_device's
            # self-calibration: calibrate here, on the same frames
            self.calibrate(batch[:8].cpu().numpy())
        batch = batch.to(self.device)
        n, h, w, _ = batch.shape
        pipe = self._pipeline_for(h, w, DEFAULT_MEAN, DEFAULT_NORM)
        runs = [(r.start, r.end)
                for r in list(self._fused_runs) + list(self._head_runs)]
        pipe.run(batch)                      # warm: libraries, workspaces
        rep = profiling.profile_layers(lambda: pipe.run(batch), self.ir,
                                       iters, runs=runs or None,
                                       device=self.device)
        if self.device.type == "cuda":
            self.detect_device(batch)        # capture outside the trace
            torch.cuda.synchronize(self.device)
            rep.replay_us = 1e3 * profiling.device_op_time_ms(
                lambda: self.detect_device(batch), iters)
        costs = self.roofline_costs(n)
        rep.floors_us = {c.index: c.floor_us() for c in costs}
        for s, e in runs:
            rep.floors_us[s] = roofline.region_floor_us(costs, s, e)
        return rep

    # ------------------------------------------------------------- pipeline
    def _can_fold_input(self) -> bool:
        first = self.ir.layers[0]
        return (self.mode in ("fast", "int8")
                and first.type == LayerType.CONV and first.groups == 1)

    # ------------------------------------------------------------- int8 mode
    def calibrate(self, images, mean=None, norm=None,
                  min_channels: int = 32,
                  percentile: Optional[float] = None) -> None:
        """int8 mode: collect each blob's range from ``images`` (uint8 BGR,
        (N, H, W, 3) at any letterboxable size) in a float32 forward on the
        Net's device and install the plan they give (``quant.calibrate``),
        as ``ffcnn_tpu/net.py::Net.calibrate`` does: ``FFCNN_INT8_MINC``
        overrides ``min_channels``, ``FFCNN_INT8_PERCH=1`` makes the plan
        per-channel, ``FFCNN_INT8_PCT`` clips the ranges to a percentile
        (per-tensor plans only; an explicit ``percentile`` with
        ``FFCNN_INT8_PERCH=1`` raises).  Drops every bucket."""
        if self.mode != "int8":
            raise ValueError("calibrate() applies to mode='int8'")
        from .quant import calibrate as _calib
        min_channels = int(get_flag("FFCNN_INT8_MINC", str(min_channels)))
        per_channel = get_flag("FFCNN_INT8_PERCH", "0") == "1"
        if per_channel and percentile is not None:
            raise ValueError("percentile clip is per-tensor only "
                             "(incompatible with FFCNN_INT8_PERCH=1)")
        if percentile is None and not per_channel:
            pct = get_flag("FFCNN_INT8_PCT", "")
            percentile = float(pct) if pct else None
        with torch.no_grad():
            plan = _calib(self.ir, self.params, images,
                          mean=tuple(mean or DEFAULT_MEAN),
                          norm=tuple(norm or DEFAULT_NORM),
                          min_channels=min_channels, percentile=percentile,
                          per_channel=per_channel, device=self.device)
        self._install(plan)

    def set_quant_plan(self, plan: QuantPlan) -> None:
        """Install a saved plan (``quant.load_plan``), its tensors moved to
        the Net's device once, here.  Drops every bucket."""
        if self.mode != "int8":
            raise ValueError("set_quant_plan() applies to mode='int8'")
        self._install(plan.to(self.device))

    def _install(self, plan: QuantPlan) -> None:
        # the plan's constants at the Net's dtype, made now: no forward (and
        # no graph's capture) makes one
        quant_state(plan, self.ir, self._dtype, self.device)
        with self._lock:
            self.quant = plan
            self._pipelines.clear()

    def _folded_params(self, mean, norm):
        """Conv-1 with the input transform folded in and the stem kernel's
        params made from it (None without ``FFCNN_CONV0_PALLAS``), cached
        per (mean, norm) with conv-1's int8 params (``_folded_all``): a
        forward (and a graph's capture) computes none of them."""
        return self._folded_all(mean, norm)[:2]

    def _folded_all(self, mean, norm):
        """(folded params, stem params, conv-1's uint8-mode ``Int8Conv`` at
        the net's input geometry, None without ``FFCNN_CONV0_INT8``)."""
        key = (mean, norm)
        if key not in self._folded:
            params = fold_input_transform(self.ir, self.params, mean, norm)
            l0, b0 = self.ir.layers[0], self.ir.blobs[0]
            c0 = conv0_params(self.ir, params) if (
                self._conv0_pallas and 1 in self._fused_params
                and (l0.fs, l0.stride, l0.pad) == (3, 2, 1)) else None
            c0q = prepare_conv0(
                params[0]["weights"].permute(2, 3, 1, 0), params[0]["scale"],
                params[0]["bias"], h=b0.h, w=b0.w, stride=l0.stride,
                pad=l0.pad, act=l0.activation) if self._conv0_int8 else None
            self._folded[key] = (params, c0, c0q)
        return self._folded[key]

    def _max_candidates(self) -> int:
        """Most head candidates the model can emit at its input size: the
        head grids' total (3 anchors a cell for ``[yolo]``, 1 for
        ``[yolov8]``), clamped by the reference's bbox arena (ffcnn.c:243)
        only where the graph has a ``[yolo]`` head, as
        ``ffcnn_tpu/net.py::_max_candidates``."""
        total = sum(self.ir.blobs[li].w * self.ir.blobs[li].h
                    * (3 if l.type == LayerType.YOLO else 1)
                    for li, l in enumerate(self.ir.layers)
                    if l.type in (LayerType.YOLO, LayerType.YOLOV8))
        if not self._has_yolo_heads:
            return total
        b0 = self.ir.blobs[0]
        return min(total, arena_capacity(b0.w, b0.h, b0.c))

    def postprocess(self, decoded, topk: int, scale1: int = 1,
                    scale2: int = 1) -> NMSResult:
        """The pipeline's tail on decoded candidates (``decode_heads``): the
        bbox arena and min IoU at NMS_THRESHOLD where the graph has a
        ``[yolo]`` head (the arena is a quirk of the reference's graphs,
        ffcnn.c:242-244), else union IoU at ``v8_nms_threshold()``; then
        top-k and the keep mask (K2 on the card), boxes rescaled by
        ``scale1 / scale2``."""
        if self._has_yolo_heads:
            b0 = self.ir.blobs[0]
            decoded = apply_arena_cap(decoded,
                                      arena_capacity(b0.w, b0.h, b0.c))
            threshold, kind = NMS_THRESHOLD, "min"
        else:
            threshold, kind = self._v8_iou, "union"
        return nms(decoded.boxes, decoded.scores, decoded.classes, k=topk,
                   threshold=threshold, scale1=scale1, scale2=scale2,
                   iou_kind=kind)

    def forward_heads(self, batch: torch.Tensor, mean=DEFAULT_MEAN,
                      norm=DEFAULT_NORM) -> List[torch.Tensor]:
        """uint8 (N, H, W, 3) BGR on the net's device -> the raw yolo head
        maps, after the same letterbox and forward that detect runs."""
        ir = self.ir
        net_w, net_h = ir.blobs[0].w, ir.blobs[0].h
        mean = tuple(float(v) for v in np.asarray(mean).reshape(3))
        norm = tuple(float(v) for v in np.asarray(norm).reshape(3))
        with _tf32(self.mode != "parity"):
            if self._can_fold_input() and mean == DEFAULT_MEAN:
                params, c0, c0q = self._folded_all(mean, norm)
                x = letterbox_uint8(batch, net_w, net_h)
            else:
                params, c0, c0q = self.params, None, None
                x = letterbox(batch, net_w, net_h, mean, norm,
                              dtype=self._dtype)
            return forward_features(ir, params, x, input_dtype=self._dtype,
                                    quant=self.quant,
                                    fused_runs=self._fused_runs,
                                    fused_params=self._fused_params,
                                    fused_groups=self._fused_groups,
                                    mega_runs=self._mega_runs,
                                    fused_mid_dtype=self._mid_dtype,
                                    head_runs=self._head_runs,
                                    head_params=self._head_params,
                                    conv0_pallas=c0 is not None,
                                    conv0_params=c0, conv0_int8=c0q,
                                    f32_layers=self._f32_layers)

    def _pipeline_for(self, img_h: int, img_w: int, mean, norm,
                      topk: Optional[int] = None) -> _Pipeline:
        """The bucket for one image size, mean/norm and top-k, made at its
        first use (``ffcnn_tpu/net.py::_pipeline_for``).  JAX's key ends
        with the flags it reads at trace; a Net fixes its flags when it is
        built, so the key leaves them out (topk stays at index 3)."""
        mean_t = tuple(float(v) for v in np.asarray(mean).reshape(3))
        norm_t = tuple(float(v) for v in np.asarray(norm).reshape(3))
        folded = self._can_fold_input() and mean_t == DEFAULT_MEAN
        key = (img_h, img_w, folded, topk or self.topk, mean_t, norm_t)
        with self._lock:
            pipe = self._pipelines.get(key)
            if pipe is None:
                pipe = self._pipelines[key] = _Pipeline(
                    self, img_h, img_w, key[3], mean_t, norm_t)
        return pipe

    def detect_device(self, batch, mean=DEFAULT_MEAN, norm=DEFAULT_NORM,
                      topk: Optional[int] = None) -> NMSResult:
        """Device-level entry: uint8 (N, H, W, 3) BGR (numpy or a tensor) ->
        NMSResult tensors on the net's device.  ``topk`` overrides the net
        default for this call (a new value makes a new bucket).

        On the card: a host batch goes up through pinned memory without
        waiting, and the bucket's graph replays; the call waits for the
        device nowhere (a batch's first call at a new size captures its
        graph, which synchronises)."""
        if self.mode == "int8" and self.quant is None:
            # self-calibration on the first frames (call calibrate() with a
            # representative set for production), as the JAX Net does
            frames = batch[:8]
            if isinstance(frames, torch.Tensor):
                frames = frames.cpu().numpy()
            self.calibrate(np.asarray(frames),
                           mean=tuple(np.asarray(mean).tolist()),
                           norm=tuple(np.asarray(norm).tolist()))
        if isinstance(batch, torch.Tensor):
            batch = batch.to(self.device)
        else:
            batch = torch.from_numpy(np.ascontiguousarray(batch))
            if self.device.type == "cuda":
                batch = batch.pin_memory().to(self.device, non_blocking=True)
        n, h, w, _ = batch.shape
        pipe = self._pipeline_for(h, w, mean, norm, topk)
        t0 = time.perf_counter()
        res = pipe(batch)
        self.timeused["detect"] = self.timeused.get("detect", 0.0) + (
            time.perf_counter() - t0)
        return res

    def warmup(self, image_sizes=None, batch_sizes=(1,),
               topk_ladder: bool = False) -> None:
        """Build the buckets for the given (H, W) image sizes and batch
        sizes ahead of traffic (on the card: capture their graphs), as
        ``ffcnn_tpu/net.py::Net.warmup`` compiles them.  Defaults to the
        model's own input size.  ``topk_ladder=True`` also builds every K
        bucket parity mode's saturation retry can reach (topk * 4^i up to
        the model's candidate count).  An int8 Net needs its plan first:
        calibrating on the zero probe frames would give useless scales."""
        if self.mode == "int8" and self.quant is None:
            raise RuntimeError(
                "int8 mode: call calibrate(images) with representative "
                "frames (or set_quant_plan) before warmup()")
        net_w, net_h = self.ir.blobs[0].w, self.ir.blobs[0].h
        max_k = self._max_candidates()
        ks = [None]
        if topk_ladder:
            k = min(self.topk, max_k)
            while k < max_k:
                k = min(max_k, k * 4)
                ks.append(k)
        for (h, w) in (image_sizes or [(net_h, net_w)]):
            for n in batch_sizes:
                for k in ks:
                    self.detect_device(np.zeros((n, h, w, 3), np.uint8),
                                       topk=k)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def memory_stats(self, batch_size: int = 1, image_size=None,
                     mean=None, norm=None) -> Dict[str, int]:
        """Device memory of one bucket, in bytes, with the keys of
        ``ffcnn_tpu/net.py::Net.memory_stats``: ``args`` (the static input),
        ``output`` (the result), ``temp`` (the most the graph's other
        tensors hold at once), ``code`` (0: a graph holds no code of its
        own; the kernels' libraries are shared by every bucket) and
        ``peak`` (the static input, the graph's high-water mark and what
        one replay allocates).  Builds the bucket if needed, then reads the
        CUDA allocator's peak statistic around a second capture of the
        bucket's pipeline (into the Net's pool, never replayed) and around
        one replay.  It resets that process-wide statistic to do so; no
        other entry point of the package touches it.  A CPU Net raises."""
        if self.device.type != "cuda":
            raise RuntimeError("memory_stats reads the CUDA allocator; this "
                               "Net runs on the CPU")
        net_w, net_h = self.ir.blobs[0].w, self.ir.blobs[0].h
        img_h, img_w = image_size or (net_h, net_w)
        pipe = self._pipeline_for(
            img_h, img_w, mean if mean is not None else DEFAULT_MEAN,
            norm if norm is not None else DEFAULT_NORM)
        batch = torch.zeros((batch_size, img_h, img_w, 3), dtype=torch.uint8,
                            device=self.device)
        dev = self.device
        with self._lock:
            g = pipe.graph(batch_size)
            torch.cuda.synchronize(dev)
            base = torch.cuda.memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            out = capture(torch.cuda.CUDAGraph(), pipe.run, g.input,
                           self._graph_pool)
            held = torch.cuda.max_memory_allocated(dev) - base
            del out
        torch.cuda.synchronize(dev)
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        res = pipe(batch)
        torch.cuda.synchronize(dev)
        replay = torch.cuda.max_memory_allocated(dev) - base
        output = sum(t.numel() * t.element_size() for t in res)
        args = g.input.numel()
        return {"args": args, "temp": held - output, "output": output,
                "code": 0, "peak": args + held + replay}

    def forward_raw(self, x) -> List[torch.Tensor]:
        """Raw yolo head maps for a preprocessed (N, H, W, C) net input, in
        the net's dtype, with no fused run (``ffcnn_tpu/net.py::
        forward_raw``): the net_forward equivalent without postprocess."""
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(np.asarray(x))
        with _tf32(self.mode != "parity"):
            return forward_features(self.ir, self.params,
                                    x.to(self.device, self._dtype))

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

    def detect_async(self, batch, mean=DEFAULT_MEAN, norm=DEFAULT_NORM):
        """Start one uint8 (N, H, W, 3) batch without waiting for it and
        return a zero-argument callable that gives its
        ``List[List[Detection]]``.  The upload and the replay run while the
        caller does other work; the serving micro-batcher overlaps its
        rounds with it."""
        res = self.detect_device(batch, mean, norm)
        return lambda: self._finish(res, batch, mean, norm)

    def detect_stream(self, batches, mean=DEFAULT_MEAN, norm=DEFAULT_NORM,
                      depth: int = 2):
        """Pipelined detection over an iterable of uint8 (N, H, W, 3)
        batches: up to ``depth`` batches in flight, one
        ``List[List[Detection]]`` yielded per batch, in order.  Batch i+1 is
        uploaded and started before batch i's results are read, so the
        copies and the host's decode ride under device compute.  Dense
        scenes as in ``detect``: parity mode grows K, fast mode warns."""
        return stream_detections(
            lambda b: self.detect_async(b, mean, norm), batches, depth)

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

    _to_detections = staticmethod(to_detections)

    # ----------------------------------------------------------------- export
    def export(self, path: str, *, batch_size: int = 1, image_size=None,
               mean=None, norm=None, platforms=None) -> int:
        """Write this Net's whole pixels-to-boxes pipeline for one (batch,
        H, W) bucket as a self-contained ``torch.export`` artifact (weights
        baked in as constants) with its ``.meta.json`` sidecar, as
        ``ffcnn_tpu/net.py::Net.export`` does: a program for each of
        ``platforms`` (``"cuda"``, ``"cpu"``; default this Net's device);
        load it with ``export.load_exported`` or ``export.ArtifactNet``.
        Returns the bytes written."""
        from .export import export_net
        return export_net(self, path, batch_size=batch_size,
                          image_size=image_size, mean=mean, norm=norm,
                          platforms=platforms)


def load(cfg_path: str, weights=None, *, input_w: int = 0, input_h: int = 0,
         mode: str = "fast", device="cuda", **kw) -> Net:
    """Module-level convenience mirroring ``net_load`` (ffcnn.h:48); on the
    card unless ``device="cpu"``."""
    return Net.load(cfg_path, weights, input_w, input_h, mode=mode,
                    device=device, **kw)
