"""Batched detection over a device mesh, the port of
``ffcnn_tpu/parallel/dp.py``.

Two pipelines, as in JAX:

* ``build_dp_pipeline`` / ``DPNet`` (pure data parallelism): one ``Net``
  replica a slot of the mesh's ``data`` axis, each with the Net's IR,
  params, mode, flags and int8 plan.  A batch is split evenly; each shard
  goes through its replica's bucket (``net.py::_Pipeline``: a CUDA graph a
  batch size on the card) on the replica's own stream, so the per-shard
  program is the single-card program with every kernel it runs; the
  results are gathered to the first data slot in batch order.  No
  exchange between replicas: inference has no cross-image op.
* ``build_sharded_pipeline``: the plain forward (no fused runs, as JAX
  traces it under GSPMD) with the partitioning made explicit.  ``data``
  splits the batch.  ``spatial`` splits every blob's rows into even
  contiguous blocks (``activation_sharding``) (a block of ceil(H / spatial) rows a slot, the last
  ones short or empty); before each layer a slot gathers, from whichever
  slots own them, the input rows its output rows need -- for a window of
  size k, stride s and padding p, rows ``[o0 s - p, (o1 - 1) s - p + k)``,
  aligned down to a multiple of s -- runs the layer on them through
  ``graph.build.forward_features`` (one layer a segment) and keeps its
  own rows of the output; the layer pads where the rows end at the image
  edge.  1x1 convs, route, shortcut and dropout read their own rows,
  upsample maps them by its stride, and the head maps are gathered whole
  before the decode.  ``model`` (``shard_filters=True``) gives each
  model slot a sharded conv's slice of the output channels (its input's
  matching slice where the conv is grouped); the slices are concatenated
  where a later layer reads whole channels.  ``place_params.report``
  records which convs were sharded and which stayed replicated, by JAX's
  rule.

A mesh of CUDA devices runs on the card or raises; a mesh that mixes the
CPU and the card is refused.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import warnings
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..darknet.ir import LayerType, NetIR
from ..graph.build import forward_features
from ..net import DEFAULT_MEAN, DEFAULT_NORM, NMS_THRESHOLD
from ..ops.nms import NMSResult, nms, v8_nms_threshold
from ..ops.preprocess import letterbox, letterbox_params
from ..ops.yolo import apply_arena_cap, arena_capacity, decode_heads
from ..quant import QuantPlan
from ..runtime import stream_detections, tf32, to_detections
from .mesh import (DATA_AXIS, MODEL_AXIS, SPATIAL_AXIS, Mesh, Sharding,
                   _device, activation_sharding, batch_sharding, make_mesh,
                   replicated)
from .multiprocess import LocalBatch, LocalResult


# ---------------------------------------------------------------- helpers
def _mesh_devices(mesh: Mesh) -> List[torch.device]:
    """The mesh's devices, all CUDA or all CPU (a mixed mesh raises)."""
    kinds = {d.type for d in mesh.devices.flat}
    if len(kinds) != 1:
        raise ValueError(f"a mesh mixes device types {sorted(kinds)}")
    return list(mesh.devices.flat)


def _stream(device: torch.device):
    """A stream of its own on a card; None on the CPU."""
    return torch.cuda.Stream(device) if device.type == "cuda" else None


@contextlib.contextmanager
def _on(stream):
    """Make ``stream`` current on its device for the block (no-op for
    None, the CPU)."""
    if stream is None:
        yield
    else:
        with torch.cuda.stream(stream):
            yield


def _move(t: torch.Tensor, dst: torch.device, src_stream, dst_stream):
    """``t``, written on ``src_stream``, readable on ``dst_stream`` of
    ``dst``: on the same card ``dst_stream`` waits for ``src_stream`` and
    the allocator keeps ``t`` until ``dst_stream`` has read it; across
    cards the copy runs with both streams current, so it follows the
    writer and precedes the reader."""
    if t.device == dst:
        if dst_stream is not None and src_stream is not dst_stream:
            if src_stream is not None:
                dst_stream.wait_stream(src_stream)
            t.record_stream(dst_stream)
        return t
    with _on(src_stream), _on(dst_stream):
        return t.to(dst, non_blocking=True)


def _gather(outs: List[NMSResult], streams, dst: torch.device) -> NMSResult:
    """The slots' results concatenated in order on ``dst``, readable on its
    current stream."""
    cur = torch.cuda.current_stream(dst) if dst.type == "cuda" else None
    parts = [[_move(t, dst, s, cur) for t in out]
             for out, s in zip(outs, streams)]
    return NMSResult(*(torch.cat(f) for f in zip(*parts)))


def _as_batch(images) -> torch.Tensor:
    if isinstance(images, torch.Tensor):
        return images
    return torch.from_numpy(np.ascontiguousarray(images))


def _channels(v) -> Tuple[float, float, float]:
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().numpy()
    return tuple(float(x) for x in np.asarray(v, np.float64).reshape(3))


def _heads(ir: NetIR):
    return [l for l in ir.layers
            if l.type in (LayerType.YOLO, LayerType.YOLOV8)]


def _threshold(ir: NetIR, nms_threshold: Optional[float]) -> float:
    """The net.py policy: 0.5 (min IoU) for graphs with a ``[yolo]``
    head, ``FFCNN_V8_NMS_IOU`` (union) for pure-v8 graphs."""
    if nms_threshold is not None:
        return nms_threshold
    return NMS_THRESHOLD if any(l.type == LayerType.YOLO for l in _heads(ir)) \
        else v8_nms_threshold()


def _tail(ir: NetIR, feats, topk: int, threshold: float, s1: int,
          s2: int) -> NMSResult:
    """Decode (in float32), the arena cap and min IoU for ``[yolo]``
    graphs (union IoU for pure-v8 ones), top-k and the keep mask (K2 on
    the card), as JAX's sharded and pipelined programs end."""
    net_w, net_h = ir.blobs[0].w, ir.blobs[0].h
    d = decode_heads(ir, [f.float() for f in feats], net_w, net_h)
    if any(l.type == LayerType.YOLO for l in _heads(ir)):
        d = apply_arena_cap(d, arena_capacity(net_w, net_h, ir.blobs[0].c))
        kind = "min"
    else:
        kind = "union"
    return nms(d.boxes, d.scores, d.classes, k=topk, threshold=threshold,
               scale1=s1, scale2=s2, iou_kind=kind)


def _tf32_allowed(dtype: torch.dtype, precision) -> bool:
    """TF32 for the convs: off for float32 (parity's ``Precision.HIGHEST``)
    unless ``precision`` says otherwise; on for bfloat16, whose values it
    holds exactly."""
    if precision is None:
        return dtype != torch.float32
    return str(precision).lower() not in ("highest", "float32",
                                          "precision.highest")


def _local(run):
    """``run`` that also takes a ``multiprocess.LocalBatch``: it runs on
    the batch's images and returns a ``LocalResult`` with its offset."""
    def call(images):
        if isinstance(images, LocalBatch):
            return LocalResult(images.start, run(images.images))
        return run(images)
    return call


# ------------------------------------------------------------ pure DP
def _check_pure_dp(mesh: Mesh) -> None:
    for axis in (MODEL_AXIS, SPATIAL_AXIS):
        if mesh.axis_size(axis) > 1:
            raise ValueError(
                f"build_dp_pipeline is pure-DP; mesh has {axis}="
                f"{mesh.shape[axis]} — use build_sharded_pipeline")


def dp_replicas(net, mesh: Mesh) -> list:
    """One ``Net`` a slot of the mesh's data axis: the Net itself at the
    first slot where it runs on that slot's device, a ``Net.replica``
    everywhere else (a device that fills several slots gets one replica a
    slot).  An int8 Net needs its plan first."""
    _check_pure_dp(mesh)
    _mesh_devices(mesh)
    if net.mode == "int8" and net.quant is None:
        raise ValueError("int8 mode: calibrate() or set_quant_plan() before "
                         "building its data-parallel replicas")
    nd = mesh.shape[DATA_AXIS]
    devices = list(mesh.devices.reshape(nd, -1)[:, 0])
    own = _device(net.device)
    return [net if i == 0 and d == own else net.replica(d)
            for i, d in enumerate(devices)]


class _DPPipeline:
    """``(uint8 (N, img_h, img_w, 3) batch) -> NMSResult`` over the
    replicas: N a multiple of their count, each shard (``split``, the
    batch sharding) through its replica's bucket on the replica's own
    stream, gathered in batch order on the first replica's device."""

    def __init__(self, replicas, streams, split, img_h, img_w, mean, norm,
                 topk):
        self.replicas, self.streams, self.split = replicas, streams, split
        self.h, self.w = img_h, img_w
        self.mean, self.norm, self.topk = mean, norm, topk

    def __call__(self, images) -> NMSResult:
        batch = _as_batch(images)
        n, nd = batch.shape[0], len(self.replicas)
        if tuple(batch.shape[1:]) != (self.h, self.w, 3):
            raise ValueError(f"this pipeline takes (N, {self.h}, {self.w}, "
                             f"3) batches, got {tuple(batch.shape)}")
        if n % nd:
            raise ValueError(f"batch {n} is not a multiple of the mesh's "
                             f"data axis {nd}")
        dev0 = _device(self.replicas[0].device)
        if dev0.type == "cuda" and batch.device.type == "cpu":
            batch = batch.pin_memory()
        outs = []
        for i, (rep, stream) in enumerate(zip(self.replicas, self.streams)):
            lo, hi = self.split.block(0, n, i)
            shard = batch[lo:hi]
            with _on(stream):
                if stream is not None:
                    if shard.device.type == "cuda":
                        # after whatever the caller queued on the batch,
                        # which the allocator keeps until this stream read it
                        stream.wait_stream(
                            torch.cuda.current_stream(shard.device))
                        shard.record_stream(stream)
                    shard = shard.to(rep.device, non_blocking=True)
                pipe = rep._pipeline_for(self.h, self.w, self.mean,
                                         self.norm, self.topk)
                outs.append(pipe(shard))
        return _gather(outs, self.streams, dev0)


def build_dp_pipeline(net, mesh: Mesh, img_h: int, img_w: int, *,
                      mean=None, norm=None, topk=None, replicas=None):
    """Pure data parallelism: the Net's own single-card pipeline (its
    fused kernels, int8 plan and folded preprocess; on the card its CUDA
    graphs) on every slot of the mesh's data axis, as JAX's
    ``build_dp_pipeline`` runs it under ``shard_map``.  ``replicas``: the
    Nets to run (``dp_replicas``; made here when not given).

    Returns ``(uint8 batch) -> NMSResult`` (a ``multiprocess.LocalBatch``
    gives a ``LocalResult``); the batch must be a multiple of the data
    axis.  A mesh with ``model`` or ``spatial`` > 1 raises, as in JAX."""
    _check_pure_dp(mesh)
    if replicas is None:
        replicas = dp_replicas(net, mesh)
    streams = [_stream(_device(r.device)) for r in replicas]
    return _local(_DPPipeline(
        replicas, streams, batch_sharding(mesh), img_h, img_w,
        mean if mean is not None else DEFAULT_MEAN,
        norm if norm is not None else DEFAULT_NORM, topk))


class DPNet:
    """A Net-shaped front over a pure-DP mesh: ``detect(batch)`` pads the
    batch to a multiple of the data axis with zero images and runs one
    ``build_dp_pipeline`` program over every replica.  Drop-in for
    ``serve.DetectorService`` (``serve --dp``): one HTTP worker drives
    every slot.  ``mesh`` defaults to every visible card."""

    def __init__(self, net, mesh: Optional[Mesh] = None):
        self.net = net
        self.ir = net.ir                  # serving probe-size discovery
        self.mesh = mesh if mesh is not None else make_mesh()
        _check_pure_dp(self.mesh)
        self.ndata = self.mesh.shape[DATA_AXIS]
        self._fns: Dict[tuple, object] = {}
        self._replicas = None
        self._plan: Optional[QuantPlan] = None

    @property
    def replicas(self) -> list:
        """The replicas, made at the first use and again after the Net's
        int8 plan changed."""
        if self._replicas is None or self.net.quant is not self._plan:
            self._replicas = dp_replicas(self.net, self.mesh)
            self._plan = self.net.quant
            self._fns.clear()
        return self._replicas

    def _fn(self, img_h: int, img_w: int, topk=None):
        reps = self.replicas
        key = (img_h, img_w, topk)
        fn = self._fns.get(key)
        if fn is None:
            fn = self._fns[key] = build_dp_pipeline(
                self.net, self.mesh, img_h, img_w, topk=topk, replicas=reps)
        return fn

    def detect(self, images):
        batch = np.asarray(images)
        single = batch.ndim == 3
        out = self.detect_async(batch[None] if single else batch)()
        return out[0] if single else out

    def detect_async(self, images):
        """Start one (N, H, W, 3) uint8 batch over the mesh without waiting;
        returns a zero-argument callable that gives its Detection lists
        (the serving micro-batcher overlaps rounds through it, as through
        ``Net.detect_async``)."""
        batch = np.asarray(images)
        if batch.ndim != 4 or batch.shape[-1] != 3:
            raise ValueError(f"expected (N, H, W, 3) uint8, got "
                             f"{batch.shape}")
        n, h, w, _ = batch.shape
        m = -(-n // self.ndata) * self.ndata
        if m != n:
            batch = np.concatenate(
                [batch, np.zeros((m - n,) + batch.shape[1:], batch.dtype)])
        res = self._fn(h, w)(batch)

        def finish():
            # Net._finish's policy: parity grows K and re-dispatches until
            # the census fits; fast and int8 warn once
            out = res
            max_k = self.net._max_candidates()
            k = min(self.net.topk, max_k)
            while bool(out.saturated[:n].any()) and k < max_k:
                k = min(max_k, k * 4)
                if self.net.mode != "parity":
                    warnings.warn(
                        "NMS top-k saturated: some candidates were dropped "
                        "pre-suppression; raise the net's topk for crowded "
                        "scenes.", RuntimeWarning, stacklevel=2)
                    break
                out = self._fn(h, w, topk=k)(batch)
            return to_detections(NMSResult(*(t[:n] for t in out)))
        return finish

    def detect_stream(self, batches, depth: int = 2):
        """Pipelined detection over an iterable of uint8 (N, H, W, 3)
        batches across the mesh, up to ``depth`` in flight
        (``Net.detect_stream``'s semantics)."""
        return stream_detections(self.detect_async, batches, depth)

    def warmup(self, image_sizes=None, batch_sizes=None,
               topk_ladder: bool = False) -> None:
        """Build every replica's buckets for the given sizes (on the card:
        capture their graphs); ``topk_ladder=True`` also builds every K the
        parity retry can reach, as ``Net.warmup``."""
        net_w, net_h = self.net.ir.blobs[0].w, self.net.ir.blobs[0].h
        ks = [None]
        if topk_ladder:
            mx = self.net._max_candidates()
            k = min(self.net.topk, mx)
            while k < mx:
                k = min(mx, k * 4)
                ks.append(k)
        for (h, w) in (image_sizes or [(net_h, net_w)]):
            for nb in (batch_sizes or [self.ndata]):
                m = max(-(-nb // self.ndata) * self.ndata, self.ndata)
                for k in ks:
                    self._fn(h, w, topk=k)(np.zeros((m, h, w, 3), np.uint8))
        for d in {_device(r.device) for r in self.replicas}:
            if d.type == "cuda":
                torch.cuda.synchronize(d)

    def dump(self) -> str:
        return (self.net.dump()
                + f"dp mesh: {dict(self.mesh.shape)} "
                f"({self.ndata}-way data parallel)\n")


# ------------------------------------------------- the sharded forward
class _Piece(NamedTuple):
    """A slot's part of a blob: rows [r0, r1), channels [c0, c1); ``t`` is
    None where the slot owns no rows."""
    t: Optional[torch.Tensor]
    r0: int
    r1: int
    c0: int
    c1: int


def _window_rows(k: int, s: int, p: int, o0: int, o1: int, h_in: int,
                 cover: int = 0) -> Tuple[int, int, int]:
    """(a, b, off): the input rows [a, b) a window of size ``k``, stride
    ``s`` and low padding ``p`` reads for output rows [o0, o1), ``a`` a
    multiple of ``s`` with ceil(p / s) spare outputs above o0 (so no kept
    output reads the segment's own padding), clipped to the image; output
    row o is row o - off of the layer run on those rows.  ``cover``: rows
    the input must reach at least (a pool's own output count)."""
    off = max(0, o0 - -(-p // s))
    return off * s, min(h_in, max(cover, (o1 - 1) * s - p + k)), off


@dataclasses.dataclass
class _Conv:
    """A sharded conv's per-model-slot view: its output channels, the
    input channels it reads, and the IR and plan that compute them through
    ``forward_features`` (on the slot's params, ``place_params``)."""
    c_out: Tuple[int, int]
    c_in: Tuple[int, int]
    ir: NetIR
    quant: Optional[QuantPlan]
    whole: bool = False        # computes every channel, keeps its slice


def _slice_plan(plan: QuantPlan, li: int, c_in, c_out) -> QuantPlan:
    """The part of ``plan`` a one-layer segment of conv ``li`` on output
    channels ``c_out`` (input channels ``c_in``) reads."""
    def cut(v, c):
        return np.asarray(v, np.float32)[c[0]:c[1]] if np.ndim(v) else v
    scales = {}
    for bi, c in ((li, c_in), (li + 1, c_out)):
        if bi in plan.blob_scale:
            scales[bi] = cut(plan.blob_scale[bi], c)
    weights = {}
    if li in plan.weights:
        q = plan.weights[li]
        weights[li] = dict(q, wq=q["wq"][..., c_out[0]:c_out[1]],
                           wscale=q["wscale"][c_out[0]:c_out[1]],
                           bias=q["bias"][c_out[0]:c_out[1]])
    return QuantPlan(scales, weights, plan.min_channels, plan.per_channel)


def build_sharded_pipeline(ir: NetIR, mesh: Mesh, img_h: int, img_w: int, *,
                           dtype=torch.bfloat16, precision=None,
                           topk: int = 128, nms_threshold: float = None,
                           shard_filters: bool = False, quant=None):
    """``(fn, place_params)``: ``fn(placed, uint8 batch, mean, norm) ->
    NMSResult`` over the mesh (module docstring), the batch a multiple of
    the data axis (a ``multiprocess.LocalBatch`` gives a ``LocalResult``),
    the result gathered in batch order on the mesh's first device;
    ``place_params(params)`` places the Net-layout params
    (``graph.build.params_from_numpy``) on every slot, each sharded conv
    cut to its slot's slice, and records ``place_params.report`` =
    ``{"sharded": [(layer, filters)], "replicated": [(layer, filters)]}``
    with ``shard_filters``: JAX's decision, conv by conv -- replicated
    where the filters are not a multiple of the model axis, or where a
    windowed dense conv meets a spatial axis > 1 (JAX's fallback for a
    GSPMD fault; the port keeps the decision so the reports compare).

    The forward is the plain one (no fused run), ``dtype`` bfloat16 or
    float32 (TF32 off for float32 unless ``precision`` says otherwise);
    ``quant``: an int8 plan, run as ``forward_features`` runs it (its
    int8 convs through the int8 conv kernel on the card).  ``topk`` and
    the NMS threshold policy as in JAX."""
    devices = _mesh_devices(mesh)
    if mesh.axis_size("pipe") > 1:
        raise ValueError("build_sharded_pipeline takes a (data, spatial, "
                         "model) mesh; pipe stages go to build_pp_pipeline")
    nd = mesh.shape[DATA_AXIS]
    ns, nm = mesh.axis_size(SPATIAL_AXIS), mesh.axis_size(MODEL_AXIS)
    grid = mesh.devices.reshape(nd, ns, nm)
    # the splits: the batch and the rows of every blob, and a sharded
    # conv's params (OIHW: the filters first) over the model slots
    acts = activation_sharding(mesh)
    filters = Sharding(mesh, (MODEL_AXIS,))
    spatial = ns > 1
    net_w, net_h = ir.blobs[0].w, ir.blobs[0].h
    _, _, s1, s2 = letterbox_params(img_w, img_h, net_w, net_h)
    threshold = _threshold(ir, nms_threshold)
    allow_tf32 = _tf32_allowed(dtype, precision)
    log = logging.getLogger(__name__)

    def layer_shardable(li, p, report):
        """JAX's per-layer TP decision, on OIHW weights."""
        fn, icg, kh, kw = p["weights"].shape
        if fn % nm != 0:
            report["replicated"].append((li, fn))
            return False
        if spatial and (kh > 1 or kw > 1) and icg > 1:
            report["replicated"].append((li, fn))
            return False
        return True

    def conv_view(li, p, m, plan):
        """Model slot ``m``'s view of sharded conv ``li``."""
        l = ir.layers[li]
        fn = p["weights"].shape[0]
        c_out = filters.block(0, fn, m)
        per = c_out[1] - c_out[0]
        cin = ir.blobs[li].c
        opg, ipg = fn // l.groups, cin // l.groups
        vir = ir
        if l.groups == 1:
            c_in = (0, cin)
        elif per % opg == 0:
            # grouped: the slice's groups read their own input channels
            g0, g1 = c_out[0] // opg, c_out[1] // opg
            c_in = (g0 * ipg, g1 * ipg)
            layers = list(ir.layers)
            layers[li] = dataclasses.replace(l, fn=per, groups=g1 - g0)
            vir = dataclasses.replace(ir, layers=tuple(layers))
        else:
            # a slice that splits a group: the whole conv, then the slice
            return _Conv(c_out, (0, cin), ir, plan, whole=True)
        qv = _slice_plan(plan, li, c_in, c_out) if plan is not None else None
        return _Conv(c_out, c_in, vir, qv)

    def place_params(params):
        """Every slot's params: ``{(data, spatial, model): Params}``, and
        ``{(layer, model): _Conv}`` for the sharded convs."""
        report = {"sharded": [], "replicated": []}
        views: Dict[Tuple[int, int], _Conv] = {}
        sharded = set()
        for li, p in params.items():
            if shard_filters and layer_shardable(li, p, report):
                report["sharded"].append((li, p["weights"].shape[0]))
                sharded.add(li)
        for li in sharded:
            for m in range(nm):
                views[li, m] = conv_view(li, params[li], m, quant)
        whole = replicated(mesh)
        placed = {}
        for idx in np.ndindex(nd, ns, nm):
            placed[idx] = {}
            for li, p in params.items():
                split = whole if li not in sharded or views[
                    li, idx[2]].whole else filters
                placed[idx][li] = {k: split.shard(v, idx)
                                   for k, v in p.items()}
        place_params.report = report
        if shard_filters:
            log.info("TP filter sharding: %d convs sharded on '%s', %d fell "
                     "back to replication (filters %% %d != 0): %s",
                     len(report["sharded"]), MODEL_AXIS,
                     len(report["replicated"]), nm,
                     [li for li, _ in report["replicated"]] or "none")
        return {"slots": placed, "views": views}

    slot_quant = {}

    def plan_on(dev, plan):
        """The plan with its tensors on ``dev``, made once a device."""
        key = (id(plan), dev)
        if key not in slot_quant:
            slot_quant[key] = (plan, plan.to(dev))
        return slot_quant[key][1]

    def assemble(pieces, s_own, m_own, a, b, c0, c1, dev):
        """Rows [a, b) and channels [c0, c1) of a blob from the slots that
        hold them, on ``dev``, contiguous."""
        parts = []
        for s2 in range(ns):
            p = pieces[s2, m_own]
            lo, hi = max(a, p.r0), min(b, p.r1)
            if lo >= hi:
                continue
            if p.c0 <= c0 and c1 <= p.c1:
                chunk = [p.t[:, lo - p.r0:hi - p.r0, :, c0 - p.c0:c1 - p.c0]]
            else:
                chunk = []
                for m2 in range(nm):
                    q = pieces[s2, m2]
                    k0, k1 = max(c0, q.c0), min(c1, q.c1)
                    if k0 < k1:
                        chunk.append(q.t[:, lo - q.r0:hi - q.r0, :,
                                         k0 - q.c0:k1 - q.c0].to(dev))
            parts.append(torch.cat([t.to(dev) for t in chunk], dim=-1)
                         if len(chunk) > 1 else chunk[0].to(dev))
        if not parts:
            raise AssertionError(f"no slot holds rows [{a}, {b})")
        return (torch.cat(parts, dim=1) if len(parts) > 1
                else parts[0]).contiguous()

    def run_layer(li, layer, blobs, placed, idx):
        """Slot ``idx``'s piece of blob li + 1."""
        d, s, m = idx
        dev = grid[idx]
        h_in, h_out = ir.blobs[li].h, ir.blobs[li + 1].h
        o0, o1 = acts.block(1, h_out, s)
        t = layer.type
        view = placed["views"].get((li, m)) if t == LayerType.CONV else None
        c_full = (0, ir.blobs[li + 1].c)
        c_out = view.c_out if view is not None else c_full
        if o0 >= o1:
            return _Piece(None, o0, o1, *c_out)
        if t == LayerType.DROPOUT:
            return blobs[li][d][s, m]             # inference no-op
        if t == LayerType.CONV:
            a, b, off = _window_rows(layer.fs, layer.stride, layer.pad,
                                     o0, o1, h_in)
        elif t in (LayerType.MAXPOOL, LayerType.AVGPOOL):
            a, b, off = _window_rows(layer.fs, layer.stride,
                                     (layer.fs - 1) // 2, o0, o1, h_in,
                                     cover=o1 * layer.stride)
        elif t == LayerType.UPSAMPLE:
            st = layer.stride
            a, b, off = o0 // st, (o1 - 1) // st + 1, (o0 // st) * st
        else:                                     # route, shortcut
            a, b, off = o0, o1, o0
        if t == LayerType.ROUTE:
            reads = [d_ + 1 for d_ in layer.depends]
        elif t == LayerType.SHORTCUT:
            reads = [li, layer.depends[0] + 1]
        else:
            reads = [li]
        c_in = view.c_in if view is not None else None
        blobs_in = {bi: assemble(blobs[bi][d], s, m, a, b,
                                 *(c_in or (0, ir.blobs[bi].c)), dev)
                    for bi in reads}
        vir, plan = (view.ir, view.quant) if view is not None else (ir,
                                                                    quant)
        if plan is not None:
            plan = plan_on(dev, plan)
        _, out = forward_features(vir, placed["slots"][idx], None,
                                  input_dtype=dtype,
                                  quant=plan, start=li, stop=li + 1,
                                  blobs_in=blobs_in, keep_blobs=[li + 1])
        y = out[li + 1][:, o0 - off:o1 - off]
        if view is not None and view.whole:
            y = y[..., c_out[0]:c_out[1]]
        return _Piece(y, o0, o1, *c_out)

    def run(placed, images, mean, norm):
        if isinstance(images, LocalBatch):
            return LocalResult(images.start, run(placed, images.images, mean,
                                                 norm))
        batch = _as_batch(images)
        n = batch.shape[0]
        if n % nd:
            raise ValueError(f"batch {n} is not a multiple of the mesh's "
                             f"data axis {nd}")
        if tuple(batch.shape[1:]) != (img_h, img_w, 3):
            raise ValueError(f"this pipeline takes (N, {img_h}, {img_w}, "
                             f"3) batches, got {tuple(batch.shape)}")
        mean, norm = _channels(mean), _channels(norm)
        # blobs[bi][d][(s, m)] -> _Piece
        blobs: Dict[int, List[Dict[tuple, _Piece]]] = {}
        results = []
        with tf32(allow_tf32):
            blobs[0] = []
            for d in range(nd):
                dev = grid[d, 0, 0]
                b0, b1 = acts.block(0, n, d)
                x = letterbox(batch[b0:b1].to(dev), net_w, net_h, mean, norm,
                              dtype=dtype)
                row = {}
                for s, m in np.ndindex(ns, nm):
                    r0, r1 = acts.block(1, net_h, s)
                    row[s, m] = _Piece(x[:, r0:r1].to(grid[d, s, m])
                                       if r1 > r0 else None, r0, r1, 0, 3)
                blobs[0].append(row)
            feats = [[] for _ in range(nd)]
            for li, layer in enumerate(ir.layers):
                if layer.type in (LayerType.YOLO, LayerType.YOLOV8):
                    # the head map, whole, on the data slot's first device
                    for d in range(nd):
                        dev = grid[d, 0, 0]
                        x = assemble(blobs[li][d], 0, 0, 0, ir.blobs[li].h,
                                     0, ir.blobs[li].c, dev)
                        heads, _ = forward_features(
                            ir, placed["slots"][d, 0, 0], None,
                            input_dtype=dtype,
                            quant=(plan_on(dev, quant) if quant is not None
                                   else None),
                            start=li, stop=li + 1, blobs_in={li: x},
                            keep_blobs=[])
                        feats[d].extend(heads)
                    blobs[li + 1] = [{} for _ in range(nd)]
                    continue
                blobs[li + 1] = [
                    {(s, m): run_layer(li, layer, blobs, placed, (d, s, m))
                     for s, m in np.ndindex(ns, nm)} for d in range(nd)]
            for d in range(nd):
                results.append(_tail(ir, feats[d], topk, threshold, s1, s2))
        return _gather(results, [None] * nd, devices[0])

    return run, place_params
