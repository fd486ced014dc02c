"""Pipeline-parallel inference over a ``pipe`` mesh axis, the port of
``ffcnn_tpu/parallel/pp.py``.

The layer list is split into S contiguous stages (``plan_stages``); stage s
runs on the mesh's ``pipe`` slot s, with a CUDA stream of its own, and M
microbatches stream through in GPipe order: tick t runs microbatch t - s on
stage s, S + M - 1 ticks in all.  At each cut the blobs a later layer
still reads (the stage's ``live_out``: the direct input and any blob a
later route or shortcut reads) go to the next stage's device as a dict of
tensors, the next stage's stream waiting on an event the producer's stream
recorded.  (JAX packs them into one flat wire buffer because every device
of an SPMD program needs one wire type; the port runs a program a stage
and needs no packing.)

Stage bodies run the plain path through ``forward_features``' segments, as
JAX's do; stage 0 also runs the letterbox, and the last stage, which holds
every head (the partitioner keeps them there), the decode, the arena cap,
top-k and K2.  A (data, pipe) mesh splits each microbatch over ``data``.
The partition balances the JAX package's per-layer floors (``balance``),
so the cuts are JAX's.
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import roofline
from ..darknet.ir import LayerType, NetIR
from ..graph.build import _chain_consumers, forward_features, live_blobs
from ..ops.preprocess import letterbox, letterbox_params
from ..runtime import tf32
from .dp import (_as_batch, _channels, _gather, _mesh_devices, _on,
                 _stream, _tail, _tf32_allowed, _threshold)
from .mesh import (DATA_AXIS, MODEL_AXIS, PIPE_AXIS, SPATIAL_AXIS, Mesh,
                   batch_sharding)
from .multiprocess import LocalBatch, LocalResult


@dataclasses.dataclass(frozen=True)
class Stage:
    """Layers [start, stop) plus the blob sets crossing each boundary."""
    start: int
    stop: int
    live_in: Tuple[int, ...]    # blob indices this stage reads from the cut
    live_out: Tuple[int, ...]   # blob indices it passes downstream


# The JAX package's roofline rates (HBM GB/s, MXU and VPU TFLOP/s), used
# here only as the weights of the stage balance, so the cuts are JAX's.
_JAX_RATES = (665.0, 197.0, 3.5)


def balance(ir: NetIR, microbatch: int = 1, dtype: str = "bf16"
            ) -> List[float]:
    """The per-layer floors JAX's ``plan_stages`` balances: this port's
    roofline counts (``roofline.layer_costs``, the same FLOPs as JAX's) less
    the blobs JAX's model has XLA fuse away (a conv inlines its producer
    conv when that producer's output has one reader, one deep), at JAX's
    rates."""
    cons = _chain_consumers(ir)
    paired, away = set(), []
    for li, l in enumerate(ir.layers):
        p = li - 1
        if (l.type == LayerType.CONV and p >= 0
                and ir.layers[p].type == LayerType.CONV
                and p not in paired and li not in paired
                and len(cons.get(li, ())) == 1):
            paired.update((p, li))
            away.append(li)             # blob li: written by p, read by li
    extra: Dict[int, int] = defaultdict(int)
    for b in away:
        blob = ir.blobs[b]
        n = roofline.stored_bytes(blob.w, blob.h, blob.c, microbatch, dtype)
        extra[b - 1] += n
        extra[b] += n
    return [dataclasses.replace(c, bytes_act=c.bytes_act - extra[c.index])
            .floor_us(*_JAX_RATES)
            for c in roofline.layer_costs(ir, microbatch, dtype=dtype)]


def plan_stages(ir: NetIR, n_stages: int, *, microbatch: int = 1,
                dtype: str = "bf16") -> List[Stage]:
    """Split the layer list into ``n_stages`` contiguous stages that
    minimise the largest stage's cost (``balance``; an exact
    linear-partition DP, as JAX's), every YOLO layer in the last stage."""
    n = len(ir.layers)
    yolos = [li for li, l in enumerate(ir.layers)
             if l.type in (LayerType.YOLO, LayerType.YOLOV8)]
    if not yolos:
        raise ValueError("pipeline planning needs at least one yolo head")
    last_cut_max = min(yolos)
    if not (1 <= n_stages <= last_cut_max + 1):
        raise ValueError(
            f"n_stages={n_stages} out of range for {n} layers with first "
            f"yolo at {min(yolos)}")
    costs = balance(ir, microbatch, dtype)
    prefix = [0.0]
    for c in costs:
        prefix.append(prefix[-1] + c)
    inf = float("inf")
    best = [[inf] * (n + 1) for _ in range(n_stages + 1)]
    arg = [[0] * (n + 1) for _ in range(n_stages + 1)]
    best[0][0] = 0.0
    for k in range(1, n_stages + 1):
        for i in range(k, n + 1):
            if k == n_stages and i != n:
                continue
            # the last group is [j, i); the final stage starts by the yolo
            for j in range(k - 1, i):
                if k == n_stages and j > last_cut_max:
                    break
                v = max(best[k - 1][j], prefix[i] - prefix[j])
                if v < best[k][i]:
                    best[k][i], arg[k][i] = v, j
    if best[n_stages][n] == inf:
        raise ValueError("no valid stage partition")
    cuts = [n]
    for k in range(n_stages, 0, -1):
        cuts.append(arg[k][cuts[-1]])
    cuts = cuts[::-1]
    return [Stage(cuts[s], cuts[s + 1],
                  tuple(live_blobs(ir, cuts[s])) if s else (),
                  tuple(live_blobs(ir, cuts[s + 1]))
                  if s + 1 < n_stages else ())
            for s in range(n_stages)]


def build_pp_pipeline(ir: NetIR, params, mesh: Mesh, img_h: int, img_w: int,
                      *, n_microbatches: int, dtype=torch.float32,
                      precision=None, topk: int = 128,
                      nms_threshold: float = None,
                      mean=(0.0, 0.0, 0.0),
                      norm=(1 / 255.0, 1 / 255.0, 1 / 255.0),
                      stages: Optional[List[Stage]] = None):
    """``(uint8 (N, img_h, img_w, 3)) -> NMSResult`` over the mesh's
    ``pipe`` axis (stages) and ``data`` axis (each microbatch's images),
    N = n_microbatches x the microbatch, the microbatch a multiple of the
    data axis; the result in batch order on data slot 0's last stage (a
    ``multiprocess.LocalBatch`` gives a ``LocalResult``).  ``params``: the
    Net-layout params (``graph.build.params_from_numpy``); each stage's go
    to its device once, here.  ``dtype`` float32 runs TF32 off unless
    ``precision`` says otherwise."""
    if PIPE_AXIS not in mesh.shape:
        raise ValueError("mesh has no 'pipe' axis — build it with "
                         "make_mesh(..., pipeline_parallel=S)")
    for axis in (SPATIAL_AXIS, MODEL_AXIS):
        if mesh.axis_size(axis) > 1:
            raise ValueError(f"build_pp_pipeline splits data and pipe only; "
                             f"mesh has {axis}={mesh.shape[axis]}")
    _mesh_devices(mesh)
    n_stages = mesh.shape[PIPE_AXIS]
    ndata = mesh.shape[DATA_AXIS]
    nmb = n_microbatches
    net_w, net_h = ir.blobs[0].w, ir.blobs[0].h
    _, _, s1, s2 = letterbox_params(img_w, img_h, net_w, net_h)
    threshold = _threshold(ir, nms_threshold)
    allow_tf32 = _tf32_allowed(dtype, precision)
    mean, norm = _channels(mean), _channels(norm)
    if stages is None:
        stages = plan_stages(ir, n_stages,
                             dtype="f32" if dtype == torch.float32
                             else "bf16")
    if len(stages) != n_stages:
        raise ValueError(f"{len(stages)} stages for a pipe axis of "
                         f"{n_stages}")
    grid = mesh.devices.reshape(ndata, n_stages)
    split = batch_sharding(mesh)              # a microbatch over data
    streams = [[_stream(grid[d, s]) for s in range(n_stages)]
               for d in range(ndata)]
    stage_params = [[{li: {k: v.to(grid[d, s]) for k, v in p.items()}
                      for li, p in params.items()
                      if stages[s].start <= li < stages[s].stop}
                     for s in range(n_stages)] for d in range(ndata)]

    def hop(blobs, d, s):
        """Stage s - 1's live blobs, ordered before stage s's stream."""
        vals, ev = blobs
        dev, stream = grid[d, s], streams[d][s]
        if stream is not None:
            stream.wait_event(ev)
        out = {}
        with _on(streams[d][s - 1]), _on(stream):
            for bi, v in vals.items():
                if v.device == dev:
                    if stream is not None:
                        v.record_stream(stream)
                    out[bi] = v
                else:
                    out[bi] = v.to(dev, non_blocking=True)
        return out

    def run(images):
        if isinstance(images, LocalBatch):
            return LocalResult(images.start, run(images.images))
        batch = _as_batch(images)
        n = batch.shape[0]
        if n % nmb:
            raise ValueError(f"batch {n} is not a multiple of "
                             f"n_microbatches={nmb}")
        mb = n // nmb
        if mb % ndata:
            raise ValueError(f"microbatch {mb} is not a multiple of the "
                             f"mesh's data axis {ndata}")
        if grid[0, 0].type == "cuda":
            if batch.device.type == "cpu":
                batch = batch.pin_memory()
            # every stage after what the caller queued on its device
            for d, s in np.ndindex(ndata, n_stages):
                streams[d][s].wait_stream(
                    torch.cuda.current_stream(grid[d, s]))
        wire: Dict[tuple, tuple] = {}
        done: Dict[tuple, object] = {}
        with tf32(allow_tf32):
            for t in range(nmb + n_stages - 1):
                for s in range(n_stages):
                    m = t - s
                    if not 0 <= m < nmb:
                        continue
                    st = stages[s]
                    for d in range(ndata):
                        stream = streams[d][s]
                        with _on(stream):
                            if s == 0:
                                b0, b1 = split.block(0, mb, d)
                                x = letterbox(
                                    batch[m * mb + b0:m * mb + b1].to(
                                        grid[d, 0], non_blocking=True),
                                    net_w, net_h, mean, norm, dtype=dtype)
                                blobs_in = None
                            else:
                                x, blobs_in = None, hop(wire.pop((m, d)),
                                                        d, s)
                            heads, out = forward_features(
                                ir, stage_params[d][s], x,
                                input_dtype=dtype, start=st.start,
                                stop=st.stop, blobs_in=blobs_in,
                                keep_blobs=list(st.live_out))
                            if s == n_stages - 1:
                                done[m, d] = _tail(ir, heads, topk,
                                                   threshold, s1, s2)
                            else:
                                ev = None
                                if stream is not None:
                                    ev = torch.cuda.Event()
                                    ev.record(stream)
                                wire[m, d] = (out, ev)
        last = [streams[d][n_stages - 1] for d in range(ndata)]
        order = [(m, d) for m in range(nmb) for d in range(ndata)]
        return _gather([done[k] for k in order], [last[d] for _, d in order],
                       grid[0, n_stages - 1])

    return run
