"""IR -> forward pass over NHWC tensors, the PyTorch port of
``ffcnn_tpu/graph/build.py``.

The reference walks its layer array with a refcount memory manager
(net_forward, ffcnn.c:476-520); here the layer loop runs eagerly and the
caching allocator reuses blob memory.  Fused runs of inverted-residual
blocks go through ``kernels/block_fused.py`` (one launch per block, per
cascade group or per run), fused head chains through
``kernels/head_fused.py`` (one launch per chain), the uint8 stem through
``kernels/conv0_fused.py``, and conv-1 in int8 (``FFCNN_CONV0_INT8``)
through the int8 conv's uint8 mode; every other layer is a plain PyTorch
op.  Every dispatch runs under a ``torch.profiler.record_function`` range
named as the JAX package's ``jax.named_scope`` (``L{li:03d}_{type}``,
``L{li:03d}_fusedrun_to_{end:03d}``, ``L{li:03d}_headrun_to_{end:03d}``,
``L000_conv0_pallas``).

``forward_features`` also runs a segment of the graph (``start``, ``stop``,
``blobs_in``, ``keep_blobs``), computes the layers of ``f32_layers`` in
float32 (the ``FFCNN_HEAD_F32`` and ``FFCNN_F32_STAGES`` knobs; the sets come
from ``head_chain_layers`` and ``stage_layer_set``), and runs an int8 plan
(``quant``): the blobs it marks int8 stored as int8 codes, the convs on them
through the int8 conv kernel (``kernels/conv_int8.py``).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch
from torch.profiler import record_function

from ..darknet.ir import LayerType, NetIR

from ..kernels.block_fused import apply_run, run_blocks
from ..kernels.conv0_fused import conv0_cs
from ..kernels.conv_int8 import conv_int8
from ..kernels.head_fused import apply_head_run
from ..ops.activations import activate
from ..ops.conv import conv2d_f32, conv2d_fused
from ..ops.pool import avgpool2d, maxpool2d, upsample_nearest
from ..quant import quant_state, quantize

Params = Dict[int, Dict[str, torch.Tensor]]


def params_from_numpy(params: Dict, device="cpu",
                      dtype: torch.dtype = torch.float32) -> Params:
    """``{layer_index: FoldedConvParams}`` (numpy, darknet HWIO weights) ->
    ``{layer_index: {"weights", "scale", "bias"}}`` tensors on ``device``:
    OIHW weights in ``dtype``, scale and bias in float32."""
    out: Params = {}
    for li, p in params.items():
        w = torch.from_numpy(np.ascontiguousarray(
            np.asarray(p.weights, np.float32).transpose(3, 2, 0, 1)))
        out[li] = {"weights": w.to(device=device, dtype=dtype),
                   "scale": torch.from_numpy(np.asarray(p.scale, np.float32)
                                             ).to(device),
                   "bias": torch.from_numpy(np.asarray(p.bias, np.float32)
                                            ).to(device)}
    return out


def fold_input_transform(ir: NetIR, params: Params, mean, norm) -> Params:
    """Fold the letterbox normalize + BGR->RGB swap into the first conv, as
    ``ffcnn_tpu/graph/build.py::fold_input_transform`` does:

        w'[o, cb] = w[o, 2-cb] * norm[2-cb]
        bias'[o]  = bias[o] - scale[o] * sum w[o, c] * norm[c] * mean[c]

    so conv-1 runs straight on the raw BGR bytes.  Exact-zero letterbox
    padding survives only for mean == 0.  Needs a dense first conv."""
    first = ir.layers[0]
    if first.type != LayerType.CONV or first.groups != 1:
        raise ValueError("first layer must be a dense conv to fold input")
    p = dict(params[0])
    w = p["weights"]                                   # (fn, 3, fs, fs)
    mean_t = torch.as_tensor(mean, dtype=w.dtype, device=w.device)
    norm_t = torch.as_tensor(norm, dtype=w.dtype, device=w.device)
    p["weights"] = w.flip(1) * norm_t.flip(0)[None, :, None, None]
    s = torch.sum(w * (norm_t * mean_t)[None, :, None, None], dim=(1, 2, 3))
    p["bias"] = p["bias"] - p["scale"] * s
    out = dict(params)
    out[0] = p
    return out


def stage_layer_set(ir: NetIR, stages_csv: str) -> frozenset:
    """``FFCNN_F32_STAGES`` value (e.g. '20' or '160,80') -> the conv and
    shortcut layers whose output blob has one of those spatial widths: the
    stage-local float32 set (``ffcnn_tpu/graph/build.py::stage_layer_set``).
    """
    widths = {int(s) for s in str(stages_csv).split(",") if s.strip()}
    return frozenset(
        li for li, l in enumerate(ir.layers)
        if ir.blobs[li + 1].w in widths
        and l.type in (LayerType.CONV, LayerType.SHORTCUT))


def head_chain_layers(ir: NetIR) -> frozenset:
    """Every conv of the linear chains feeding a ``[yolo]`` head: from each
    yolo layer back over convs whose output has that one consumer (xl: the
    dw/pw chains 116-120 and 125-129), the ``FFCNN_HEAD_F32`` set
    (``ffcnn_tpu/graph/build.py::head_chain_layers``)."""
    cons = _chain_consumers(ir)
    out = set()
    for yi, l in enumerate(ir.layers):
        if l.type != LayerType.YOLO:
            continue
        j = yi - 1
        # layer j writes blob j + 1, which only layer j + 1 may read
        while (j >= 0 and ir.layers[j].type == LayerType.CONV
               and cons.get(j + 1, []) == [j + 1]):
            out.add(j)
            j -= 1
    return frozenset(out)


def _chain_consumers(ir: NetIR) -> Dict[int, List[int]]:
    """blob index -> the layers reading it (the direct input, and route and
    shortcut sources), as ``forward_features`` reads them."""
    cons: Dict[int, List[int]] = {}
    for li, l in enumerate(ir.layers):
        if l.type == LayerType.ROUTE:
            for d in l.depends:
                cons.setdefault(d + 1, []).append(li)
        else:
            cons.setdefault(li, []).append(li)
            if l.type == LayerType.SHORTCUT:
                cons.setdefault(l.depends[0] + 1, []).append(li)
    return cons


def live_blobs(ir: NetIR, cut: int) -> List[int]:
    """The blobs made before layer ``cut`` and read at or after it: what a
    segment ending at ``cut`` passes on (``keep_blobs``) and the next one
    takes (``blobs_in``), as ``ffcnn_tpu/parallel/pp.py::_live_at``."""
    return sorted(bi for bi, users in _chain_consumers(ir).items()
                  if bi <= cut and any(li >= cut for li in users))


def forward_features(ir: NetIR, params: Params, x: Optional[torch.Tensor], *,
                     input_dtype: Optional[torch.dtype] = None,
                     blob_hook=None, fused_runs=None, fused_params=None,
                     fused_groups=None, mega_runs=(), fused_mid_dtype=None,
                     head_runs=None, head_params=None,
                     conv0_pallas: bool = False,
                     conv0_params=None, conv0_int8=None, f32_layers=None,
                     quant=None,
                     start: int = 0, stop: Optional[int] = None,
                     blobs_in: Optional[Dict[int, torch.Tensor]] = None,
                     keep_blobs: Optional[List[int]] = None):
    """Run the graph body.  ``x``: (N, H, W, C) net input; a non-float ``x``
    (raw uint8 pixels on the folded fast path) is cast to ``input_dtype``,
    unless the stem kernel takes it as it is.  Returns the raw map feeding
    each head (``[yolo]``: (N, h, w, 3*(5+classes)); ``[yolov8]``: (N, h, w,
    4*reg_max+classes)), in graph order.

    ``blob_hook(blob_index, value)``: called with every blob materialised,
    NHWC, as the JAX package's hook is (a layer's blob dequantized, a fused
    run's output as stored).

    ``fused_runs``: ``kernels.block_fused.FusedRun`` list; each run's layers
    execute as fused blocks and their interior blobs never materialise.
    ``fused_params``: ``{run.start: [BlockParams, ...]}`` for every run,
    prepared once by the caller with ``block_params``.  ``fused_groups``:
    ``{run.start: cascade_groups(run, k)}``, the launch groups (default one
    block a launch); ``mega_runs``: the starts of the runs that launch
    whole (K5); ``fused_mid_dtype``: the storage of the boundaries between
    launches (default the blob dtype; float32 with
    ``FFCNN_FUSED_STORE=f32``).

    ``head_runs``: ``kernels.head_fused.HeadRun`` list; each chain feeding a
    yolo layer executes as one launch.  ``head_params``:
    ``{run.start: HeadParams}``, prepared once with ``head_params``.

    ``conv0_pallas``: run the stem (K6, ``kernels/conv0_fused.py``) straight
    off uint8 ``x`` and hand its output to the fused run that starts at
    layer 1, group by group and never whole (as JAX's stem enters
    ``run_blocks_cs``), where the JAX package's guard allows it (``x`` uint8, a
    3x3/s2/pad-1 dense stem over even sizes, a run at layer 1, blob 1 read
    by no route or shortcut); otherwise the normal path runs.
    ``conv0_params``: the stem's ``Conv0Params``, from the same (folded)
    ``params``.

    ``conv0_int8``: conv-1 straight off uint8 ``x`` in int8
    (``FFCNN_CONV0_INT8``): the uint8 mode's ``Int8Conv``
    (``kernels.conv_int8.prepare_conv0``, on the folded weights and the
    net's input geometry).  Taken where the JAX package's guard allows it
    (``x`` uint8, a dense first conv, layer 0 not quantized by the plan,
    blob 0 read by no route or shortcut), before the stem kernel, which it
    then displaces, as in JAX.  The output is stored requantized where
    the plan marks blob 1 int8.

    ``f32_layers``: a set of layer indices computed in float32, as JAX's
    ``run_layer`` computes them: a conv in the set casts its input to
    float32 (its output blob stays float32) and runs as one op,
    ``ops.conv.conv2d_f32`` (on the card cuDNN's TF32 off inside it, so an
    exported program keeps that precision), a shortcut in the set adds in
    float32 and keeps the sum float32, and a conv outside the set casts
    its input back to the blob dtype, so a forced stage stays local to
    that stage.  The caller drops the fused runs that overlap the set
    (``net.Net`` does).

    ``quant``: an int8 plan (``quant.QuantPlan``), as the JAX builder runs
    it: a blob the plan marks int8 is stored as int8 codes at its scale; a
    conv on an int8 blob whose weights the plan quantized runs through the
    int8 conv (``kernels.conv_int8``, straight into its output's storage);
    other convs, avgpool, shortcut and the heads read their inputs
    dequantized, and store their outputs requantized where the plan says
    so; maxpool and upsample pass codes through at a shared scale; route
    passes, rescales or quantizes each part; a fused run takes its input
    dequantized, stores its interior int8 boundaries as codes
    (``run_blocks``) and its output as the plan says.  The stem kernel is
    not taken where the plan quantizes layer 0 or blob 1.  The plan's
    constants come from ``quant.quant_state``, made once a plan.

    Segments (``ffcnn_tpu/graph/build.py``'s, for pipeline stages):
    ``start``/``stop`` bound the layers run, [start, stop); ``blobs_in``
    seeds the blob table with the blobs that cross into the segment (``x``
    may then be None); ``keep_blobs`` returns those blobs besides the heads,
    as ``(heads, {blob: value})``.  The defaults run the whole graph with
    its return type.  A fused run, a head chain or the stem that straddles
    ``start`` or ``stop`` is refused (ValueError): its interior blobs never
    exist."""
    nlayers = len(ir.layers)
    stop = nlayers if stop is None else stop
    if not 0 <= start <= stop <= nlayers:
        raise ValueError(f"segment [{start}, {stop}) outside the graph's "
                         f"{nlayers} layers")
    for kind, rs in (("fused run", fused_runs), ("head chain", head_runs)):
        for r in rs or ():
            for cut in (start, stop):
                if r.start < cut <= r.end:
                    raise ValueError(
                        f"the {kind} L{r.start}-L{r.end} straddles the "
                        f"segment edge at layer {cut}; split between runs")
    run_map = {r.start: r for r in (fused_runs or [])}
    groups = fused_groups or {}
    head_map = {r.start: r for r in (head_runs or [])}
    l0 = ir.layers[0]

    def reads_blob(bi):
        return any(bi in (d + 1 for d in l.depends) for l in ir.layers
                   if l.type in (LayerType.ROUTE, LayerType.SHORTCUT))

    use_c0q = (conv0_int8 is not None and start == 0 and x is not None
               and x.dtype == torch.uint8
               and l0.type == LayerType.CONV and l0.groups == 1
               and (quant is None or 0 not in quant.weights)
               and not reads_blob(0))
    use_c0p = (conv0_pallas and not use_c0q and start == 0 and x is not None
               and x.dtype == torch.uint8 and 1 in run_map
               and l0.type == LayerType.CONV and l0.groups == 1
               and l0.fs == 3 and l0.stride == 2 and l0.pad == 1
               and ir.blobs[0].w % 2 == 0 and ir.blobs[0].h % 2 == 0
               and (quant is None or (0 not in quant.weights
                                      and not quant.blob_is_int8(1)))
               and not reads_blob(1))
    if use_c0p and stop <= run_map[1].end:
        raise ValueError(f"the stem (layer 0 into the fused run L1-"
                         f"L{run_map[1].end}) straddles the segment edge at "
                         f"layer {stop}")
    if use_c0q or use_c0p or x is None:
        float_dtype = input_dtype or torch.float32
    else:
        if not torch.is_floating_point(x):
            x = x.to(input_dtype or torch.float32)
        float_dtype = x.dtype
    blobs: List[Optional[torch.Tensor]] = [None] * (nlayers + 1)
    blobs[0] = x
    for bi, v in (blobs_in or {}).items():
        blobs[bi] = v
    heads: List[torch.Tensor] = []
    if quant is not None:
        dev = next(v for v in blobs if v is not None).device
        qs = quant_state(quant, ir, float_dtype, dev)

    def is_q(bi):
        return quant is not None and quant.blob_is_int8(bi)

    def deq(bi, v=None):
        """Blob bi as float (dequantized if stored int8)."""
        v = blobs[bi] if v is None else v
        return v.to(float_dtype) * qs.deq[bi] if is_q(bi) else v

    def store(bi, y):
        """A float result -> blob bi's storage (requantized if int8)."""
        return quantize(y, qs.inv[bi]) if is_q(bi) else y.to(float_dtype)

    def reconcile(li, out):
        """A pass-through layer's output (maxpool, upsample of blob li) ->
        the storage of blob li + 1: itself where both share storage and
        scale, else dequantized and stored."""
        if is_q(li) == is_q(li + 1) and (not is_q(li) or np.array_equal(
                np.asarray(quant.blob_scale[li]),
                np.asarray(quant.blob_scale[li + 1]))):
            return out
        return store(li + 1, deq(li, out))

    def route(li, layer):
        srcs = [d + 1 for d in layer.depends]
        if is_q(li + 1) and li not in qs.route:
            # per-channel scales do not survive the group slice: combine
            # in float, store once
            out = torch.cat([deq(bi) for bi in srcs], dim=-1)
            gc = out.shape[-1] // layer.route_groups
            return store(li + 1, out[..., layer.route_group_id * gc:
                                     (layer.route_group_id + 1) * gc])
        if is_q(li + 1):
            parts = []
            for bi, (kind, k) in zip(srcs, qs.route[li]):
                v = blobs[bi]
                if kind == "pass":
                    parts.append(v)          # exact passthrough
                elif kind == "rescale":
                    parts.append(quantize(v, k))
                elif kind == "quant":        # a float part, its slice
                    parts.append(quantize(deq(bi, v), k))
                else:
                    parts.append(store(li + 1, v))
        else:
            parts = [deq(bi) for bi in srcs]
        out = parts[0] if len(parts) == 1 else torch.cat(parts, dim=-1)
        if layer.route_groups > 1:     # yolov4-tiny extension
            gc = out.shape[-1] // layer.route_groups
            out = out[..., layer.route_group_id * gc:
                      (layer.route_group_id + 1) * gc].contiguous()
        return out

    def run_layer(li, layer, inp):
        t = layer.type
        if t == LayerType.CONV:
            if li == 0 and use_c0q:                  # conv-1 in int8
                y = conv_int8(inp.contiguous(), conv0_int8, float_dtype)
                return store(li + 1, y) if is_q(li + 1) else y
            if is_q(li) and li in quant.weights:     # the int8 conv
                return conv_int8(inp, qs.convs[li], float_dtype)
            p = params[li]
            forced = f32_layers is not None and li in f32_layers
            inp = deq(li, inp)
            if f32_layers is not None:
                inp = inp.to(torch.float32 if forced else float_dtype)
            # a forced conv is one op that holds its precision
            y = (conv2d_f32 if forced else conv2d_fused)(
                inp, p["weights"], p["scale"], p["bias"],
                stride=layer.stride, pad=layer.pad, groups=layer.groups,
                act=layer.activation)
            return store(li + 1, y) if is_q(li + 1) else y
        if t == LayerType.MAXPOOL:
            # max commutes with a shared positive scale
            return reconcile(li, maxpool2d(inp, layer.fs, layer.stride))
        if t == LayerType.AVGPOOL:
            if quant is None:
                return avgpool2d(inp, layer.fs, layer.stride)
            return store(li + 1, avgpool2d(deq(li, inp), layer.fs,
                                           layer.stride))
        if t == LayerType.UPSAMPLE:
            return reconcile(li, upsample_nearest(inp, layer.stride))
        if t == LayerType.DROPOUT:
            return inp                     # inference no-op (ffcnn.c:412-416)
        if t == LayerType.SHORTCUT:
            a, b = deq(li, inp), deq(layer.depends[0] + 1)
            if f32_layers is not None and li in f32_layers:
                # in a forced stage: the residual chain stays float32
                y = activate(a.float() + b.float(), layer.activation)
                return store(li + 1, y) if is_q(li + 1) else y
            return store(li + 1, activate(a + b, layer.activation))
        if t == LayerType.ROUTE:
            return route(li, layer)
        if t in (LayerType.YOLO, LayerType.YOLOV8):
            heads.append(deq(li, inp))
            return None                    # yolo produces no blob (ffcnn.c:489)
        raise ValueError(f"unsupported layer type {t}")

    def finish_run(end, y):
        blobs[end + 1] = store(end + 1, y)
        if blob_hook is not None:
            blob_hook(end + 1, blobs[end + 1])
        return end + 1

    # Each dispatch runs under a profiler range named as the JAX package's
    # jax.named_scope names it (profiling.py attributes device time to
    # them); a CUDA graph's replay runs no Python and so no range.
    skip_until = -1
    for li in range(start, stop):
        layer = ir.layers[li]
        if li < skip_until:
            continue
        if li == 0 and use_c0p:
            # the stem's output (blob 1) goes straight into the run at 1
            r = run_map[1]
            with record_function("L000_conv0_pallas"):
                # the kernel reads dense rows; a strided batch is copied
                y0 = conv0_cs(x.contiguous(), conv0_params, float_dtype)
            with record_function(f"L001_fusedrun_to_{r.end:03d}"):
                skip_until = finish_run(r.end, run_blocks(
                    y0, r, fused_params[1], groups.get(1), fused_mid_dtype,
                    quant))
            continue
        if li in head_map:
            r = head_map[li]
            with record_function(f"L{li:03d}_headrun_to_{r.end:03d}"):
                skip_until = finish_run(r.end, apply_head_run(
                    deq(li), r, head_params[li]))
            continue
        if li in run_map:
            r = run_map[li]
            with record_function(f"L{li:03d}_fusedrun_to_{r.end:03d}"):
                skip_until = finish_run(r.end, apply_run(
                    deq(li), r, fused_params[li], groups=groups.get(li),
                    mega=li in mega_runs, mid_dtype=fused_mid_dtype,
                    quant=quant))
            continue
        with record_function(f"L{li:03d}_{layer.type.name.lower()}"):
            blobs[li + 1] = run_layer(li, layer, blobs[li])
        if blob_hook is not None and blobs[li + 1] is not None:
            blob_hook(li + 1, deq(li + 1))
    if keep_blobs is not None:
        return heads, {bi: blobs[bi] for bi in keep_blobs}
    return heads
