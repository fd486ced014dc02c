"""IR -> forward pass over NHWC tensors, the PyTorch port of
``ffcnn_tpu/graph/build.py``.

The reference walks its layer array with a refcount memory manager
(net_forward, ffcnn.c:476-520); here the layer loop runs eagerly and the
caching allocator reuses blob memory.  Fused runs of inverted-residual
blocks go through ``kernels/block_fused.py`` (one launch per block); every
other layer is a plain PyTorch op.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from ffcnn_tpu.darknet.ir import LayerType, NetIR

from ..kernels.block_fused import apply_run
from ..ops.activations import activate
from ..ops.conv import conv2d_fused
from ..ops.pool import avgpool2d, maxpool2d, upsample_nearest

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


def forward_features(ir: NetIR, params: Params, x: torch.Tensor, *,
                     input_dtype: Optional[torch.dtype] = None,
                     blob_hook=None, fused_runs=None,
                     fused_params=None) -> List[torch.Tensor]:
    """Run the graph body.  ``x``: (N, H, W, C) net input; a non-float ``x``
    (raw uint8 pixels on the folded fast path) is cast to ``input_dtype``.
    Returns the raw (N, h, w, 3*(5+classes)) map feeding each yolo layer, in
    graph order.

    ``blob_hook(blob_index, value)``: called with every blob materialised,
    NHWC, as the JAX package's hook is.

    ``fused_runs``: ``kernels.block_fused.FusedRun`` list; each run's layers
    execute as fused blocks and their interior blobs never materialise.
    ``fused_params``: ``{run.start: [BlockParams, ...]}`` for every run,
    prepared once by the caller with ``block_params``."""
    if not torch.is_floating_point(x):
        x = x.to(input_dtype or torch.float32)
    float_dtype = x.dtype
    blobs: List[Optional[torch.Tensor]] = [None] * (len(ir.layers) + 1)
    blobs[0] = x
    heads: List[torch.Tensor] = []

    def run_layer(li, layer, inp):
        t = layer.type
        if t == LayerType.CONV:
            p = params[li]
            return conv2d_fused(inp, p["weights"], p["scale"], p["bias"],
                                stride=layer.stride, pad=layer.pad,
                                groups=layer.groups, act=layer.activation)
        if t == LayerType.MAXPOOL:
            return maxpool2d(inp, layer.fs, layer.stride)
        if t == LayerType.AVGPOOL:
            return avgpool2d(inp, layer.fs, layer.stride)
        if t == LayerType.UPSAMPLE:
            return upsample_nearest(inp, layer.stride)
        if t == LayerType.DROPOUT:
            return inp                     # inference no-op (ffcnn.c:412-416)
        if t == LayerType.SHORTCUT:
            y = activate(inp + blobs[layer.depends[0] + 1], layer.activation)
            return y.to(float_dtype)
        if t == LayerType.ROUTE:
            parts = [blobs[d + 1] for d in layer.depends]
            out = parts[0] if len(parts) == 1 else torch.cat(parts, dim=-1)
            if layer.route_groups > 1:     # yolov4-tiny extension
                gc = out.shape[-1] // layer.route_groups
                out = out[..., layer.route_group_id * gc:
                          (layer.route_group_id + 1) * gc].contiguous()
            return out
        if t == LayerType.YOLO:
            heads.append(inp)
            return None                    # yolo produces no blob (ffcnn.c:489)
        if t == LayerType.YOLOV8:
            raise NotImplementedError("[yolov8] heads are not ported yet")
        raise ValueError(f"unsupported layer type {t}")

    run_map = {r.start: r for r in (fused_runs or [])}
    skip_until = -1
    for li, layer in enumerate(ir.layers):
        if li < skip_until:
            continue
        if li in run_map:
            r = run_map[li]
            y = apply_run(blobs[li], r, fused_params[li])
            blobs[r.end + 1] = y.to(float_dtype)
            skip_until = r.end + 1
            if blob_hook is not None:
                blob_hook(r.end + 1, blobs[r.end + 1])
            continue
        blobs[li + 1] = run_layer(li, layer, blobs[li])
        if blob_hook is not None and blobs[li + 1] is not None:
            blob_hook(li + 1, blobs[li + 1])
    return heads
