"""Post-training int8 quantization, the port of ``ffcnn_tpu/quant.py``.

Scheme (symmetric, as in the JAX package):

* **Weights**: the BN fold's per-output-channel ``scale`` is folded into
  the weights, then each output channel is quantized to int8 at its own
  ``wscale[o] = absmax(w'[..., o]) / 127``.
* **Activations**: one scale a blob, ``absmax / 127``, from a float32
  calibration forward (``collect_blob_absmax``); with ``per_channel``
  (``FFCNN_INT8_PERCH=1``) one a channel, folded into the consumer conv's
  weights before they are quantized, so that conv runs at ``x_scale = 1``.
* **Conv**: ``acc = conv_int8(xq, wq)`` (int32), epilogue ``act(acc * (sx *
  wscale) + bias)`` in float32, then a requantize to the output blob's
  scale or the float dtype (``ops.conv.conv2d_int8``).
* **Blob policy**: int8 where the blob has ``>= min_channels`` channels and
  feeds no head decode (``_head_protect``).  Maxpool, upsample and dropout
  keep their input's scale; shortcut and route dequantize, combine and
  requantize (``graph.build.forward_features``).

The plan policy and the weight quantization are numpy, as in the JAX
package, so both packages build the same plan bit for bit from the same
absmax.  A plan's tensors (``wq``, ``wscale``, ``bias``) live on one device:
``QuantPlan.to`` moves them once, when a ``Net`` installs the plan.
``save_plan``/``load_plan`` read and write the JAX package's npz format,
so a plan calibrated by either package loads into the other.
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
from typing import Dict, List, Optional

import numpy as np
import torch

from .darknet.ir import LayerType, NetIR


@dataclasses.dataclass(frozen=True)
class QuantPlan:
    """What the graph needs to run int8.  ``blob_scale`` values are Python
    floats (per-tensor plans) or float32 numpy vectors of shape (C,)
    (per-channel plans).  ``weights``: conv layer -> ``{"wq"``: (fs, fs,
    C/groups, fn) int8 HWIO, ``"wscale"``, ``"bias"``: (fn,) float32,
    tensors on one device, and ``"xs": 1.0`` in per-channel plans``}``."""
    blob_scale: Dict[int, object]
    weights: Dict[int, dict]
    min_channels: int
    per_channel: bool = False
    # the prepared device state of forward_features, by (ir, float dtype):
    # made once, never while a CUDA graph captures
    prepared: dict = dataclasses.field(default_factory=dict, compare=False,
                                       repr=False)

    def blob_is_int8(self, bi: int) -> bool:
        return bi in self.blob_scale

    def scalar_scale(self, bi: int) -> Optional[float]:
        """The blob's scale as a Python float, or None for per-channel
        plans: the fused kernels' int8 boundaries take one scale a blob,
        so vector-scaled boundaries stay float there."""
        s = self.blob_scale[bi]
        return float(s) if np.ndim(s) == 0 else None

    def to(self, device) -> "QuantPlan":
        """The plan with its tensors on ``device`` (itself if already
        there)."""
        device = torch.device(device)
        if all(q["wq"].device == device for q in self.weights.values()):
            return self
        weights = {li: {k: (v.to(device) if isinstance(v, torch.Tensor)
                            else v) for k, v in q.items()}
                   for li, q in self.weights.items()}
        return QuantPlan(dict(self.blob_scale), weights, self.min_channels,
                         self.per_channel)


def plan_from_numpy(plan_like, device="cpu") -> QuantPlan:
    """A plan-shaped object (``blob_scale``, ``weights``, ``min_channels``,
    ``per_channel``; e.g. a JAX ``QuantPlan`` whose arrays are turned into
    numpy) -> a port ``QuantPlan`` with its tensors on ``device``, the
    counterpart of ``graph.build.params_from_numpy``."""
    weights = {}
    for li, q in plan_like.weights.items():
        weights[int(li)] = {
            "wq": torch.from_numpy(np.array(q["wq"], np.int8)).to(device),
            "wscale": torch.from_numpy(np.array(q["wscale"], np.float32)
                                       ).to(device),
            "bias": torch.from_numpy(np.array(q["bias"], np.float32)
                                     ).to(device)}
        if "xs" in q:
            weights[int(li)]["xs"] = float(q["xs"])
    blob_scale = {int(b): (np.asarray(s, np.float32) if np.ndim(s)
                           else float(s))
                  for b, s in plan_like.blob_scale.items()}
    return QuantPlan(blob_scale, weights, int(plan_like.min_channels),
                     bool(getattr(plan_like, "per_channel", False)))


def _head_protect(ir: NetIR):
    """(blob indices, conv layer indices) that feed a head decode and stay
    float: a ``[yolo]`` head's input blob and the conv that makes it; a
    ``[yolov8]`` head's route concat, each of the route's sources and the
    convs that make them, and their input blobs
    (``ffcnn_tpu/quant.py::_head_protect``)."""
    blobs, convs = set(), set()
    for l in ir.layers:
        if l.type not in (LayerType.YOLO, LayerType.YOLOV8):
            continue
        hi = l.index
        blobs.add(hi)                          # the decode input blob
        prod = ir.layers[hi - 1]
        srcs = list(prod.depends) if prod.type == LayerType.ROUTE \
            else [hi - 1]
        for s in srcs:
            blobs.add(s + 1)                   # the source's output blob
            if ir.layers[s].type == LayerType.CONV:
                convs.add(s)                   # float weights
                blobs.add(s)                   # and its input blob
    return blobs, convs


def _int8_blobs(ir: NetIR, min_channels: int,
                exclude: Optional[set] = None) -> List[int]:
    """The blobs eligible for int8: not the net input, not a head-feeding
    blob (``_head_protect``), not excluded, not a head's (absent) output,
    and at least ``min_channels`` channels."""
    protected, _ = _head_protect(ir)
    out = []
    for bi in range(1, len(ir.blobs)):
        if bi in protected or (exclude and bi in exclude):
            continue
        li = bi - 1                      # producing layer
        if li < len(ir.layers) and ir.layers[li].type in (
                LayerType.YOLO, LayerType.YOLOV8):
            continue                     # heads produce no blob
        if ir.blobs[bi].c >= min_channels:
            out.append(bi)
    return out


def _percentile(v: torch.Tensor, q: float) -> torch.Tensor:
    """The ``q``-th percentile of ``v`` (flattened), linearly interpolated
    between the order statistics at floor and ceil of q/100 * (n - 1), in
    float32 as ``jnp.percentile`` computes it (the rank too, so a large n
    rounds as it does there).  From ``kthvalue``: ``torch.quantile``
    refuses more than 2^24 elements."""
    flat = v.reshape(-1).float()
    f32 = np.float32
    n = f32(flat.numel())
    pos = f32(f32(f32(q) / f32(100)) * (n - f32(1)))
    lo = int(min(max(np.floor(pos), 0), n - 1))
    hi = int(min(max(np.ceil(pos), 0), n - 1))
    high_w = f32(pos - f32(np.floor(pos)))
    a = flat.kthvalue(lo + 1).values
    b = flat.kthvalue(hi + 1).values if hi != lo else a
    return a * float(f32(1) - high_w) + b * float(high_w)


def collect_blob_absmax(ir: NetIR, params, images, mean, norm,
                        percentile: Optional[float] = None,
                        per_channel: bool = False, device="cpu"):
    """The calibration pass: a float32 forward (TF32 off, as parity mode
    runs it) on uint8 BGR ``images`` through the port's own
    ``forward_features``, returning each blob's absmax: a (len(blobs),)
    float32 array, or with ``per_channel`` a ``{blob: (C,) vector}`` dict.
    ``percentile`` (per-tensor only): that percentile of |x| instead of the
    absmax.  ``params``: the port's params (``params_from_numpy``) on
    ``device``."""
    from .graph.build import forward_features
    from .net import _tf32
    from .ops.preprocess import letterbox

    if per_channel and percentile is not None:
        raise ValueError("percentile clip is per-tensor only")
    net_w, net_h = ir.blobs[0].w, ir.blobs[0].h
    stats: List = []

    def record(bi, v):
        a = v.abs()
        if per_channel:
            stats.append((bi, a.reshape(-1, a.shape[-1]).amax(0)))
        elif percentile is None:
            stats.append((bi, a.amax()))
        else:
            stats.append((bi, _percentile(a, percentile)))

    bgr = torch.from_numpy(np.ascontiguousarray(images)).to(device)
    with _tf32(False), torch.no_grad():
        x = letterbox(bgr, net_w, net_h, mean, norm, dtype=torch.float32)
        record(0, x)
        forward_features(ir, params, x, blob_hook=record)
    if per_channel:
        out: Dict[int, np.ndarray] = {}
        for bi, v in stats:
            v = v.float().cpu().numpy()
            out[bi] = np.maximum(out[bi], v) if bi in out else v
        return out
    vals = torch.stack([v.float() for _, v in stats]).cpu().numpy()
    flat = np.zeros(len(ir.blobs), np.float32)
    for (bi, _), v in zip(stats, vals):
        flat[bi] = max(flat[bi], float(v))
    return flat


def _hwio(p, key: str) -> np.ndarray:
    """A conv's parameter as float32 numpy, weights HWIO: from a port params
    entry (OIHW tensors) or a numpy/JAX one (HWIO)."""
    v = p[key] if isinstance(p, dict) else getattr(p, key)
    if isinstance(v, torch.Tensor):
        v = v.detach().float().cpu().numpy()
        if key == "weights":
            v = v.transpose(2, 3, 1, 0)
    return np.asarray(v, np.float32)


def build_plan(ir: NetIR, params, absmax, min_channels: int = 32,
               exclude_blobs: Optional[set] = None,
               device="cpu") -> QuantPlan:
    """Quantize the weights and assign the blob scales from calibrated
    ``absmax`` (``ffcnn_tpu/quant.py::build_plan``, the same numpy
    arithmetic): per-blob scalars build a per-tensor plan, a ``{blob: (C,)
    vector}`` dict a per-channel plan.  ``params``: the port's params or
    the darknet ``FoldedConvParams``; the plan's tensors go to
    ``device``."""
    per_channel = isinstance(absmax, dict)
    int8_set = set(_int8_blobs(ir, min_channels, exclude_blobs))
    blob_scale: Dict[int, object] = {}
    for bi in sorted(int8_set):
        producer = ir.layers[bi - 1]
        if (producer.type in (LayerType.MAXPOOL, LayerType.UPSAMPLE,
                              LayerType.DROPOUT)
                and (bi - 1) in blob_scale):   # the producer's input blob
            blob_scale[bi] = blob_scale[bi - 1]
            continue
        if per_channel:
            amax = np.asarray(absmax[bi], np.float32)
            blob_scale[bi] = np.where(amax > 0, amax / 127.0,
                                      1.0).astype(np.float32)
        else:
            amax = float(absmax[bi])
            blob_scale[bi] = (amax / 127.0) if amax > 0 else 1.0

    weights: Dict[int, dict] = {}
    _, head_convs = _head_protect(ir)
    for li, l in enumerate(ir.layers):
        if l.type != LayerType.CONV or li not in blob_scale \
                or li in head_convs:
            continue      # a float input, or a head conv: float weights
        p = params[li]
        w, scale, bias = (_hwio(p, k) for k in ("weights", "scale", "bias"))
        wf = w * scale[None, None, None, :]          # fold the BN scale
        if per_channel:
            # absorb the input blob's channel scales: filter n reads input
            # channels [group(n) * icg, + icg), group(n) = n // fpg
            sx = np.asarray(blob_scale[li], np.float32)
            fs0, fs1, icg, fn = wf.shape
            g = l.groups
            fpg = fn // g
            wf = (wf.reshape(fs0, fs1, icg, g, fpg)
                  * sx.reshape(g, icg).T[None, None, :, :, None]
                  ).reshape(fs0, fs1, icg, fn)
        wmax = np.abs(wf).reshape(-1, wf.shape[-1]).max(axis=0)
        wscale = np.where(wmax > 0, wmax / 127.0, 1.0).astype(np.float32)
        wq = np.clip(np.round(wf / wscale), -127, 127).astype(np.int8)
        weights[li] = {"wq": torch.from_numpy(wq).to(device),
                       "wscale": torch.from_numpy(wscale).to(device),
                       "bias": torch.from_numpy(bias).to(device)}
        if per_channel:
            weights[li]["xs"] = 1.0      # the input scales are in wq
    return QuantPlan(blob_scale=blob_scale, weights=weights,
                     min_channels=min_channels, per_channel=per_channel)


def _attribution_exclusions(ir: NetIR, min_channels: int,
                            exclude_blobs: Optional[set]) -> Optional[set]:
    """The attribution knobs (environment only): ``FFCNN_INT8_EXCLUDE_BLOBS
    =81,82`` keeps those blobs float on top of the plan;
    ``FFCNN_INT8_ONLY_BLOBS=81,82`` quantizes only those (of the eligible
    ones)."""
    def _parse(name):
        raw = os.environ.get(name, "").strip()
        if not raw:
            return None
        return {int(t) for t in raw.split(",") if t.strip()}

    excl = set(exclude_blobs or ())
    extra = _parse("FFCNN_INT8_EXCLUDE_BLOBS")
    if extra:
        excl |= extra
    only = _parse("FFCNN_INT8_ONLY_BLOBS")
    if only is not None:
        excl |= set(_int8_blobs(ir, min_channels)) - only
    return excl or exclude_blobs


def calibrate(ir: NetIR, params, images, mean=(0.0, 0.0, 0.0),
              norm=(1 / 255.0,) * 3, min_channels: int = 32,
              exclude_blobs: Optional[set] = None,
              percentile: Optional[float] = None,
              per_channel: bool = False, device="cpu") -> QuantPlan:
    """Calibration in one call: the float32 statistics pass on ``device``
    (``params`` there too), then the plan, its tensors on ``device``."""
    images = np.asarray(images)
    if images.ndim == 3:
        images = images[None]
    exclude_blobs = _attribution_exclusions(ir, min_channels, exclude_blobs)
    absmax = collect_blob_absmax(ir, params, images, mean, norm, percentile,
                                 per_channel=per_channel, device=device)
    return build_plan(ir, params, absmax, min_channels, exclude_blobs,
                      device=device)


def save_plan(path: str, plan: QuantPlan) -> None:
    """Write a plan as npz in the JAX package's format (atomic publish), so
    a server restart reuses its calibration."""
    arrays = {"__min_channels": np.asarray([plan.min_channels]),
              "__per_channel": np.asarray([int(plan.per_channel)]),
              "__blobs": np.asarray(sorted(plan.blob_scale))}
    if plan.per_channel:
        for b in sorted(plan.blob_scale):
            arrays[f"bs{b}"] = np.asarray(plan.blob_scale[b], np.float32)
    else:
        arrays["__scales"] = np.asarray(
            [plan.blob_scale[b] for b in sorted(plan.blob_scale)],
            np.float64)  # exact Python-float round trip
    for li, q in plan.weights.items():
        arrays[f"wq{li}"] = q["wq"].cpu().numpy()
        arrays[f"ws{li}"] = q["wscale"].cpu().numpy()
        arrays[f"wb{li}"] = q["bias"].cpu().numpy()
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path) or ".",
                               suffix=".npz")
    os.close(fd)
    np.savez(tmp, **arrays)
    os.replace(tmp, path)


def load_plan(path: str, device="cpu") -> QuantPlan:
    """Read a plan that ``save_plan`` (this package's or the JAX
    package's) wrote; its tensors go to ``device``."""
    data = np.load(path)
    per_channel = ("__per_channel" in data.files
                   and bool(data["__per_channel"][0]))
    if per_channel:
        blob_scale = {int(b): np.asarray(data[f"bs{int(b)}"], np.float32)
                      for b in data["__blobs"]}
    else:
        blob_scale = {int(b): float(s) for b, s in
                      zip(data["__blobs"], data["__scales"])}
    weights = {}
    for name in data.files:
        if name.startswith("wq"):
            li = int(name[2:])
            weights[li] = {
                "wq": torch.from_numpy(data[f"wq{li}"]).to(device),
                "wscale": torch.from_numpy(data[f"ws{li}"]).to(device),
                "bias": torch.from_numpy(data[f"wb{li}"]).to(device)}
            if per_channel:
                weights[li]["xs"] = 1.0
    return QuantPlan(blob_scale=blob_scale, weights=weights,
                     min_channels=int(data["__min_channels"][0]),
                     per_channel=per_channel)


class QuantState:
    """A plan's constants for ``graph.build.forward_features`` at one float
    dtype on one device, made once (``quant_state``): each int8 conv's
    ``kernels.conv_int8.Int8Conv``, and each int8 blob's dequantize scale
    and requantize multiplier, and each int8 route part's rescale, as the
    JAX graph builder's host arithmetic gives them: a Python float (exact
    in the dtype it multiplies) for a per-tensor scale, a tensor on the
    device for a per-channel one."""

    def __init__(self, plan: QuantPlan, ir: NetIR, float_dtype, device):
        from .kernels.conv_int8 import prepare
        from .ops.activations import in_dtype
        self.ir, self.float_dtype = ir, float_dtype
        dev = torch.device(device)
        plan = plan.to(dev)
        self.plan = plan

        def vec(v, dtype):
            return torch.from_numpy(np.asarray(v, np.float32)).to(dev, dtype)

        self.deq: Dict[int, object] = {}
        self.inv: Dict[int, object] = {}
        for bi, s in plan.blob_scale.items():
            if np.ndim(s):
                self.deq[bi] = vec(s, float_dtype)
                self.inv[bi] = vec(1.0 / s, torch.float32)   # float32 /
            else:
                self.deq[bi] = in_dtype(s, float_dtype)
                self.inv[bi] = 1.0 / s                        # float64 /
        self.convs = {}
        for li, q in plan.weights.items():
            l = ir.layers[li]
            out_s = plan.blob_scale.get(li + 1)
            self.convs[li] = prepare(
                q["wq"], q.get("xs", plan.blob_scale[li]), q["wscale"],
                q["bias"], stride=l.stride, pad=l.pad, groups=l.groups,
                act=l.activation, out_scale=out_s)
        # route parts into an int8 blob: (kind, constant) a part, kind
        # "pass" (same scale), "rescale" (codes times r) or "quant" (a
        # float part times its slice's inverse); "store" otherwise
        self.route: Dict[int, list] = {}
        for li, l in enumerate(ir.layers):
            if l.type != LayerType.ROUTE or li + 1 not in plan.blob_scale:
                continue
            if plan.per_channel and l.route_groups > 1:
                continue                    # combined in float, stored once
            s_out, off, parts = plan.blob_scale[li + 1], 0, []
            for d in l.depends:
                bi, c = d + 1, ir.blobs[d + 1].c
                so = s_out[off:off + c] if np.ndim(s_out) else s_out
                if bi in plan.blob_scale:
                    sb = plan.blob_scale[bi]
                    if np.array_equal(np.asarray(sb), np.asarray(so)):
                        parts.append(("pass", None))
                    elif np.ndim(sb) or np.ndim(so):
                        parts.append(("rescale", vec(
                            np.asarray(sb, np.float32)
                            / np.asarray(so, np.float32), torch.float32)))
                    else:
                        parts.append(("rescale", sb / so))
                elif np.ndim(so):
                    parts.append(("quant", vec(1.0 / so, torch.float32)))
                else:
                    parts.append(("store", None))
                off += c
            self.route[li] = parts


def quantize(y: torch.Tensor, inv) -> torch.Tensor:
    """int8 codes clip(round(y * inv), -127, 127) of y in float32, round
    half to even (the JAX graph builder's ``store``)."""
    return torch.clamp(torch.round(y.float() * inv), -127,
                       127).to(torch.int8)


def quant_state(plan: QuantPlan, ir: NetIR, float_dtype,
                device) -> QuantState:
    """The plan's ``QuantState`` for (ir, float dtype, device), made at the
    first ask and kept on the plan (a ``Net`` asks when it installs a
    plan, so no forward makes one)."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:    # "cuda" is "cuda:N"
        dev = torch.device("cuda", torch.cuda.current_device())
    key = (id(ir), float_dtype, dev)
    st = plan.prepared.get(key)
    if st is None or st.ir is not ir:
        st = plan.prepared[key] = QuantState(plan, ir, float_dtype, dev)
    return st


def unfused_int8(net) -> List[int]:
    """The convs of an int8 ``Net``'s plan that run through the int8 conv
    kernel: the plan's quantized convs outside the Net's fused runs."""
    inside = {li for r in net._fused_runs for li in range(r.start, r.end + 1)}
    return sorted(li for li in net.quant.weights if li not in inside)


def conv_shapes(net, distinct: bool = False) -> list:
    """(layer, geometry) of each of ``unfused_int8(net)``: (h, w, c, f, k,
    stride, pad, groups, act, codes out); with ``distinct`` the first
    layer of each geometry only."""
    out, seen = [], set()
    for li in unfused_int8(net):
        b, l = net.ir.blobs[li], net.ir.layers[li]
        geo = (b.h, b.w, b.c, l.fn, l.fs, l.stride, l.pad, l.groups,
               l.activation, li + 1 in net.quant.blob_scale)
        if distinct and geo in seen:
            continue
        seen.add(geo)
        out.append((li, geo))
    return out
