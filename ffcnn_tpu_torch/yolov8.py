"""YOLOv8 ingest, the port's copy of ``ffcnn_tpu/yolov8.py``: a YOLOv8
state dict (ultralytics parameter names) -> a darknet-dialect graph and its
``.weights`` bytes, which every entry point of the port then serves as
ordinary model files.

    sd = synthesize_state_dict(80, "n", seed=0)     # or a real state dict
    cfg_text, weights = convert(sd, 80, "n", size=640)
    net = load(sd, 80, "n", size=640, mode="fast")  # on the card

An environment with ultralytics makes the state dict in one line:
``torch.save(YOLO('yolov8n.pt').model.state_dict(), 'yolov8n_sd.pt')``.

Lowering (the architecture re-derived from its public description):

* Conv (conv + BN + SiLU) -> one ``[conv]``, the BN folded here (eps 1e-3,
  the torch module's own; the reference's fold would use 1e-5).
* C2f -> cv1, the two halves as grouped ``[route]`` slices, each bottleneck
  as two 3x3 ``[conv]`` and an optional linear ``[shortcut]``, one concat
  ``[route]`` (cascaded past four sources, the dialect's limit), cv2.
* SPPF -> cv1, three chained stride-1 size-5 ``[max]`` pools, a 4-way
  concat, cv2.
* Detect -> per scale: the box branch (two SiLU convs and a linear 1x1 to
  4 x reg_max), a route back, the class branch (two SiLU convs and a
  linear 1x1 to nc), their concat and a ``[yolov8]`` head, which
  ``ops/yolo.py::decode_head_v8`` decodes (DFL expectation, per-class
  sigmoid); NMS by union IoU.

Detection letterboxes as the reference does (top-left, zero pad), not with
YOLOv8's centred gray-114 letterbox; at the training size with square
inputs the two coincide.
"""

from __future__ import annotations

import math
import struct
from typing import Dict, List, Tuple

import numpy as np
import torch

from .darknet.cfg import parse_cfg
from .darknet.ir import LayerType
from .darknet.weights import load_weights

# (depth_multiple, width_multiple, max_channels) — public YOLOv8 scales.
SCALES = {
    "n": (0.33, 0.25, 1024),
    "s": (0.33, 0.50, 1024),
    "m": (0.67, 0.75, 768),
    "l": (1.00, 1.00, 512),
    "x": (1.00, 1.25, 512),
}
REG_MAX = 16
STRIDES = (8, 16, 32)


def _make_divisible(x: float, d: int = 8) -> int:
    return int(math.ceil(x / d) * d)


class _Emitter:
    """Accumulates cfg sections + the conv weight-packing plan in one
    pass, so the .weights stream order matches the cfg conv order by
    construction."""

    def __init__(self, w: int, h: int, channels: int = 3):
        self.sections: List[str] = [
            f"[net]\nwidth={w}\nheight={h}\nchannels={channels}\n"]
        self.idx = -1                      # index of the last layer emitted
        self.pack: List[Tuple[str, str, int]] = []  # (kind, sd prefix, fn)

    def _add(self, text: str) -> int:
        self.sections.append(text)
        self.idx += 1
        return self.idx

    def conv(self, prefix: str, filters: int, size: int, *, stride: int = 1,
             act: str = "silu", kind: str = "convbn") -> int:
        """``kind``: 'convbn' = torch Conv (conv.weight + bn.*, folded
        here); 'conv2d' = plain torch Conv2d (weight + bias)."""
        pad = 1 if size > 1 else 0
        self.pack.append((kind, prefix, filters))
        return self._add(
            f"[conv]\nfilters={filters}\nsize={size}\nstride={stride}\n"
            f"pad={pad}\nactivation={act}\n")

    def route(self, layers: List[int], groups: int = 1,
              group_id: int = 0) -> int:
        """Concat (cascaded when >4 sources, preserving channel order)."""
        if len(layers) > 4:
            head = self.route(layers[:4])
            return self.route([head] + layers[4:], groups, group_id)
        extra = (f"groups={groups}\ngroup_id={group_id}\n"
                 if groups > 1 else "")
        return self._add(
            "[route]\nlayers=" + ",".join(str(i) for i in layers)
            + "\n" + extra)

    def shortcut(self, frm: int) -> int:
        rel = frm - (self.idx + 1)
        return self._add(f"[shortcut]\nfrom={rel}\nactivation=linear\n")

    def maxpool(self, size: int, stride: int) -> int:
        return self._add(f"[max]\nsize={size}\nstride={stride}\n")

    def upsample(self, stride: int = 2) -> int:
        return self._add(f"[upsample]\nstride={stride}\n")

    def yolov8(self, nc: int, reg_max: int, stride: int,
               conf: float) -> int:
        return self._add(
            f"[yolov8]\nclasses={nc}\nreg_max={reg_max}\nstride={stride}\n"
            f"conf={conf}\n")

    def cfg_text(self) -> str:
        return "\n".join(self.sections)


def _c2f(em: _Emitter, prefix: str, c2: int, n: int,
         shortcut: bool) -> int:
    """C2f block consuming the previous layer's output; returns its
    output layer index."""
    c = c2 // 2
    cv1 = em.conv(f"{prefix}.cv1", 2 * c, 1)
    y1 = em.route([cv1], groups=2, group_id=1)
    parts_tail = []
    prev = y1
    for j in range(n):
        b1 = em.conv(f"{prefix}.m.{j}.cv1", c, 3)
        b2 = em.conv(f"{prefix}.m.{j}.cv2", c, 3)
        prev = em.shortcut(prev) if shortcut else b2
        parts_tail.append(prev)
    y0 = em.route([cv1], groups=2, group_id=0)
    cat = em.route([y0, y1] + parts_tail)
    return em.conv(f"{prefix}.cv2", c2, 1)


def _sppf(em: _Emitter, prefix: str, c1: int, c2: int,
          k: int = 5) -> int:
    cv1 = em.conv(f"{prefix}.cv1", c1 // 2, 1)
    p1 = em.maxpool(k, 1)
    p2 = em.maxpool(k, 1)
    p3 = em.maxpool(k, 1)
    em.route([cv1, p1, p2, p3])
    return em.conv(f"{prefix}.cv2", c2, 1)


def build_graph(nc: int = 80, scale: str = "n", *, size: int = 640,
                reg_max: int = REG_MAX, conf: float = 0.25
                ) -> Tuple[str, List[Tuple[str, str, int]]]:
    """Emit the full YOLOv8-``scale`` cfg text plus the weight-packing
    plan (the converter's and synthesizer's shared ground truth)."""
    depth, width, max_c = SCALES[scale]
    w = lambda c: _make_divisible(min(c, max_c) * width)
    d = lambda n: max(round(n * depth), 1)

    em = _Emitter(size, size)
    l0 = em.conv("model.0", w(64), 3, stride=2)
    l1 = em.conv("model.1", w(128), 3, stride=2)
    l2 = _c2f(em, "model.2", w(128), d(3), True)
    l3 = em.conv("model.3", w(256), 3, stride=2)
    l4 = _c2f(em, "model.4", w(256), d(6), True)          # P3
    l5 = em.conv("model.5", w(512), 3, stride=2)
    l6 = _c2f(em, "model.6", w(512), d(6), True)          # P4
    l7 = em.conv("model.7", w(1024), 3, stride=2)
    l8 = _c2f(em, "model.8", w(1024), d(3), True)
    l9 = _sppf(em, "model.9", w(1024), w(1024))           # P5

    u10 = em.upsample(2)
    c11 = em.route([u10, l6])
    l12 = _c2f(em, "model.12", w(512), d(3), False)
    u13 = em.upsample(2)
    c14 = em.route([u13, l4])
    l15 = _c2f(em, "model.15", w(256), d(3), False)      # P3 out
    l16 = em.conv("model.16", w(256), 3, stride=2)
    c17 = em.route([l16, l12])
    l18 = _c2f(em, "model.18", w(512), d(3), False)      # P4 out
    l19 = em.conv("model.19", w(512), 3, stride=2)
    c20 = em.route([l19, l9])
    l21 = _c2f(em, "model.21", w(1024), d(3), False)     # P5 out

    ch = (w(256), w(512), w(1024))
    c2h = max(16, ch[0] // 4, reg_max * 4)
    c3h = max(ch[0], min(nc, 100))
    det = "model.22"
    for s, (src, stride) in enumerate(zip((l15, l18, l21), STRIDES)):
        if em.idx != src:               # return to this scale's input blob
            src = em.route([src])
        a0 = em.conv(f"{det}.cv2.{s}.0", c2h, 3)
        a1 = em.conv(f"{det}.cv2.{s}.1", c2h, 3)
        box = em.conv(f"{det}.cv2.{s}.2", 4 * reg_max, 1, act="linear",
                      kind="conv2d")
        back = em.route([src])
        b0 = em.conv(f"{det}.cv3.{s}.0", c3h, 3)
        b1 = em.conv(f"{det}.cv3.{s}.1", c3h, 3)
        cls = em.conv(f"{det}.cv3.{s}.2", nc, 1, act="linear",
                      kind="conv2d")
        em.route([box, cls])
        em.yolov8(nc, reg_max, stride, conf)
    return em.cfg_text(), em.pack


def _to_np(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().numpy()
    return np.asarray(v, np.float32)


def pack_weights(pack: List[Tuple[str, str, int]], sd: Dict,
                 bn_eps: float = 1e-3) -> bytes:
    """State dict → darknet .weights bytes following ``pack`` order, BN
    folded here (w' = w * g/sqrt(var+eps); b' = beta - mean * g/sqrt)."""
    out = [struct.pack("<iiiQ", 0, 2, 5, 0)]
    for kind, prefix, fn in pack:
        if kind == "convbn":
            w = _to_np(sd[f"{prefix}.conv.weight"])       # (fn, c, k, k)
            g = _to_np(sd[f"{prefix}.bn.weight"])
            beta = _to_np(sd[f"{prefix}.bn.bias"])
            mean = _to_np(sd[f"{prefix}.bn.running_mean"])
            var = _to_np(sd[f"{prefix}.bn.running_var"])
            s = g / np.sqrt(var + np.float32(bn_eps))
            w = w * s[:, None, None, None]
            bias = beta - mean * s
        else:
            w = _to_np(sd[f"{prefix}.weight"])
            bias = _to_np(sd[f"{prefix}.bias"])
        if w.shape[0] != fn:
            raise ValueError(f"{prefix}: expected {fn} filters, state "
                             f"dict has {w.shape[0]} — wrong scale/nc?")
        out.append(bias.astype("<f4").tobytes())
        out.append(w.astype("<f4").tobytes())   # (fn, c, k, k) = darknet
    return b"".join(out)


def convert(sd: Dict, nc: int = 80, scale: str = "n", *, size: int = 640,
            conf: float = 0.25) -> Tuple[str, bytes]:
    """Ultralytics-named state dict → (cfg text, darknet weights bytes)."""
    cfg, pack = build_graph(nc, scale, size=size, conf=conf)
    return cfg, pack_weights(pack, sd)


def load(sd_or_path, nc: int = 80, scale: str = "n", *, size: int = 640,
         conf: float = 0.25, mode: str = "fast", device="cuda", **kw):
    """One call from a state dict (or the path of a ``torch.save``d plain
    state dict, read with ``weights_only=True``) to a ``Net``, on the card
    unless ``device="cpu"``.  A full ultralytics checkpoint needs the
    ultralytics package to unpickle: save its ``state_dict()`` first."""
    from .net import Net

    if not isinstance(sd_or_path, dict):
        sd_or_path = torch.load(sd_or_path, map_location="cpu",
                                weights_only=True)
        if not isinstance(sd_or_path, dict) or not all(
                hasattr(v, "shape") for v in sd_or_path.values()):
            raise ValueError("expected a plain state dict "
                             "(torch.save(model.state_dict(), path))")
    cfg, weights = convert(sd_or_path, nc, scale, size=size, conf=conf)
    ir = parse_cfg(cfg, is_path=False)
    params, _ = load_weights(ir, weights)
    return Net(ir, params, mode=mode, device=device, **kw)


def synthesize_state_dict(nc: int = 80, scale: str = "n",
                          seed: int = 0) -> Dict[str, np.ndarray]:
    """Random ultralytics-shaped state dict (He-scaled, BN near identity,
    class-head bias ~ -4 so sigmoid scores sit sparsely around the 0.25
    threshold) — drives every YOLOv8 test without shipping real weights,
    like darknet/weights.py::synth_weights_bytes does for the zoo."""
    rng = np.random.RandomState(seed)
    # each conv's input channel count, from the emitted graph
    cfg, pack = build_graph(nc, scale)
    ir = parse_cfg(cfg, is_path=False)
    conv_in = [ir.blobs[l.index].c for l in ir.layers
               if l.type == LayerType.CONV]
    conv_fs = [l.fs for l in ir.layers if l.type == LayerType.CONV]
    sd: Dict[str, np.ndarray] = {}
    for (kind, prefix, fn), cin, fs in zip(pack, conv_in, conv_fs):
        wstd = 0.7 / np.sqrt(fs * fs * cin)
        w = rng.normal(0, wstd, (fn, cin, fs, fs)).astype(np.float32)
        if kind == "convbn":
            sd[f"{prefix}.conv.weight"] = w
            sd[f"{prefix}.bn.weight"] = (rng.rand(fn) * 0.5
                                         + 0.75).astype(np.float32)
            sd[f"{prefix}.bn.bias"] = rng.normal(
                0, 0.05, fn).astype(np.float32)
            sd[f"{prefix}.bn.running_mean"] = rng.normal(
                0, 0.05, fn).astype(np.float32)
            sd[f"{prefix}.bn.running_var"] = (rng.rand(fn) * 0.5
                                              + 0.5).astype(np.float32)
        else:
            sd[f"{prefix}.weight"] = w
            bias = rng.normal(0, 0.05, fn).astype(np.float32)
            if ".cv3." in prefix:       # class head: sparse detections
                bias += np.float32(-4.0) + rng.normal(
                    0, 0.8, fn).astype(np.float32)
            sd[f"{prefix}.bias"] = bias
    return sd


def candidates_fn(ir, size: int):
    """The pure-v8 pre-NMS candidate program: ``fn(params, images)`` with
    the port's ``Params`` and uint8 (N, size, size, 3) BGR images, both on
    one device -> the decoded candidates of every head in grid order (no
    sort, no NMS: the comparison surface without ties).  Letterbox, the
    float32 forward (cuDNN's TF32 off on the card) and ``decode_head_v8``,
    as ``ffcnn_tpu/yolov8.py::candidates_fn``."""
    from .graph.build import forward_features
    from .net import _tf32
    from .ops.preprocess import letterbox
    from .ops.yolo import concat_heads, decode_head_v8

    heads_meta = [l for l in ir.layers if l.type == LayerType.YOLOV8]

    def fn(p, im):
        with _tf32(False):
            feats = forward_features(
                ir, p, letterbox(im, size, size, dtype=torch.float32))
        return concat_heads([decode_head_v8(f, l, size, size)
                             for f, l in zip(feats, heads_meta)])

    return fn
