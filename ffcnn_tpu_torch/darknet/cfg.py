"""Darknet ``.cfg`` → :class:`NetIR` graph builder, the port's copy of
``ffcnn_tpu/darknet/cfg.py``.

Replicates the reference parser's observable behavior (``ffcnn.c:114-208``):
section discovery, tolerant key lookup, defaulting rules, shape inference, and
the index conventions for shortcut/route dependencies.  The output is an
immutable IR.

Reference quirks deliberately reproduced (each is visible in real cfgs):
  * ``pad`` is a flag: resolved padding is ``fs//2`` when nonzero (ffcnn.c:145),
    so ``size=1 pad=1`` → 0 px and ``size=5 pad=1`` → 2 px.
  * ``stride``/``groups`` of 0 (or missing) default to 1 (ffcnn.c:140-141).
  * pool output dims are ``floor(w/stride)`` (ffcnn.c:156-157); SPP-style
    stride-1 maxpools keep spatial dims.
  * route indices > 0 are absolute, <= 0 relative to the current layer
    (ffcnn.c:179); shortcut ``from`` is always relative (ffcnn.c:168).
  * input dims override: when the caller passes an image size, the net input
    becomes ``ALIGN(dim, 32)`` (ffcnn.c:133-134).
  * ``[net]`` training keys (batch, momentum, ...) are ignored.
"""

from __future__ import annotations

import os
from typing import List, Optional

from .ctext import align, atof, atoi, parse_param
from .ir import (ACTIVATION_NAMES, Activation, BlobShape, Layer, LayerType,
                 LAYER_TYPE_NAMES, NetIR)


def _split_csv_ints(val: str, limit: int) -> List[int]:
    """C strtok(",") + atoi over a comma-separated value list."""
    out = []
    for tok in val.split(","):
        if tok == "":  # strtok skips empty tokens
            continue
        out.append(atoi(tok))
        if len(out) >= limit:
            break
    return out


def _sections(cfg_text: str):
    """Yield (section_text) windows exactly as the reference scans them:
    from each '[' up to (but excluding) the char before the next '['
    (ffcnn.c:128-129)."""
    pos = cfg_text.find("[")
    while pos >= 0:
        nxt = cfg_text.find("[", pos + 1)
        end = (nxt - 1) if nxt >= 0 else len(cfg_text)
        yield cfg_text[pos:end]
        pos = nxt


def parse_cfg(cfg: str, input_w: int = 0, input_h: int = 0,
              *, is_path: Optional[bool] = None) -> NetIR:
    """Parse Darknet cfg text (or a path to one) into a :class:`NetIR`.

    ``input_w``/``input_h`` mirror the ``net_load(…, inputw, inputh)``
    arguments: nonzero values override the ``[net]`` dims with
    ``ALIGN(value, 32)`` (ffcnn.c:133-134)."""
    if is_path is None:
        is_path = "\n" not in cfg and os.path.exists(cfg)
    if is_path:
        with open(cfg, "r", errors="replace") as f:
            cfg = f.read()

    layers: List[Layer] = []
    blobs: List[BlobShape] = [BlobShape()]
    cfg_w = cfg_h = cfg_c = 0

    for sec in _sections(cfg):
        cur = len(layers)           # index this layer will get
        inp = blobs[cur]            # input blob (output of previous layer)

        if sec.startswith("[net]"):
            cfg_w = atoi(parse_param(sec, "width"))
            cfg_h = atoi(parse_param(sec, "height"))
            cfg_c = atoi(parse_param(sec, "channels"))
            w = align(input_w, 32) if input_w else cfg_w
            h = align(input_h, 32) if input_h else cfg_h
            blobs[0] = BlobShape(w=w, h=h, c=cfg_c)
            continue

        if sec.startswith("[conv]") or sec.startswith("[convolutional]"):
            fn = atoi(parse_param(sec, "filters"))
            fs = atoi(parse_param(sec, "size"))
            stride = atoi(parse_param(sec, "stride")) or 1
            groups = atoi(parse_param(sec, "groups")) or 1
            pad_flag = atoi(parse_param(sec, "pad"))
            bn = bool(atoi(parse_param(sec, "batch_normalize")))
            act = Activation.from_string(parse_param(sec, "activation"))
            pad = fs // 2 if pad_flag else 0            # ffcnn.c:145
            ow = (inp.w - fs + pad * 2) // stride + 1   # ffcnn.c:148
            oh = (inp.h - fs + pad * 2) // stride + 1
            layers.append(Layer(index=cur, type=LayerType.CONV, fn=fn, fs=fs,
                                stride=stride, groups=groups, pad=pad,
                                batchnorm=bn, activation=act))
            blobs.append(BlobShape(w=ow, h=oh, c=fn))

        elif (sec.startswith("[avg]") or sec.startswith("[avgpool]")
              or sec.startswith("[max]") or sec.startswith("[maxpool]")):
            fs = atoi(parse_param(sec, "size"))
            stride = atoi(parse_param(sec, "stride")) or 1
            ltype = (LayerType.AVGPOOL if sec.startswith("[avg")
                     else LayerType.MAXPOOL)
            layers.append(Layer(index=cur, type=ltype, fs=fs, stride=stride))
            blobs.append(BlobShape(w=inp.w // stride, h=inp.h // stride,
                                   c=inp.c))

        elif sec.startswith("[upsample]"):
            stride = atoi(parse_param(sec, "stride")) or 1
            layers.append(Layer(index=cur, type=LayerType.UPSAMPLE,
                                stride=stride))
            blobs.append(BlobShape(w=inp.w * stride, h=inp.h * stride,
                                   c=inp.c))

        elif sec.startswith("[dropout]"):
            layers.append(Layer(index=cur, type=LayerType.DROPOUT))
            blobs.append(inp)

        elif sec.startswith("[shortcut]"):
            frm = atoi(parse_param(sec, "from")) + cur      # ffcnn.c:168
            act = Activation.from_string(parse_param(sec, "activation"))
            layers.append(Layer(index=cur, type=LayerType.SHORTCUT,
                                depends=(frm,), activation=act))
            blobs.append(inp)

        elif sec.startswith("[route]"):
            deps = []
            for dep in _split_csv_ints(parse_param(sec, "layers"), 4):
                deps.append(dep if dep > 0 else cur + dep)  # ffcnn.c:179
            # yolov4-tiny extension (NOT in the reference, which ignores these
            # keys): split each source blob's channels into `groups` and take
            # slice `group_id`.
            rgroups = atoi(parse_param(sec, "groups")) or 1
            rgid = atoi(parse_param(sec, "group_id"))
            oc = sum(blobs[d + 1].c for d in deps) // rgroups
            ow = blobs[deps[-1] + 1].w if deps else 0
            oh = blobs[deps[-1] + 1].h if deps else 0
            layers.append(Layer(index=cur, type=LayerType.ROUTE,
                                depends=tuple(deps), route_groups=rgroups,
                                route_group_id=rgid))
            blobs.append(BlobShape(w=ow, h=oh, c=oc))

        elif sec.startswith("[yolov8]"):
            # Extension: anchor-free DFL head.  The input blob is the concat
            # [4*reg_max box logits | class_num class logits].  ``stride`` =
            # head pixel stride; ``conf`` = score threshold (reuses the
            # ignore_thres slot; ultralytics default 0.25).
            class_num = atoi(parse_param(sec, "classes"))
            reg_max = atoi(parse_param(sec, "reg_max")) or 16
            stride = atoi(parse_param(sec, "stride")) or 1
            conf_val = parse_param(sec, "conf")
            conf = 0.25 if conf_val == "" else atof(conf_val)
            layers.append(Layer(index=cur, type=LayerType.YOLOV8,
                                class_num=class_num, reg_max=reg_max,
                                stride=stride, ignore_thres=conf))
            blobs.append(BlobShape())   # like [yolo]: no output blob

        elif sec.startswith("[yolo]"):
            class_num = atoi(parse_param(sec, "classes"))
            sxy_val = parse_param(sec, "scale_x_y")
            scale_x_y = 1.0 if sxy_val == "" else atof(sxy_val)
            ignore = atof(parse_param(sec, "ignore_thresh"))
            masks = _split_csv_ints(parse_param(sec, "mask"), 9)
            anchor_flat = _split_csv_ints(parse_param(sec, "anchors"), 18)
            pairs = [(anchor_flat[i], anchor_flat[i + 1])
                     for i in range(0, len(anchor_flat) - 1, 2)]
            # Reference hardcodes 3 anchors per head (ffcnn.c:200-203).
            sel = tuple(pairs[masks[i]] for i in range(3)) if len(masks) >= 3 \
                and all(m < len(pairs) for m in masks[:3]) else tuple(pairs[:3])
            layers.append(Layer(index=cur, type=LayerType.YOLO,
                                class_num=class_num, anchors=sel,
                                ignore_thres=ignore, scale_x_y=scale_x_y))
            # Reference never sets the yolo output blob dims (stays zero).
            blobs.append(BlobShape())

        # Unknown sections (e.g. [cost], [region]) are skipped entirely,
        # exactly like ffcnn.c:205 (got_layer = 0).

    return NetIR(layers=tuple(layers), blobs=tuple(blobs),
                 cfg_width=cfg_w, cfg_height=cfg_h, cfg_channels=cfg_c)


def dump(ir: NetIR) -> str:
    """Render the layer table byte-identically to ``net_dump``
    (``ffcnn.c:522-548``) so outputs can be diffed against the reference."""
    lines = ["layer   type  filters fltsize  pad/strd input          output       bn/act"]
    for l in ir.layers:
        i = l.index
        inp, out = ir.blobs[i], ir.blobs[i + 1]
        tname = LAYER_TYPE_NAMES[l.type]
        if l.type == LayerType.YOLOV8:
            # extension layer — no reference format to match; keep the
            # table's column rhythm
            lines.append(
                "%3d %8s class_num: %d reg_max: %d stride: %d conf: %3.2f"
                % (i, tname, l.class_num, l.reg_max, l.stride,
                   l.ignore_thres))
        elif l.type == LayerType.YOLO:
            a = l.anchors
            lines.append(
                "%3d %8s class_num: %d ignore_thres: %3.2f [%d, %d] [%d, %d] [%d, %d]"
                % (i, tname, l.class_num, l.ignore_thres,
                   a[0][0], a[0][1], a[1][0], a[1][1], a[2][0], a[2][1]))
        elif l.type == LayerType.DROPOUT:
            lines.append("%3d %8s %-38s -> %3dx%3dx%3d"
                         % (i, tname, "", out.w, out.h, out.c))
        elif l.type in (LayerType.SHORTCUT, LayerType.ROUTE):
            deps = "layers:" + "".join(" %d" % d for d in l.depends)
            lines.append("%3d %8s %-38s -> %3dx%3dx%3d"
                         % (i, tname, deps, out.w, out.h, out.c))
        else:
            lines.append(
                "%3d %8s %3d/%3d %2dx%2dx%3d   %d/%2d   %3dx%3dx%3d -> %3dx%3dx%3d  %d/%-6s"
                % (i, tname, l.fn, l.groups, l.fs, l.fs,
                   (inp.c // l.groups if l.groups else 0), l.pad, l.stride,
                   inp.w, inp.h, inp.c, out.w, out.h, out.c,
                   int(l.batchnorm), ACTIVATION_NAMES.get(l.activation, "unknown")))
    return "\n".join(lines) + "\n"
