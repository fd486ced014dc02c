"""Typed intermediate representation for Darknet graphs, the port's copy of
``ffcnn_tpu/darknet/ir.py`` (same names, same values, same fields).

The reference stores both layer params and blob metadata in one mutable
``LAYER`` array (``ffcnn.h:16-27``): entry *i* holds layer *i*'s params plus
the dims of layer *i*'s **input** blob, and entry *i+1* holds its output dims.
Here the two are separate: an immutable per-layer descriptor (this module)
and a blob-shape table.  Shape-inference rules are replicated from
``ffcnn.c:128-208`` (see cfg.py).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Tuple


class LayerType(enum.IntEnum):
    # Same order as the reference enum (ffcnn.h:4-14) so dump tables match.
    CONV = 0
    AVGPOOL = 1
    MAXPOOL = 2
    UPSAMPLE = 3
    DROPOUT = 4
    SHORTCUT = 5
    ROUTE = 6
    YOLO = 7
    # Extension beyond the reference: the anchor-free YOLOv8 detect head
    # (DFL box regression + per-class sigmoid scores).  The port parses it
    # and refuses to run it (not ported yet).
    YOLOV8 = 8


class Activation(enum.IntEnum):
    # utils.h:8-13
    LINEAR = 0
    RELU = 1
    LEAKY = 2
    SIGMOID = 3
    # Extensions beyond the reference (yolov4-family support):
    MISH = 4
    LOGISTIC = 5
    SWISH = 6

    @staticmethod
    def from_string(s: str) -> int:
        """Reference get_activation_type_int (ffcnn.c:86-93): prefix match
        against {linear, relu, leaky}; unknown strings map to -1 which the
        activate() switch treats as linear.  Extended names are matched only
        exactly so reference behavior is unchanged for reference inputs."""
        for name, val in (("linear", 0), ("relu", 1), ("leaky", 2)):
            if s.startswith(name):
                return val
        ext = {"mish": Activation.MISH, "logistic": Activation.LOGISTIC,
               "swish": Activation.SWISH, "silu": Activation.SWISH}
        if s.strip() in ext:
            return int(ext[s.strip()])
        return -1  # ffcnn.c:92 — falls through to linear in activate()


ACTIVATION_NAMES = {0: "linear", 1: "relu", 2: "leaky", 3: "sigmoid",
                    4: "mish", 5: "logistic", 6: "swish", -1: "unknown"}

LAYER_TYPE_NAMES = {
    LayerType.CONV: "conv", LayerType.AVGPOOL: "avgpool",
    LayerType.MAXPOOL: "maxpool", LayerType.UPSAMPLE: "upsample",
    LayerType.DROPOUT: "dropout", LayerType.SHORTCUT: "shortcut",
    LayerType.ROUTE: "route", LayerType.YOLO: "yolo",
    LayerType.YOLOV8: "yolov8",
}


@dataclasses.dataclass(frozen=True)
class BlobShape:
    """Dims of one activation blob, in the reference's (w, h, c) convention.
    Blob i is the input of layer i and the output of layer i-1 (ffcnn.c:123)."""
    w: int = 0
    h: int = 0
    c: int = 0

    @property
    def nhwc(self) -> Tuple[int, int, int]:
        return (self.h, self.w, self.c)

    def numel(self) -> int:
        return self.w * self.h * self.c


@dataclasses.dataclass(frozen=True)
class Layer:
    """One Darknet layer.  Field semantics follow ffcnn.h:16-27; only fields
    meaningful for the layer type are populated."""
    index: int
    type: LayerType
    # conv / pool / upsample params
    fn: int = 0            # number of filters
    fs: int = 0            # filter (window) size
    stride: int = 1
    groups: int = 1
    pad: int = 0           # resolved pixels of padding (ffcnn.c:145)
    batchnorm: bool = False
    activation: int = int(Activation.LINEAR)
    # shortcut / route dependencies: absolute layer indices (blob = idx + 1)
    depends: Tuple[int, ...] = ()
    route_groups: int = 1      # yolov4 'groups' extension (not in reference)
    route_group_id: int = 0
    # yolo params (ffcnn.h:24-26)
    class_num: int = 0
    anchors: Tuple[Tuple[int, int], ...] = ()
    ignore_thres: float = 0.0
    scale_x_y: float = 1.0
    # yolov8 head params (extension): DFL bin count per box side.  The
    # head's pixel stride reuses ``stride``; the confidence threshold
    # reuses ``ignore_thres``.
    reg_max: int = 0


@dataclasses.dataclass(frozen=True)
class NetIR:
    """Parsed network: layer list + blob-shape table (len = layers + 1)."""
    layers: Tuple[Layer, ...]
    blobs: Tuple[BlobShape, ...]
    cfg_width: int = 0      # [net] declared dims (pre-ALIGN override)
    cfg_height: int = 0
    cfg_channels: int = 0

    @property
    def input_shape(self) -> BlobShape:
        return self.blobs[0]

    @property
    def yolo_layers(self) -> Tuple[Layer, ...]:
        return tuple(l for l in self.layers if l.type == LayerType.YOLO)

    def weight_size_floats(self) -> int:
        """Reference weight_buf float count (ffcnn.c:150)."""
        from .ctext import align
        total = 0
        for l in self.layers:
            if l.type == LayerType.CONV:
                icg = self.blobs[l.index].c // l.groups
                total += l.fn * (align(l.fs * l.fs * icg, 4) + 4)
        return total

    def darknet_file_floats(self) -> int:
        """Exact float count a well-formed .weights file must contain."""
        total = 0
        for l in self.layers:
            if l.type == LayerType.CONV:
                icg = self.blobs[l.index].c // l.groups
                total += l.fn  # bias
                if l.batchnorm:
                    total += 3 * l.fn  # scale, mean, var
                total += l.fn * icg * l.fs * l.fs
        return total
