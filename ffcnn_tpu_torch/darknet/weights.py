"""Darknet ``.weights`` reader with load-time BatchNorm folding, the port's
copy of ``ffcnn_tpu/darknet/weights.py``.

File format (reference: ``ffcnn.c:107-112,211-239`` and the spec in the
reference ``readme.txt:77-97``): a 20-byte header (major, minor, revision as
int32 + a uint64 ``net_seen`` sample counter) followed by float32 params for
each *convolutional* layer in graph order:

    bias[fn]
    if batch_normalize: scale[fn], rolling_mean[fn], rolling_variance[fn]
    weights[fn][c/groups][fs][fs]

BatchNorm is folded at load time exactly like the reference (ffcnn.c:229-232):

    scale' = scale / sqrt(var + 1e-5)
    bias'  = bias - mean * scale'

so the conv epilogue everywhere downstream is ``act(sum * scale' + bias')``
(conv-v0.c:27).  Weights are returned as numpy in HWIO layout (fs, fs,
c/groups, fn); ``graph.build.params_from_numpy`` turns them into OIHW
tensors.  For grouped convs the output-channel dim keeps darknet's
group-major filter order, which is the order ``F.conv2d``'s ``groups``
expects.
"""

from __future__ import annotations

import dataclasses
import struct
from typing import Dict, Tuple

import numpy as np

from .ir import LayerType, NetIR

HEADER_BYTES = 20  # 3 * int32 + 1 * uint64 (ffcnn.c:107-112)


@dataclasses.dataclass
class FoldedConvParams:
    """Per-conv-layer folded parameters."""
    weights: np.ndarray   # (fs, fs, c_in/groups, fn)  HWIO
    scale: np.ndarray     # (fn,)  BN scale folded, or ones
    bias: np.ndarray      # (fn,)  bias with BN mean folded in


@dataclasses.dataclass
class WeightsHeader:
    major: int
    minor: int
    revision: int
    seen: int


def load_weights(ir: NetIR, path_or_bytes, *, allow_mismatch: bool = False,
                 ) -> Tuple[Dict[int, FoldedConvParams], WeightsHeader]:
    """Read a .weights file for graph *ir*; returns ``{layer_index: params}``.

    Unlike the reference (which silently runs with zero weights on a missing
    or short file, ffcnn.c:213-238), this validates that the file contains
    exactly the float count the graph requires and raises on mismatch unless
    ``allow_mismatch`` is set."""
    if isinstance(path_or_bytes, (bytes, bytearray)):
        raw = bytes(path_or_bytes)
    else:
        with open(path_or_bytes, "rb") as f:
            raw = f.read()

    if len(raw) < HEADER_BYTES:
        raise ValueError(f"weights file too short: {len(raw)} bytes")
    major, minor, revision = struct.unpack_from("<iii", raw, 0)
    (seen,) = struct.unpack_from("<Q", raw, 12)
    header = WeightsHeader(major, minor, revision, seen)

    floats = np.frombuffer(raw, dtype="<f4", offset=HEADER_BYTES)
    expected = ir.darknet_file_floats()
    if floats.size != expected and not allow_mismatch:
        raise ValueError(
            f"weights file has {floats.size} floats but the graph needs "
            f"{expected} (file/corruption or cfg mismatch)")

    params: Dict[int, FoldedConvParams] = {}
    pos = 0

    def take(n: int) -> np.ndarray:
        nonlocal pos
        if pos + n > floats.size:
            raise ValueError("weights file truncated mid-layer")
        out = floats[pos:pos + n]
        pos += n
        return out

    for layer in ir.layers:
        if layer.type != LayerType.CONV:
            continue
        fn = layer.fn
        icg = ir.blobs[layer.index].c // layer.groups
        bias = take(fn).astype(np.float32).copy()
        if layer.batchnorm:
            scale = take(fn).astype(np.float32).copy()
            mean = take(fn).astype(np.float32)
            var = take(fn).astype(np.float32)
            # ffcnn.c:230-231 — float32 arithmetic, sqrt in double then cast.
            denom = np.sqrt((var + np.float32(1e-5)).astype(np.float64))
            scale = (scale / denom.astype(np.float32)).astype(np.float32)
            bias = (bias - mean * scale).astype(np.float32)
        else:
            scale = np.ones(fn, dtype=np.float32)
        w = take(fn * icg * layer.fs * layer.fs)
        # darknet layout (fn, icg, fs, fs) → HWIO (fs, fs, icg, fn)
        w = w.reshape(fn, icg, layer.fs, layer.fs).transpose(2, 3, 1, 0)
        params[layer.index] = FoldedConvParams(
            weights=np.ascontiguousarray(w, dtype=np.float32),
            scale=scale, bias=bias)

    return params, header


def synth_weights_bytes(ir: NetIR, seed: int = 0, scale: float = 0.05,
                        obj_bias: float = 0.0) -> bytes:
    """Synthesize a VALID darknet .weights file for graph *ir* (random
    gaussian params, the same bytes as the JAX package's for the same seed).
    Lets every model family run end to end without trained weights.

    ``obj_bias`` is added to the objectness channel (4::5+classes) of each
    conv feeding a yolo layer so synthetic nets emit above-threshold boxes."""
    rng = np.random.RandomState(seed)
    head_convs = {}
    for li, layer in enumerate(ir.layers):
        if layer.type == LayerType.YOLO and li > 0:
            src = ir.layers[li - 1]
            if src.type == LayerType.CONV:
                head_convs[li - 1] = layer.class_num
    out = [struct.pack("<iiiQ", 0, 2, 5, 0)]
    for layer in ir.layers:
        if layer.type != LayerType.CONV:
            continue
        fn = layer.fn
        icg = ir.blobs[layer.index].c // layer.groups
        bias = rng.normal(0, scale, fn).astype(np.float32)
        if layer.index in head_convs:
            nc = head_convs[layer.index]
            bias[4::5 + nc] += np.float32(obj_bias)
        out.append(bias.tobytes())
        if layer.batchnorm:
            out.append((rng.rand(fn).astype(np.float32) * 0.5 + 0.75).tobytes())
            out.append(rng.normal(0, scale, fn).astype(np.float32).tobytes())
            out.append((rng.rand(fn).astype(np.float32) * 0.5 + 0.5).tobytes())
        # He-style fan-in scaling keeps activations O(1) at any depth —
        # synthetic nets must not blow up through 100+ layer graphs.
        wstd = 0.7 / np.sqrt(layer.fs * layer.fs * icg)
        out.append(rng.normal(0, wstd, fn * icg * layer.fs * layer.fs)
                   .astype(np.float32).tobytes())
    return b"".join(out)


def zero_weights(ir: NetIR) -> Dict[int, FoldedConvParams]:
    """All-zero params with scale=1 — mirrors the reference's behavior when
    the weights file is absent (calloc'd buffer, scale written as 1.0 at
    ffcnn.c:222).  Useful for shape tests without real weights."""
    params: Dict[int, FoldedConvParams] = {}
    for layer in ir.layers:
        if layer.type != LayerType.CONV:
            continue
        icg = ir.blobs[layer.index].c // layer.groups
        params[layer.index] = FoldedConvParams(
            weights=np.zeros((layer.fs, layer.fs, icg, layer.fn), np.float32),
            scale=np.ones(layer.fn, np.float32),
            bias=np.zeros(layer.fn, np.float32))
    return params
