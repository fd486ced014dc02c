"""Fused yolo-head chains (K7): the stride-1 [dw, pw, ...] conv chain that
feeds a yolo layer, in one launch, every interior map kept on chip.  Holds
the planner (pure IR code), the CUDA kernel's launch plan and wrapper, and
its plain PyTorch version.

Replaces ``ffcnn_tpu/kernels/head_fused.py::_make_kernel`` (launched by
``apply_head_run``).  The kernel (``csrc/head_fused.cu``) runs the pointwise
stages on the tensor cores and keeps each interior map in one of two
float32 stage buffers in shared memory.  ``plan`` picks its launch: a
cluster of two CTAs an image, each owning half the rows, while the batch
leaves SMs idle, else one; and, where the stage buffers of a CTA's rows do
not fit its 227 KB (xl at 416x416 with one CTA an image, 19x19 maps), a
per-image scratch in device memory, where they stay in L2, so that every
chain the planner gives runs.  ``check_fits`` refuses only what the kernel
cannot take at all, when a CUDA ``Net`` is built.

The TPU's batch chunk (``CHUNK``, ``nc``) and its batch and backend gate
(``head_runs_usable``) do not apply: the kernel takes every batch size.  The
planner keeps the TPU's VMEM test (``_fits``) only so that both packages
plan the same runs.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import List, Tuple

import torch

from ..darknet.ir import LayerType, NetIR
from ..ops.activations import activate
from . import _build, _library

# The JAX planner's per-chunk VMEM test, kept so both packages plan the same
# runs (images per chunk it tries, and its f32 budget).
_TPU_CHUNKS = (128, 64)
_TPU_VMEM_BUDGET = 72 << 20
# As csrc/head_fused.cu: a CTA's shared memory on sm_90 (kMaxSmem), the
# stages, pointwise output channels and depthwise kernel sizes it takes
# (kMaxStages, kMaxPwOut), the pointwise input channels of a weight chunk
# (kKC) and the weight chunks it holds at once (kRing).
MAX_SMEM = 232448
MAX_STAGES = 8
MAX_PW_OUT = 256
DW_SIZES = (3, 5)
KC = 32
RING = 2


@dataclasses.dataclass(frozen=True)
class HeadRun:
    """Fused chain of conv layers ``start..end`` (inclusive); layer
    ``end + 1`` is the consuming yolo layer.  Interior blobs
    ``start+1..end`` never materialise."""
    start: int
    end: int


def plan_head_runs(ir: NetIR) -> List[HeadRun]:
    """Walk back from each yolo layer over stride-1 pw (groups 1) and
    depthwise (fs 3 or 5) convs until a blob with outside consumers, as
    ``ffcnn_tpu/kernels/head_fused.py::plan_head_runs`` does; chains of at
    least two layers that pass the TPU's VMEM test become runs."""
    referenced = set()
    for l in ir.layers:
        if l.type in (LayerType.ROUTE, LayerType.SHORTCUT):
            referenced.update(d + 1 for d in l.depends)

    runs: List[HeadRun] = []
    for yli, yl in enumerate(ir.layers):
        if yl.type != LayerType.YOLO:
            continue
        end = yli - 1
        li = end
        while li >= 0:
            l = ir.layers[li]
            blob_in = ir.blobs[li]
            pw = (l.type == LayerType.CONV and l.fs == 1 and l.stride == 1
                  and l.groups == 1 and l.pad == 0)
            dw = (l.type == LayerType.CONV and l.fs in (3, 5)
                  and l.stride == 1 and l.groups == l.fn
                  and l.groups == blob_in.c and l.pad == l.fs // 2)
            if not (pw or dw):
                break
            if li != end and li + 1 in referenced:
                # this layer's output blob is read elsewhere: it must
                # materialise, so the chain starts no earlier than li + 1
                break
            li -= 1
        start = li + 1
        if end - start + 1 >= 2:
            h, w = ir.blobs[start].h, ir.blobs[start].w
            if any(_fits(ir, start, end, h, w, nc) for nc in _TPU_CHUNKS):
                runs.append(HeadRun(start=start, end=end))
    return runs


def _fits(ir: NetIR, start: int, end: int, h: int, w: int, nc: int) -> bool:
    """The JAX planner's VMEM estimate for ``nc`` images per grid step: the
    worst consecutive (c_in + c_out) stage pair in float32 plus the bf16 in
    and out blocks."""
    pair = max(ir.blobs[li].c + ir.blobs[li + 1].c
               for li in range(start, end + 1))
    s = w * nc
    need = h * (s + 4 * nc) * 4 * pair \
        + h * s * 2 * (ir.blobs[start].c + ir.blobs[end + 1].c)
    return need <= _TPU_VMEM_BUDGET


@dataclasses.dataclass(frozen=True)
class HeadStage:
    """One conv of a chain in the kernel's float32 layouts."""
    kind: str             # "pw" or "dw"
    fs: int
    act: int
    w: torch.Tensor       # pw (Cin, Cout); dw (C, fs*fs) taps row-major
    scale: torch.Tensor   # (Cout,)
    bias: torch.Tensor


@dataclasses.dataclass(frozen=True)
class HeadParams:
    """A chain's stages, in order, and its map size."""
    stages: Tuple[HeadStage, ...]
    h: int
    w: int


def head_params(ir: NetIR, params, run: HeadRun) -> HeadParams:
    """Gather ``run``'s convs from a port params dict (OIHW weights,
    ``graph.build.params_from_numpy``)."""
    stages = []
    for li in range(run.start, run.end + 1):
        l, p = ir.layers[li], params[li]
        w = p["weights"].float()
        if l.fs == 1:
            kind, wk = "pw", w.reshape(w.shape[0], w.shape[1]).t()
        else:
            kind, wk = "dw", w.reshape(w.shape[0], l.fs * l.fs)
        stages.append(HeadStage(kind, l.fs, l.activation, wk.contiguous(),
                                p["scale"].float().contiguous(),
                                p["bias"].float().contiguous()))
    b = ir.blobs[run.start]
    return HeadParams(tuple(stages), b.h, b.w)


def _meta(hp: HeadParams) -> List[int]:
    """5 ints per stage (kind 0 pw / 1 dw, fs, act, cin, cout), the
    kernel's description of the chain."""
    out = []
    for st in hp.stages:
        if st.kind == "pw":
            cin, cout = st.w.shape
            out += [0, 1, st.act, cin, cout]
        else:
            out += [1, st.fs, st.act, st.w.shape[0], st.w.shape[0]]
    return out


def _pad8(c: int) -> int:
    return -(-c // 8) * 8


def _ld_a(k: int) -> int:
    """``ld_a`` in csrc/tf32_mma.cuh: a row stride that A fragments read."""
    return (k + 3) // 8 * 8 + 4


def _ld_b(n: int) -> int:
    """``ld_b`` in csrc/tf32_mma.cuh: a row stride that B fragments read."""
    return (n + 7) // 16 * 16 + 8


def _layout(hp: HeadParams) -> Tuple[int, int]:
    """(row stride of a stage buffer, floats of the weight region), as
    ``layout`` in ``csrc/head_fused.cu``: the buffers hold the input and
    every interior map, channels padded to 8; the weight region holds
    ``RING`` pointwise chunks of ``KC`` input channels or a depthwise
    stage's taps."""
    meta = _meta(hp)
    cbuf = max([meta[3]] + meta[4:-5:5])
    wfl = max(RING * KC * _ld_b(_pad8(m[4])) if m[0] == 0
              else m[3] * m[1] ** 2
              for m in (meta[i:i + 5] for i in range(0, len(meta), 5)))
    return _ld_a(_pad8(cbuf)), wfl


@dataclasses.dataclass(frozen=True)
class HeadPlan:
    """One launch of K7: CTAs an image (1 or 2), image rows a CTA owns
    (CTA r the rows from ``r * rows``), dynamic shared memory a CTA in
    bytes, and float32s of device scratch an image (0 where the stage
    buffers fit shared memory)."""
    cluster: int
    rows: int
    smem: int
    scratch: int


def plan(hp: HeadParams, n: int, sms: int) -> HeadPlan:
    """K7's launch for ``n`` images on a card of ``sms`` SMs.  A CTA of K7
    has an SM to itself, so while ``2n <= sms`` (and the map has two rows)
    a cluster of two CTAs an image puts SMs to work that one CTA an image
    leaves idle, as K5's ``mega_cluster``.  Each CTA keeps the two stage
    buffers of its rows in shared memory beside the weight region; where
    they do not fit, the image's buffers go to device scratch and shared
    memory holds the weight region alone."""
    cluster = 2 if hp.h >= 2 and 2 * n <= sms else 1
    rows = -(-hp.h // cluster)
    ld, wfl = _layout(hp)
    smem = 4 * (2 * rows * hp.w * ld + wfl)
    if smem <= MAX_SMEM:
        return HeadPlan(cluster, rows, smem, 0)
    return HeadPlan(cluster, rows, 4 * wfl, 2 * hp.h * hp.w * ld)


def check_fits(hp: HeadParams) -> None:
    """Raise for a chain the kernel cannot take (``Net`` asks once, when it
    is built on the card; the kernel's C entry refuses such a chain at
    launch too): more than 8 stages, a pointwise stage wider than 256
    channels, a depthwise kernel other than 3x3 or 5x5 (the planner gives
    no other), or a weight region over a CTA's shared memory.  A chain
    whose stage buffers do not fit shared memory runs with them in device
    memory."""
    _, wfl = _layout(hp)
    widest = max((st.w.shape[1] for st in hp.stages if st.kind == "pw"),
                 default=0)
    if len(hp.stages) > MAX_STAGES or widest > MAX_PW_OUT \
            or 4 * wfl > MAX_SMEM \
            or any(st.fs not in DW_SIZES for st in hp.stages
                   if st.kind == "dw"):
        raise ValueError(f"head chain at {hp.h}x{hp.w} ({len(hp.stages)} "
                         f"stages, weight region {4 * wfl} bytes) is more "
                         f"than the kernel takes: {MAX_STAGES} stages, "
                         f"{MAX_PW_OUT} pointwise outputs, depthwise "
                         f"{DW_SIZES}, {MAX_SMEM} bytes")


def head_plain(x: torch.Tensor, hp: HeadParams) -> torch.Tensor:
    """The chain in plain PyTorch, NHWC in and out, float32 inside with
    float32 weights and one cast at the end: what ``_make_kernel``
    computes."""
    y = x.float()
    for st in hp.stages:
        if st.kind == "pw":
            y = torch.matmul(y, st.w)
        else:
            n, h, w, _ = y.shape
            r = st.fs // 2
            yp = torch.nn.functional.pad(y, (0, 0, r, r, r, r))
            acc = torch.zeros_like(y)
            for dy in range(st.fs):
                for dx in range(st.fs):
                    acc = acc + (yp[:, dy:dy + h, dx:dx + w]
                                 * st.w[:, dy * st.fs + dx])
            y = acc
        y = activate(y * st.scale + st.bias, st.act)
    return y.to(x.dtype)


def _rebuild(x, w, scale, bias, meta) -> HeadParams:
    """The HeadParams an op's flattened arguments describe, at x's map."""
    stages = tuple(HeadStage("pw" if meta[5 * i] == 0 else "dw",
                             meta[5 * i + 1], meta[5 * i + 2], w[i],
                             scale[i], bias[i]) for i in range(len(w)))
    return HeadParams(stages, x.shape[1], x.shape[2])


def _head_cuda(x, w, scale, bias, meta):
    hp = _rebuild(x, w, scale, bias, meta)
    if (x.device.type != "cuda" or x.dim() != 4 or not x.is_contiguous()
            or x.dtype not in (torch.float32, torch.bfloat16)
            or x.shape[3] != meta[3]):
        raise ValueError(f"x must be a contiguous (N, H, W, {meta[3]}) "
                         f"float32/bfloat16 CUDA tensor, got {x.dtype} "
                         f"{tuple(x.shape)} on {x.device}")
    for st in hp.stages:
        for t in (st.w, st.scale, st.bias):
            if t.device != x.device or t.dtype != torch.float32 \
                    or not t.is_contiguous():
                raise ValueError(f"head weights must be contiguous float32 "
                                 f"on {x.device}, got {t.dtype} on "
                                 f"{t.device}")
    n, ns = x.shape[0], len(hp.stages)
    y = torch.empty((n, hp.h, hp.w, meta[-1]), dtype=x.dtype,
                    device=x.device)
    p = plan(hp, n, _build.sm_count(x.device))
    scratch = torch.empty((n, p.scratch), dtype=torch.float32,
                          device=x.device) if p.scratch else None
    ptrs = [(ctypes.c_void_p * ns)(*(getattr(st, name).data_ptr()
                                     for st in hp.stages))
            for name in ("w", "scale", "bias")]
    lib = build()
    err = lib.ffcnn_head(x.data_ptr(), y.data_ptr(),
                         None if scratch is None else scratch.data_ptr(),
                         int(x.dtype == torch.bfloat16), n, hp.h, hp.w, ns,
                         (ctypes.c_int * len(meta))(*meta), *ptrs,
                         p.cluster, _build.stream_ptr())
    apply_head_run.launches += 1
    if err:
        raise RuntimeError("head chain launch failed: "
                           + lib.ffcnn_head_error_string(err).decode())
    return y


HEAD_OP = _library.define(
    "head_run(Tensor x, Tensor[] w, Tensor[] scale, Tensor[] bias, "
    "int[] meta) -> Tensor",
    cpu=lambda x, w, scale, bias, meta: head_plain(
        x, _rebuild(x, w, scale, bias, meta)),
    cuda=_head_cuda,
    fake=lambda x, w, scale, bias, meta: x.new_empty(
        (*x.shape[:3], meta[-1])))


def apply_head_run(x: torch.Tensor, run: HeadRun,
                   hp: HeadParams) -> torch.Tensor:
    """NHWC input blob of layer ``run.start`` -> NHWC head tensor of blob
    ``run.end + 1``, in x's dtype, through ``ffcnn::head_run``.  ``hp``:
    the run's ``head_params``, prepared once.

    CPU tensors take ``head_plain``; CUDA tensors launch the kernel."""
    if len(hp.stages) != run.end - run.start + 1:
        raise ValueError(f"{len(hp.stages)} stages for run {run}")
    if x.dim() != 4 or tuple(x.shape[1:3]) != (hp.h, hp.w):
        raise ValueError(f"x must be (N, {hp.h}, {hp.w}, C), got "
                         f"{tuple(x.shape)}")
    return HEAD_OP(x, [st.w for st in hp.stages],
                   [st.scale for st in hp.stages],
                   [st.bias for st in hp.stages], _meta(hp))


apply_head_run.launches = 0


@functools.cache
def build() -> ctypes.CDLL:
    """Build (if needed) and load the kernel's library."""
    lib = _build.load_library("head_fused")
    lib.ffcnn_head.argtypes = ([ctypes.c_void_p] * 3
                               + [ctypes.c_int] * 5
                               + [ctypes.POINTER(ctypes.c_int)]
                               + [ctypes.POINTER(ctypes.c_void_p)] * 3
                               + [ctypes.c_int, ctypes.c_void_p])
    lib.ffcnn_head.restype = ctypes.c_int
    lib.ffcnn_head_error_string.argtypes = [ctypes.c_int]
    lib.ffcnn_head_error_string.restype = ctypes.c_char_p
    return lib

