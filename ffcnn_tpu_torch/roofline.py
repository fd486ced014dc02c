"""Static device-memory traffic and FLOP roofline for a parsed net, the port
of ``ffcnn_tpu/roofline.py``.  From the IR alone (no device, no weights) it
computes:

  * per-layer device-memory bytes: dense activations (each blob written
    once by its producer and read once by each reader) plus the layer's
    weights;
  * per-layer FLOPs (2 x MACs): dense convs (``flops``, fit for the bf16
    tensor cores) and depthwise convs (``vpu_flops``, float32 taps on the
    CUDA cores; the name is the JAX package's);
  * the implied time floors: bytes over the memory rate, each kind of FLOP
    over its peak; a layer cannot run faster than the slowest of them.

It knows the execution plan: blobs interior to a fused run (a block run,
``kernels/block_fused.py``, or a head chain, ``kernels/head_fused.py``)
move nothing; the run pays one read at its input and one write at its
output.  Everything else is written once and read by each reader: the
port runs every other conv through cuDNN, which writes its output, so the
JAX package's model of XLA's one-deep conv input fusion has no counterpart
here.  A K6 stem writes blob 1, which the run at layer 1 reads, as the
plain model says.

The constants are one H100 SXM's published peaks at 700 W (NVIDIA's data
sheet; dense): 3.35 TB/s of HBM, 989 TFLOP/s bf16 and 1,979 TOP/s int8 on
the tensor cores, 67 TFLOP/s float32 outside them; and its int32 rate on
the CUDA cores, which the data sheet does not list (see ``INT32_OP_S``).
``bench_block.Work.bound`` reads the same constants.  Pass your own for
another card.

An int8 plan (``quant``) stores its int8 blobs and its quantized convs'
weights at one byte, and prices the convs that run in int8 (the int8 conv
kernel, outside the fused runs) at the int8 rates: dense ones on the
tensor cores (``int8_ops``), depthwise ones on the CUDA cores
(``int8_vpu_ops``).

Used by ``Net.roofline_costs``/``Net.profile_layers`` (floor columns),
``cli roofline``/``cli profile`` and the bench's ``mfu``.
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

from .darknet.ir import LayerType, NetIR

# One H100 SXM's published peaks (NVIDIA's data sheet; dense, at the full
# 700 W): device memory, bf16 on the tensor cores, float32 on the CUDA
# cores.
HBM_BYTES_S = 3.35e12
TC_BF16_FLOP_S = 989e12
TC_INT8_OP_S = 1979e12
F32_FLOP_S = 67e12
# int32 multiply-adds on the CUDA cores (a depthwise int8 conv): 64 int32
# lanes an SM a clock (the Hopper architecture white paper: 16 INT32 units
# in each of an SM's four partitions), 132 SMs at the H100 SXM's 1,980 MHz
# boost clock, a multiply-add counted as two operations.
INT32_OP_S = 132 * 64 * 2 * 1.98e9
HBM_GBPS = HBM_BYTES_S / 1e9
TC_TFLOPS_BF16 = TC_BF16_FLOP_S / 1e12
TC_TOPS_INT8 = TC_INT8_OP_S / 1e12
F32_TFLOPS = F32_FLOP_S / 1e12
INT32_TOPS = INT32_OP_S / 1e12

_BYTES = {"bf16": 2, "f32": 4, "uint8": 1, "int8": 1}


def stored_bytes(w: int, h: int, c: int, batch: int, dtype: str) -> int:
    """Device-memory bytes of one dense (batch, h, w, c) activation."""
    return w * h * c * _BYTES[dtype] * batch


@dataclasses.dataclass
class LayerCost:
    index: int
    bytes_act: int                 # activation reads + writes
    bytes_w: int                   # weights read (per dispatch)
    flops: int                     # 2 x MACs of dense convs (tensor cores)
    vpu_flops: int = 0             # 2 x MACs of depthwise convs (float32)
    int8_ops: int = 0              # 2 x MACs of int8 dense convs (tensor
    #                                cores), an int8 plan's
    int8_vpu_ops: int = 0          # 2 x MACs of int8 depthwise convs
    #                                (int32 on the CUDA cores)

    @property
    def bytes_total(self) -> int:
        return self.bytes_act + self.bytes_w

    def hbm_floor_us(self, gbps: float = HBM_GBPS) -> float:
        return self.bytes_total / gbps / 1e3

    def mxu_floor_us(self, tflops: float = TC_TFLOPS_BF16) -> float:
        """The dense FLOPs at the tensor-core rate."""
        return self.flops / tflops / 1e6

    def vpu_floor_us(self, tflops: float = F32_TFLOPS) -> float:
        """The depthwise FLOPs at the float32 rate."""
        return self.vpu_flops / tflops / 1e6

    def int8_floor_us(self, tops: float = TC_TOPS_INT8,
                      vpu_tops: float = INT32_TOPS) -> float:
        """The int8 conv operations at their rates, the two in turn."""
        return (self.int8_ops / tops + self.int8_vpu_ops / vpu_tops) / 1e6

    def floor_us(self, gbps: float = HBM_GBPS,
                 tflops: float = TC_TFLOPS_BF16,
                 vpu_tflops: float = F32_TFLOPS) -> float:
        """A layer cannot run faster than its slowest bound."""
        return max(self.hbm_floor_us(gbps), self.mxu_floor_us(tflops),
                   self.vpu_floor_us(vpu_tflops), self.int8_floor_us())


def _conv_flops(ir: NetIR, li: int, batch: int) -> int:
    l = ir.layers[li]
    ob = ir.blobs[li + 1]
    icg = ir.blobs[li].c // l.groups
    return 2 * batch * ob.w * ob.h * ob.c * l.fs * l.fs * icg


def layer_costs(ir: NetIR, batch: int, dtype: str = "bf16",
                fused_runs=None, quant=None,
                store_dtype: Optional[str] = None) -> List[LayerCost]:
    """Per-layer traffic/FLOP model for one batch dispatch.

    ``fused_runs``: runs with ``start``/``end`` (block runs and head chains)
    -- blobs interior to a run move nothing; the run's input read is
    attributed to its first layer and its output write to its last.
    ``store_dtype``: dtype of run boundary blobs (``FFCNN_FUSED_STORE``;
    defaults to ``dtype``).  ``quant``: an int8 plan, as in the JAX model:
    its int8 blobs and quantized weights at one byte; and (the port's
    addition) the quantized convs outside the runs, which run in int8,
    priced in ``int8_ops``/``int8_vpu_ops`` instead of ``flops``/
    ``vpu_flops``."""
    store_dtype = store_dtype or dtype
    interior: Dict[int, object] = {}
    for r in (fused_runs or []):
        for li in range(r.start, r.end + 1):
            interior[li] = r

    def blob_bytes(bi: int, at_run_edge: bool = False) -> int:
        b = ir.blobs[bi]
        if b.c == 0:
            return 0
        if quant is not None and quant.blob_is_int8(bi):
            bdt = "int8"
        else:
            bdt = "uint8" if bi == 0 else (store_dtype if at_run_edge
                                           else dtype)
        return stored_bytes(b.w, b.h, b.c, batch, bdt)

    def weight_bytes(li: int) -> int:
        l = ir.layers[li]
        if l.type != LayerType.CONV:
            return 0
        icg = ir.blobs[li].c // l.groups
        n = l.fs * l.fs * icg * l.fn
        if quant is not None and li in quant.weights:
            return n + 4 * l.fn * 2        # int8, float32 scale and bias
        return n * (2 if dtype == "bf16" else 4) + 4 * l.fn * 2

    out: List[LayerCost] = []
    for li, l in enumerate(ir.layers):
        flops = vpu = 0
        if l.type == LayerType.CONV:
            f = _conv_flops(ir, li, batch)
            # depthwise (one input channel per output channel) has nothing
            # to contract: float32 taps, not the tensor cores
            if l.groups > 1 and ir.blobs[li].c // l.groups == 1:
                vpu = f
            else:
                flops = f
            if quant is not None and li in quant.weights \
                    and li not in interior:
                out.append(LayerCost(
                    li, blob_bytes(li) + blob_bytes(li + 1),
                    weight_bytes(li), 0, 0, flops, vpu))
                continue
        if li in interior:
            run = interior[li]
            acts = 0
            if li == run.start:
                acts += blob_bytes(run.start, at_run_edge=True)
            if li == run.end:
                acts += blob_bytes(run.end + 1, at_run_edge=True)
            out.append(LayerCost(li, acts, weight_bytes(li), flops, vpu))
            continue
        if l.type in (LayerType.YOLO, LayerType.YOLOV8):
            out.append(LayerCost(li, blob_bytes(li), 0, 0))
            continue
        if l.type == LayerType.DROPOUT:
            out.append(LayerCost(li, 0, 0, 0))    # inference no-op
            continue
        reads = blob_bytes(li)
        if l.type == LayerType.ROUTE:
            reads = sum(blob_bytes(d + 1) for d in l.depends)
        elif l.type == LayerType.SHORTCUT:
            reads += blob_bytes(l.depends[0] + 1)
        writes = blob_bytes(li + 1)
        out.append(LayerCost(li, reads + writes, weight_bytes(li),
                             flops, vpu))
    return out


def model_flops(ir: NetIR, batch: int = 1) -> int:
    """Dense and depthwise FLOPs of one forward of ``batch`` images."""
    return sum(c.flops + c.vpu_flops for c in layer_costs(ir, batch))


def region_floor_us(costs: List[LayerCost], start: int, end: int,
                    gbps: float = HBM_GBPS,
                    tflops: float = TC_TFLOPS_BF16,
                    vpu_tflops: float = F32_TFLOPS) -> float:
    """Floor for a fused region [start, end]: the max over resources of the
    SUMMED demand of its layers (its device time lands on one scope), not
    the start layer's floor alone nor the sum of per-layer max-floors."""
    span = [c for c in costs if start <= c.index <= end]
    return max(sum(c.bytes_total for c in span) / gbps / 1e3,
               sum(c.flops for c in span) / tflops / 1e6,
               sum(c.vpu_flops for c in span) / vpu_tflops / 1e6,
               sum(c.int8_floor_us() for c in span))


def _stage_of(ir: NetIR, li: int) -> Tuple[int, int]:
    """Resolution stage of layer ``li`` = its input blob's spatial dims;
    a layer right after a YOLO layer reads a zero-dim alias blob (yolo
    produces no tensor), so fall back to its output dims."""
    b = ir.blobs[li]
    if b.w == 0 and li + 1 < len(ir.blobs):
        b = ir.blobs[li + 1]
    return (b.w, b.h)


@dataclasses.dataclass
class StageCost:
    stage: Tuple[int, int]         # (w, h) of the layers' input blobs
    bytes_total: int
    flops: int
    floor_us: float


def stage_costs(ir: NetIR, costs: List[LayerCost],
                gbps: float = HBM_GBPS,
                tflops: float = TC_TFLOPS_BF16,
                vpu_tflops: float = F32_TFLOPS) -> List[StageCost]:
    """Group layer costs by input spatial dims (the net's resolution
    stages)."""
    by_stage: Dict[Tuple[int, int], List[LayerCost]] = defaultdict(list)
    for c in costs:
        by_stage[_stage_of(ir, c.index)].append(c)
    out = []
    for st in sorted(by_stage, key=lambda s: -s[0] * s[1]):
        cs = by_stage[st]
        out.append(StageCost(
            st, sum(c.bytes_total for c in cs),
            sum(c.flops + c.vpu_flops + c.int8_ops + c.int8_vpu_ops
                for c in cs),
            max(sum(c.hbm_floor_us(gbps) for c in cs),
                sum(c.mxu_floor_us(tflops) for c in cs),
                sum(c.vpu_floor_us(vpu_tflops) for c in cs),
                sum(c.int8_floor_us() for c in cs))))
    return out


def render(ir: NetIR, costs: List[LayerCost], batch: int,
           measured_us: Optional[Dict[int, float]] = None,
           gbps: float = HBM_GBPS,
           tflops: float = TC_TFLOPS_BF16,
           measured_label: str = "measured us") -> str:
    """Stage table (and measured-vs-floor when a profile is supplied):
    bytes moved, FLOPs, floor, and how far above the floor the measured
    time sits.  ``measured_label`` names the clock of ``measured_us``."""
    lines = ["roofline (batch %d, %.0f GB/s HBM, %.0f bf16 tensor-core "
             "TFLOP/s, %.0f float32 TFLOP/s for depthwise):"
             % (batch, gbps, tflops, F32_TFLOPS)]
    hdr = "%10s %10s %9s %9s" % ("stage", "MB moved", "GFLOP", "floor us")
    if measured_us:
        hdr += " %11s %8s" % (measured_label, "x floor")
    lines.append(hdr)
    meas_by_stage: Dict[Tuple[int, int], float] = defaultdict(float)
    if measured_us:
        for c in costs:
            meas_by_stage[_stage_of(ir, c.index)] += \
                measured_us.get(c.index, 0.0)
    tot_b = tot_f = tot_floor = tot_m = 0.0
    for sc in stage_costs(ir, costs, gbps, tflops):
        row = "%4dx%-5d %10.1f %9.1f %9.1f" % (
            sc.stage[0], sc.stage[1], sc.bytes_total / 1e6,
            sc.flops / 1e9, sc.floor_us)
        if measured_us:
            m = meas_by_stage.get(sc.stage, 0.0)
            row += " %11.1f %8s" % (
                m, ("%.2f" % (m / sc.floor_us)) if sc.floor_us > 0 else "-")
            tot_m += m
        lines.append(row)
        tot_b += sc.bytes_total
        tot_f += sc.flops
        tot_floor += sc.floor_us
    row = "%10s %10.1f %9.1f %9.1f" % ("TOTAL", tot_b / 1e6, tot_f / 1e9,
                                       tot_floor)
    if measured_us:
        row += " %11.1f %8s" % (
            tot_m, ("%.2f" % (tot_m / tot_floor)) if tot_floor > 0 else "-")
    lines.append(row)
    return "\n".join(lines) + "\n"
