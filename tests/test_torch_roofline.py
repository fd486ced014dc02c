"""The port's roofline (``ffcnn_tpu_torch/roofline.py``) against the JAX
package's (``ffcnn_tpu/roofline.py``) on four cfgs, bf16 and float32, with
no runs and with the port's planned runs (default, and region with head
chains): the FLOPs are JAX's exactly; the bytes are JAX's plus exactly the
bytes of the blobs JAX models as fused away by XLA (each written once by
its producer and read once by its one reader in the port, whose convs
write every output); the floors equal JAX's to 1e-9 given JAX's
constants."""

import dataclasses
import os
from collections import defaultdict

import pytest

from ffcnn_tpu import roofline as jroof
from ffcnn_tpu.darknet import parse_cfg as jparse
from ffcnn_tpu_torch import bench_block
from ffcnn_tpu_torch import roofline as troof
from ffcnn_tpu_torch.darknet import parse_cfg as tparse
from ffcnn_tpu_torch.darknet.ir import LayerType
from ffcnn_tpu_torch.kernels.block_fused import plan_runs
from ffcnn_tpu_torch.kernels.head_fused import plan_head_runs
from ffcnn_tpu_torch.testing import cap_threads

cap_threads()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFGS = ["ffcnn-micro", "yolo-fastest-xl", "yolov3-tiny", "yolov4-tiny"]
BATCH = 4


def _cfg(name):
    return os.path.join(REPO, "models", name + ".cfg")


def _runs(ir, plan):
    if plan == "none":
        return None
    if plan == "default":
        return plan_runs(ir, min_channels=16, allow_down=False) or None
    return (plan_runs(ir, min_channels=8, allow_down=True)
            + plan_head_runs(ir)) or None


def _xla_fused_away(ir, runs):
    """The blobs JAX's model leaves unmaterialized: its greedy one-deep
    pairing of a conv with its producer conv (``ffcnn_tpu/roofline.py``,
    ``xla_fused_away``), restated."""
    interior = {li for r in (runs or []) for li in range(r.start, r.end + 1)}
    readers = defaultdict(int)
    for li, l in enumerate(ir.layers):
        if l.type == LayerType.ROUTE:
            for d in l.depends:
                readers[d + 1] += 1
        elif l.type == LayerType.SHORTCUT:
            readers[li] += 1
            readers[l.depends[0] + 1] += 1
        else:
            readers[li] += 1
    away, paired = set(), set()
    for li, l in enumerate(ir.layers):
        if l.type != LayerType.CONV or li in interior:
            continue
        p = li - 1
        if (p >= 0 and ir.layers[p].type == LayerType.CONV
                and p not in interior and p not in paired
                and li not in paired and readers[li] == 1):
            paired.update((p, li))
            away.add(li)
    return away


@pytest.mark.parametrize("plan", ["none", "default", "region"])
@pytest.mark.parametrize("dtype", ["bf16", "f32"])
@pytest.mark.parametrize("name", CFGS)
def test_layer_costs_equal_jax_plus_xla_pairs(name, dtype, plan):
    jir, tir = jparse(_cfg(name), 320, 320), tparse(_cfg(name), 320, 320)
    runs = _runs(tir, plan)
    want = jroof.layer_costs(jir, BATCH, dtype, fused_runs=runs)
    got = troof.layer_costs(tir, BATCH, dtype, fused_runs=runs)
    assert len(got) == len(want) == len(tir.layers)
    away = _xla_fused_away(tir, runs)
    if plan == "none" and name != "ffcnn-micro":
        assert away                        # the test compares something
    extra = defaultdict(int)
    for b in away:                         # blob b: layer b-1 writes it,
        blob = tir.blobs[b]                # conv b alone reads it
        n = troof.stored_bytes(blob.w, blob.h, blob.c, BATCH, dtype)
        extra[b - 1] += n
        extra[b] += n
    for g, w in zip(got, want):
        assert (g.index, g.flops, g.vpu_flops, g.bytes_w) == \
            (w.index, w.flops, w.vpu_flops, w.bytes_w), g.index
        assert g.bytes_act == w.bytes_act + extra[g.index], g.index
    assert sum(c.bytes_total for c in got) == \
        sum(c.bytes_total for c in want) + sum(extra.values())


@pytest.mark.parametrize("name", CFGS)
def test_floors_equal_jax_with_its_constants(name):
    """The floor formulas: with JAX's v5e constants passed, the port's
    floors of JAX's costs equal JAX's, layer by layer and region by
    region."""
    jir = jparse(_cfg(name), 320, 320)
    runs = _runs(tparse(_cfg(name), 320, 320), "region") or []
    want = jroof.layer_costs(jir, BATCH, fused_runs=runs or None)
    got = [troof.LayerCost(**dataclasses.asdict(c)) for c in want]
    consts = (jroof.HBM_GBPS_EFFECTIVE, jroof.MXU_TFLOPS_BF16,
              jroof.VPU_TFLOPS_BF16)
    for g, w in zip(got, want):
        assert g.floor_us(*consts) == pytest.approx(w.floor_us(), rel=1e-9)
    for r in runs:
        assert troof.region_floor_us(got, r.start, r.end, *consts) == \
            pytest.approx(jroof.region_floor_us(want, r.start, r.end),
                          rel=1e-9)


def test_card_constants_are_one_copy():
    """The H100's peaks live in roofline.py; bench_block's bound reads
    them, unchanged."""
    assert bench_block.HBM_BYTES_S is troof.HBM_BYTES_S == 3.35e12
    assert bench_block.TC_BF16_FLOP_S is troof.TC_BF16_FLOP_S == 989e12
    assert bench_block.F32_FLOP_S is troof.F32_FLOP_S == 67e12
    c = troof.LayerCost(0, 3_350_000, 0, 989_000_000, 67_000_000)
    assert c.hbm_floor_us() == pytest.approx(1.0)
    assert c.mxu_floor_us() == pytest.approx(1.0)
    assert c.vpu_floor_us() == pytest.approx(1.0)


def test_model_flops_and_refusals():
    """xl's FLOPs an image at 320x320 (the bench's mfu numerator), the
    dense depthwise split by hand on its stem and first depthwise, and an
    int8 plan's operations."""
    ir = tparse(_cfg("yolo-fastest-xl"), 320, 320)
    costs = troof.layer_costs(ir, 1)
    l0 = ir.layers[0]
    assert costs[0].flops == 2 * 160 * 160 * l0.fn * 3 * 3 * 3
    dw = next(li for li, l in enumerate(ir.layers)
              if l.type == LayerType.CONV and l.groups > 1)
    ob = ir.blobs[dw + 1]
    assert costs[dw].flops == 0
    assert costs[dw].vpu_flops == 2 * ob.w * ob.h * ob.c * 9
    assert troof.model_flops(ir) == sum(c.flops + c.vpu_flops
                                        for c in costs) == 830_096_000
    # an int8 plan (once refused) moves its unfused convs' operations to
    # the int8 fields and keeps the total
    import numpy as np
    from ffcnn_tpu_torch import quant as tq
    from ffcnn_tpu_torch.darknet.weights import zero_weights
    plan = tq.build_plan(ir, zero_weights(ir), np.ones(len(ir.blobs)))
    q = troof.layer_costs(ir, 1, quant=plan)
    assert sum(c.flops + c.vpu_flops + c.int8_ops + c.int8_vpu_ops
               for c in q) == 830_096_000
    assert sum(1 for c in q if c.int8_ops or c.int8_vpu_ops) == \
        len(plan.weights)
    assert sum(c.bytes_total for c in q) < sum(c.bytes_total for c in costs)


def test_net_roofline_costs_follow_its_plan(monkeypatch):
    """A CPU Net's roofline_costs model its own runs and head chains, and
    FFCNN_FUSED_STORE=f32's run boundaries."""
    import ffcnn_tpu_torch as pt
    for k, v in {"FFCNN_FUSED_DOWN": "1", "FFCNN_FUSED_MINC": "8",
                 "FFCNN_FUSED_HEADS": "1",
                 "FFCNN_FUSED_STORE": "f32"}.items():
        monkeypatch.setenv(k, v)
    ir = tparse(_cfg("yolo-fastest-xl"), 64, 64)
    net = pt.Net(ir, pt.darknet.weights.zero_weights(ir), device="cpu")
    runs = list(net._fused_runs) + list(net._head_runs)
    assert [(r.start, r.end) for r in runs] == [(1, 80), (81, 108),
                                                (116, 120), (125, 129)]
    assert net.roofline_costs(8) == troof.layer_costs(
        ir, 8, "bf16", fused_runs=runs, store_dtype="f32")
    render = troof.render(ir, net.roofline_costs(8), 8)
    assert "TOTAL" in render and "3350 GB/s HBM" in render
