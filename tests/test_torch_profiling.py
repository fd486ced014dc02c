"""The port's profiling (``ffcnn_tpu_torch/profiling.py``) and the layer
ranges of ``graph/build.py`` on the CPU: the layer descriptions equal the
JAX package's for every layer of every cfg; every dispatch runs under a
range named as JAX's ``jax.named_scope``; ``profile_layers`` gives one row
a layer, sums to its total and names its device and clock; the device-busy
union of ``trace_occupancy`` on hand-built events."""

import glob
import os
import types

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType

import ffcnn_tpu_torch as pt
from ffcnn_tpu import profiling as jprof
from ffcnn_tpu.darknet import parse_cfg as jparse
from ffcnn_tpu_torch import profiling as tprof
from ffcnn_tpu_torch.darknet import parse_cfg as tparse
from ffcnn_tpu_torch.darknet.weights import synth_weights_bytes
from ffcnn_tpu_torch.testing import cap_threads

cap_threads()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFGS = sorted(glob.glob(os.path.join(REPO, "models", "*.cfg")))
XL = os.path.join(REPO, "models", "yolo-fastest-xl.cfg")
MICRO = os.path.join(REPO, "models", "ffcnn-micro.cfg")
REGION_FLAGS = {"FFCNN_FUSED_DOWN": "1", "FFCNN_FUSED_MINC": "8",
                "FFCNN_CONV0_PALLAS": "1", "FFCNN_FUSED_HEADS": "1"}


@pytest.mark.parametrize("cfg", CFGS,
                         ids=lambda p: os.path.basename(p)[:-4])
def test_layer_desc_equals_jax(cfg):
    jir, tir = jparse(cfg, 416, 416), tparse(cfg, 416, 416)
    assert [tprof._layer_desc(tir, li) for li in range(len(tir.layers))] \
        == [jprof._layer_desc(jir, li) for li in range(len(jir.layers))]


def _net(cfg, size, flags, monkeypatch, mode="fast"):
    for k, v in flags.items():
        monkeypatch.setenv(k, v)
    return pt.load(cfg, synth_weights_bytes(pt.parse_cfg(cfg), seed=42,
                                            obj_bias=2.0),
                   input_w=size, input_h=size, mode=mode, device="cpu")


def test_ranges_name_every_dispatch(monkeypatch):
    """The region plan of xl at 64x64 (stem, two block runs, two head
    chains): one range each, the rest one a layer, JAX's names, no other
    L### range."""
    net = _net(XL, 64, REGION_FLAGS, monkeypatch)
    frames = torch.zeros((1, 64, 64, 3), dtype=torch.uint8)
    events, _ = tprof.trace(lambda: net.forward_heads(frames), cuda=False)
    got = sorted({e.name for e in events if tprof._SCOPE_RE.fullmatch(e.name)})
    covered = set(range(1, 109)) | set(range(116, 121)) | \
        set(range(125, 130))
    want = {"L000_conv0_pallas", "L001_fusedrun_to_080",
            "L081_fusedrun_to_108", "L116_headrun_to_120",
            "L125_headrun_to_129"} | {
        f"L{li:03d}_{l.type.name.lower()}"
        for li, l in enumerate(net.ir.layers) if li and li not in covered}
    assert got == sorted(want)


@pytest.mark.parametrize("cfg,flags", [(MICRO, {}), (XL, REGION_FLAGS)],
                         ids=["micro", "xl-region"])
def test_profile_layers_on_the_cpu(cfg, flags, monkeypatch):
    """One row a layer; rows plus other equal the total; CPU times named
    as such; a region's time on its start row, labeled and floored as the
    region; the per-type report of ``Net.profile``."""
    net = _net(cfg, 64, flags, monkeypatch)
    rep = net.profile_layers(batch=np.zeros((1, 64, 64, 3), np.uint8),
                             iters=1)
    assert len(rep.layers) == len(net.ir.layers)
    assert sum(lp.us_per_step for lp in rep.layers) + rep.other_us == \
        pytest.approx(rep.total_us, rel=1e-9)
    assert rep.device == "cpu" and rep.clock == "CPU"
    assert rep.kernels == {} and rep.replay_us is None
    assert rep.other_us > 0
    text = rep.render()
    assert text.startswith("profile (CPU us per step on cpu, 1 steps")
    assert "device" not in text
    runs = {r.start: r.end for r in net._fused_runs + net._head_runs}
    costs = net.roofline_costs(1)
    for lp in rep.layers:
        if lp.index in runs:
            end = runs[lp.index]
            assert lp.type_name == "fusedrun" and lp.desc.startswith(
                f"region L{lp.index:03d}..L{end:03d}")
            assert rep.floors_us[lp.index] == pt.roofline.region_floor_us(
                costs, lp.index, end)
            assert lp.us_per_step > 0
        elif net.ir.layers[lp.index].type == pt.LayerType.CONV and not any(
                s <= lp.index <= e for s, e in runs.items()):
            assert lp.us_per_step > 0, lp.index
    if cfg == MICRO:
        text = net.profile(per_type=True, batch=np.zeros((1, 64, 64, 3),
                                                         np.uint8))
        assert "(pre/post)" in text and "idx" not in text


def _ev(start, end, device=DeviceType.CUDA, name="k", annotation=False):
    return types.SimpleNamespace(
        device_type=device, is_user_annotation=annotation, name=name,
        time_range=types.SimpleNamespace(start=start, end=end))


def _host(name, start, end, id_=0):
    return types.SimpleNamespace(
        device_type=DeviceType.CPU, is_user_annotation=False, name=name,
        id=id_, time_range=types.SimpleNamespace(start=start, end=end))


def test_device_events_go_to_the_range_of_their_launch():
    """Each device event to the range whose host interval holds its
    launch call (same correlation id): a cuDNN kernel under an op, a
    kernel launched through ctypes with no op, a copy; events launched
    outside every range, or with no launch call in the trace, to -1; the
    ranges' own device annotations counted nowhere."""
    ev = [_host("L001_fusedrun_to_080", 0, 100),
          _host("aten::convolution", 5, 20, id_=900),
          _host("cudaLaunchKernel", 10, 12, id_=1),
          _host("cudaLaunchKernelExC", 40, 42, id_=2),
          _host("L109_maxpool", 100, 150),
          _host("cudaMemcpyAsync", 120, 121, id_=3),
          _host("cudaLaunchKernel", 160, 161, id_=4),
          _ev(200, 230, name="cudnn_conv"), _ev(230, 300, name="K1"),
          _ev(300, 305, name="Memcpy DtoD"), _ev(305, 309, name="nms"),
          _ev(309, 310, name="lost"), _ev(200, 300, annotation=True,
                                          name="L001_fusedrun_to_080")]
    for e, i in zip(ev[7:], (1, 2, 3, 4, 5)):
        e.id = i
    per, names, total = tprof._attribute_device(ev)
    assert total == 110
    assert per == {1: 100, 109: 5}
    assert names == {1: {"cudnn_conv": 1, "K1": 1},
                     109: {"Memcpy DtoD": 1}, -1: {"nms": 1, "lost": 1}}


def test_trace_occupancy_is_the_union():
    """Overlaps merge, gaps stay idle, host events and range annotations
    do not count, and the span ends at the latest end."""
    ev = [_ev(0, 10), _ev(5, 15), _ev(20, 30), _ev(40, 50, DeviceType.CPU),
          _ev(0, 60, annotation=True), _ev(30, 60, name="L001_conv")]
    assert tprof.trace_occupancy(ev) == {"busy_ms": 0.025, "span_ms": 0.03,
                                         "occupancy": 0.8333}
    assert tprof.trace_occupancy([_ev(0, 100), _ev(10, 20)]) == {
        "busy_ms": 0.1, "span_ms": 0.1, "occupancy": 1.0}
    assert tprof.trace_occupancy([]) == {"busy_ms": 0.0, "span_ms": 0.0,
                                         "occupancy": 0.0}


def test_device_time_needs_a_device():
    """No device event, no device time: the CPU is never timed as one."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no device time"):
        tprof.device_op_time_ms(lambda: torch.ones(8).sum())
