"""The rest of the Darknet zoo (yolov3-tiny, yolov4-tiny, yolov3, yolov4)
through the port's ``Net``, on the CPU: what ``chip_smoke.py`` phase 16
drives on the card at 416x416, pinned here without a forward at that size,
and held against the JAX package at 96x96.

* The int8 conv's path (``conv_int8.route``) of every unfused int8 conv of
  each model's int8 plan at its cfg's 416x416 (a plan built from a seeded
  absmax: which blobs and convs go int8 depends on the graph and the
  channel counts, not on the ranges): the paths the card takes, which
  phase 16 checks every call against (``ZOO_INT8_PATHS``).
* No fused block run and no head chain on these graphs in fast or int8
  mode, as JAX's planners find none: a fast forward launches K2 alone.
* parity's top-k: a Net whose top-k is the model's candidate count gives
  the detections the default Net's K growth reaches, which phase 16's CPU
  side relies on (one forward, where the growth takes one a rung); and
  ``bench.parity_candidates`` hands out the CPU's candidates and tail.
* A fast Net, and one under ``FFCNN_CONV0_INT8=1`` (conv-1 through the int8
  conv's uint8 mode; yolov4's stem is F 32, stride 1, mish), of yolov4-tiny
  and yolov4 at 96x96 against JAX's folded bf16 forward: heads within the
  fast path's bounds (2^-3 of the range at most, 2^-8 on average: bf16
  blobs carry one-ulp flips through the depth), and 90% of each side's
  detections among the other side's candidates (same class, 4 px, 0.02).
"""

import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import ffcnn_tpu_torch as pt
from ffcnn_tpu.darknet import parse_cfg as jparse
from ffcnn_tpu.darknet.weights import load_weights, synth_weights_bytes
from ffcnn_tpu.graph import build as jbuild
from ffcnn_tpu.kernels import block_fused as jbf
from ffcnn_tpu.kernels import head_fused as jhf
from ffcnn_tpu.ops import preprocess as jpre
from ffcnn_tpu_torch import quant as tq
from ffcnn_tpu_torch.kernels import conv_int8 as tci
from ffcnn_tpu_torch.net import planned_runs
from ffcnn_tpu_torch.ops.preprocess import letterbox_params
from ffcnn_tpu_torch.ops.yolo import decode_heads
from ffcnn_tpu_torch.testing import cap_threads

import chip_smoke

cap_threads()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ZOO = dict(chip_smoke.ZOO)
BF16_MAX_TOL, BF16_MEAN_TOL = 2 ** -3, 2 ** -8
MATCH_FRAC, MATCH_PX, MATCH_SCORE = 0.9, 4.0, 0.02
SIZE = 96


def _cfg(tag):
    return os.path.join(REPO, ZOO[tag])


def _params(ir):
    params, _ = load_weights(ir, synth_weights_bytes(ir, seed=42,
                                                     obj_bias=2.0))
    return params


@pytest.mark.parametrize("tag", list(ZOO))
def test_int8_paths_at_416(tag):
    """Every unfused int8 conv of the model's plan at its cfg's size, by
    the path the card's kernel takes, equals phase 16's pin; none is
    layer 0 (the pixels stay float, or take the uint8 mode)."""
    ir = pt.parse_cfg(_cfg(tag))
    assert (ir.blobs[0].w, ir.blobs[0].h) == (416, 416)
    net = pt.Net(ir, _params(ir), mode="int8", device="cpu")
    absmax = np.random.RandomState(0).uniform(
        0.5, 12, len(ir.blobs)).astype(np.float32)
    net.set_quant_plan(tq.build_plan(ir, net.params, absmax))
    paths = {}
    for li in tq.unfused_int8(net):
        b, l = ir.blobs[li], ir.layers[li]
        p = tci.route(b.c, l.fn, l.fs, l.stride, l.groups)
        paths[p] = paths.get(p, 0) + 1
    assert paths == chip_smoke.ZOO_INT8_PATHS[tag]
    assert 0 not in net.quant.weights
    assert len(tq.conv_shapes(net, distinct=True)) <= sum(paths.values())


@pytest.mark.parametrize("tag", list(ZOO))
def test_no_fused_run(tag):
    """The port's planners, as JAX's, find no block run and no head chain
    on these graphs, with no flag and under the region flags' planners."""
    ir, jir = pt.parse_cfg(_cfg(tag)), jparse(_cfg(tag))
    for int8 in (False, True):
        assert planned_runs(ir, True, int8) == ([], [])
    assert jbf.plan_runs(jir) == [] and jhf.plan_head_runs(jir) == []


def test_parity_topk_at_the_candidate_count():
    """parity mode's K growth (top-k 128, then x4 while saturated) ends at
    the detections a Net with top-k at the model's candidate count gives
    in one pass (yolov3-tiny at 96x96: the synthetic weights saturate 128
    candidates)."""
    ir = pt.parse_cfg(_cfg("yolov3-tiny"), SIZE, SIZE)
    params = _params(jparse(_cfg("yolov3-tiny"), SIZE, SIZE))
    grow = pt.Net(ir, params, mode="parity", device="cpu")
    k = grow._max_candidates()
    once = pt.Net(ir, params, mode="parity", topk=k, device="cpu")
    frames = np.random.RandomState(3).randint(0, 256, (2, SIZE, SIZE, 3),
                                              dtype=np.uint8)
    got = grow.detect(frames)
    assert len({key[3] for key in grow._pipelines}) > 1    # it grew
    assert got == once.detect(frames) and any(got)


def test_parity_candidates_hands_out_the_cpu_side():
    """``bench.parity_candidates(..., out=)`` gives the CPU's candidates and
    its tail on them, whose detections are the CPU Net's own (a Net at
    top-k = the candidate count, as phase 16's CPU side), for the
    detections-as-sets line phase 16 logs of a tie-prone model."""
    from ffcnn_tpu_torch.bench import parity_candidates
    ir = pt.parse_cfg(_cfg("yolov4-tiny"), SIZE, SIZE)
    params = _params(jparse(_cfg("yolov4-tiny"), SIZE, SIZE))
    a = pt.Net(ir, params, mode="parity", device="cpu")
    b = pt.Net(ir, params, mode="parity", topk=a._max_candidates(),
               device="cpu")
    frames = np.random.RandomState(4).randint(0, 256, (2, SIZE, SIZE, 3),
                                              dtype=np.uint8)
    out = {}
    n = parity_candidates(a, b, frames, out=out)
    assert n == int((out["cpu"].scores > 0).sum()) > 0
    assert b._to_detections(out["tail"]) == b.detect(frames)


def _frac(dets, cands):
    """Share of ``dets`` (one image's) with a same-class candidate within
    MATCH_PX and MATCH_SCORE (``cands``: one image's boxes, scores,
    classes)."""
    boxes, scores, classes = (t.numpy() for t in cands)
    live = scores > 0
    boxes, scores, classes = boxes[live], scores[live], classes[live]
    if not dets:
        return 1.0
    return sum(bool(np.any((classes == d.class_id)
                           & (np.abs(boxes - np.asarray(d[2:])).max(1)
                              <= MATCH_PX)
                           & (np.abs(scores - d.score) <= MATCH_SCORE)))
               for d in dets) / len(dets)


@pytest.mark.parametrize("conv0_int8", [False, True],
                         ids=["fast", "conv0_int8"])
@pytest.mark.parametrize("tag", ["yolov4-tiny", "yolov4"])
def test_fast_net_matches_jax(tag, conv0_int8, monkeypatch):
    """A fast Net at 96x96 (conv-1 in int8 under the flag) against JAX's
    folded bf16 forward with the same conv-1: heads within the fast
    bounds, and each side's detections among the other side's candidates
    (JAX's side: the port's tail on JAX's heads)."""
    jir = jparse(_cfg(tag), SIZE, SIZE)
    params = _params(jir)
    if conv0_int8:
        monkeypatch.setenv("FFCNN_CONV0_INT8", "1")
    net = pt.Net(pt.parse_cfg(_cfg(tag), SIZE, SIZE), params, mode="fast",
                 device="cpu")
    assert (net._conv0_int8, net._fused_runs) == (conv0_int8, [])
    frames = np.random.RandomState(7).randint(0, 256, (2, SIZE, SIZE, 3),
                                              dtype=np.uint8)
    got = net.forward_heads(torch.from_numpy(frames))
    jp = jbuild.fold_input_transform(jir, jbuild.params_to_pytree(params),
                                     pt.DEFAULT_MEAN, pt.DEFAULT_NORM)
    want = jax.jit(lambda v: jbuild.forward_features(
        jir, jp, jpre.letterbox_uint8(v, SIZE, SIZE),
        input_dtype=jnp.bfloat16, conv0_int8=conv0_int8))(
            jnp.asarray(frames))
    assert len(got) == len(want)
    jheads = []
    for g, w in zip(got, want):
        w = np.asarray(jnp.asarray(w, jnp.float32))
        jheads.append(torch.from_numpy(w))
        g = g.float().numpy()
        scale = np.abs(w).max()
        err = np.abs(g - w)
        assert err.max() <= BF16_MAX_TOL * scale, err.max() / scale
        assert err.mean() <= BF16_MEAN_TOL * scale, err.mean() / scale
    # each side's detections among the other side's candidates
    _, _, s1, s2 = letterbox_params(SIZE, SIZE, SIZE, SIZE)
    cands = [decode_heads(net.ir, [h.float() for h in hs], SIZE, SIZE)
             for hs in (got, jheads)]
    dets = [net.detect(frames), net._to_detections(net.postprocess(
        cands[1], net.topk, s1, s2))]
    assert sum(map(len, dets[1])) > 0
    for i in range(len(frames)):
        for d, c in ((dets[0], cands[1]), (dets[1], cands[0])):
            assert _frac(d[i], (c.boxes[i], c.scores[i], c.classes[i])) \
                >= MATCH_FRAC
