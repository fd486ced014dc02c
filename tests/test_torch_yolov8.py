"""The port's YOLOv8 path (``ffcnn_tpu_torch/yolov8.py``, the ``[yolov8]``
head through ``graph/build.py``, ``ops/yolo.py::decode_head_v8``, union
NMS, ``Net`` and ``cli convert-v8``) against the JAX package's on the CPU,
mirroring ``tests/test_yolov8.py`` at scale n with 80 classes, size 160
(64 where JAX's own case uses 64), on seeded numpy inputs."""

import dataclasses
import json
import os
import sys
import threading
import urllib.request

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import ffcnn_tpu as jt
import ffcnn_tpu_torch as pt
from ffcnn_tpu import yolov8 as jy
from ffcnn_tpu.cli import main as jcli_main
from ffcnn_tpu.darknet import parse_cfg as jparse
from ffcnn_tpu.darknet.weights import load_weights as jload
from ffcnn_tpu.darknet.weights import synth_weights_bytes
from ffcnn_tpu.graph import build as jbuild
from ffcnn_tpu.imageio.bmp import bmp_load, bmp_save
from ffcnn_tpu.kernels import block_fused as jbf
from ffcnn_tpu.ops import nms as jnms
from ffcnn_tpu.ops import preprocess as jpre
from ffcnn_tpu.ops import yolo as jyolo
from ffcnn_tpu.oracle import numpy_ref
from ffcnn_tpu_torch import cli as tcli
from ffcnn_tpu_torch import yolov8 as ty
from ffcnn_tpu_torch.darknet.weights import load_weights as tload
from ffcnn_tpu_torch.graph import build as tbuild
from ffcnn_tpu_torch.kernels import nms as tknms
from ffcnn_tpu_torch.ops import nms as tnms
from ffcnn_tpu_torch.ops import yolo as tyolo
from ffcnn_tpu_torch.serve import DetectorService, make_server

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))

NC, SCALE, SIZE = 80, "n", 160
BMP = os.path.join(REPO, "tests", "fixtures", "test320.bmp")
# the fast forward against JAX's, of the head map's range: bf16 one-ulp
# flips between two float32 sum orders carried through the depth (the
# bounds of test_torch_net.py's fast test)
HEAD_MAX_TOL, HEAD_MEAN_TOL = 2 ** -3, 2 ** -8


@pytest.fixture(scope="module")
def sd():
    return jy.synthesize_state_dict(NC, SCALE, seed=0)


def _graph(sd, size, conf):
    """(JAX IR, port IR, JAX-loaded params, port-loaded params) of the
    converted v8n graph; the port converts, both packages parse and load."""
    cfg, wbytes = ty.convert(sd, NC, SCALE, size=size, conf=conf)
    jir, tir = jparse(cfg, is_path=False), pt.parse_cfg(cfg, is_path=False)
    return jir, tir, jload(jir, wbytes)[0], tload(tir, wbytes)[0]


@pytest.fixture(scope="module")
def v8_160(sd):
    return _graph(sd, SIZE, 0.10)


@pytest.fixture(scope="module")
def v8_64(sd):
    return _graph(sd, 64, 0.05)


def _frames(size, n, seed):
    return np.random.RandomState(seed).randint(0, 256, (n, size, size, 3),
                                               dtype=np.uint8)


def _same_params(a, b):
    assert sorted(a) == sorted(b)
    for li in a:
        for f in ("weights", "scale", "bias"):
            np.testing.assert_array_equal(getattr(a[li], f),
                                          getattr(b[li], f))


# ---------------------------------------------------------------- converter
@pytest.mark.parametrize("scale", ["n", "s", "m", "l", "x"])
def test_converter_equals_jax(scale):
    """The same cfg text and the same weight bytes as JAX's converter at
    every scale (size 160, 8 classes), and the port's loader reads the
    bytes (a BN-folded ``convbn`` or a plain-bias conv each) as JAX's."""
    s = jy.synthesize_state_dict(8, scale, seed=1)
    cfg, wbytes = ty.convert(s, 8, scale, size=160)
    assert (cfg, wbytes) == jy.convert(s, 8, scale, size=160)
    assert ty.build_graph(8, scale, size=160) == \
        jy.build_graph(8, scale, size=160)
    if scale == "n":
        _same_params(tload(pt.parse_cfg(cfg, is_path=False), wbytes)[0],
                     jload(jparse(cfg, is_path=False), wbytes)[0])


def test_synthesize_state_dict_equals_jax(sd):
    got = ty.synthesize_state_dict(NC, SCALE, seed=0)
    assert sorted(got) == sorted(sd)
    for k in sd:
        assert got[k].dtype == sd[k].dtype
        np.testing.assert_array_equal(got[k], sd[k], err_msg=k)


def test_load_weights_equals_jax(v8_160):
    _, _, jp, tp = v8_160
    _same_params(tp, jp)


# ------------------------------------------------------------------ decode
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_head_v8_equals_jax(v8_160, dtype):
    """decode_head_v8 on the same feats: the DFL in float32 either way, the
    class max in the feat's dtype (exact), so both dtypes hold scores to
    1e-6 (far inside bf16's one ulp) and boxes to 1e-4 of their range
    (exp and logsumexp from two libraries: a few float32 ulps a bin, times
    the bin index and the stride)."""
    jir, tir, _, _ = v8_160
    jl = [l for l in jir.layers if l.type.name == "YOLOV8"][1]
    tl = [l for l in tir.layers if l.type == pt.LayerType.YOLOV8][1]
    rng = np.random.RandomState(5)
    feat = (rng.randn(2, 10, 10, 4 * 16 + NC) * 3).astype(np.float32)
    # class logits around the 0.10 gate: some cells pass, some do not
    feat[..., 4 * 16:] = feat[..., 4 * 16:] / 3 - 4.5
    want = jyolo.decode_head_v8(jnp.asarray(feat, dtype), jl, SIZE, SIZE)
    got = tyolo.decode_head_v8(torch.from_numpy(feat).to(getattr(torch,
                                                                 dtype)),
                               tl, SIZE, SIZE)
    wb, ws, wc = (np.asarray(a) for a in want)
    assert got.boxes.dtype == got.scores.dtype == torch.float32
    assert 0 < int((ws > 0).sum()) < ws.size
    np.testing.assert_array_equal(got.classes.numpy(), wc)
    np.testing.assert_allclose(got.scores.numpy(), ws, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got.boxes.numpy(), wb, rtol=0,
                               atol=1e-4 * np.abs(wb).max())


# ---------------------------------------------------------------- pipeline
def _assert_same_detections(got, want, score_tol=1e-4):
    """Same count, class and integer box, scores to ``score_tol``."""
    assert [len(d) for d in got] == [len(d) for d in want]
    for dg, dw in zip(got, want):
        for g, w in zip(dg, dw):
            assert g.class_id == w.class_id
            assert [int(v) for v in g[2:]] == [int(v) for v in w[2:]]
            assert abs(g.score - w.score) <= score_tol


def test_parity_detect_equals_jax(v8_160):
    """Parity detections on seeded frames and the letterboxed fixture equal
    JAX's parity detections (mirrors test_pipeline_vs_oracle against
    JAX): same count, class and integer box, scores to 1e-4."""
    jir, tir, jp, tp = v8_160
    frames = _frames(SIZE, 2, seed=1)
    fixture = np.stack([bmp_load(BMP), _frames(320, 1, seed=2)[0]])
    tnet = pt.Net(tir, tp, mode="parity", device="cpu")
    jnet = jt.Net(jir, jp, mode="parity")
    for batch in (frames, fixture):
        want = jnet.detect(batch)
        assert all(want)
        _assert_same_detections(tnet.detect(batch), want)


def test_fast_heads_match_jax(v8_160):
    """Fast mode (conv-1 folded, bf16 blobs; C2f plans no fused run) on the
    same frames as JAX's folded bf16 forward: the head maps within the
    fast tolerances, and detect runs."""
    jir, tir, jp, tp = v8_160
    net = pt.Net(tir, tp, mode="fast", device="cpu")
    assert net._fused_runs == [] == jbf.plan_runs(jir)
    frames = _frames(SIZE, 2, seed=3)
    got = net.forward_heads(torch.from_numpy(frames))
    params = jbuild.fold_input_transform(jir, jbuild.params_to_pytree(jp),
                                         pt.DEFAULT_MEAN, pt.DEFAULT_NORM)
    want = jax.jit(lambda x: jbuild.forward_features(
        jir, params, jpre.letterbox_uint8(x, SIZE, SIZE),
        input_dtype=jnp.bfloat16))(jnp.asarray(frames))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        g, w = g.float().numpy(), np.asarray(jnp.asarray(w, jnp.float32))
        err, scale = np.abs(g - w), np.abs(w).max()
        assert err.max() <= HEAD_MAX_TOL * scale, err.max() / scale
        assert err.mean() <= HEAD_MEAN_TOL * scale, err.mean() / scale
    dets = net.detect(frames)
    assert all(0 < d.score <= 1 for im in dets for d in im)


# a hand-made mixed graph: a [yolo] head at 32x32 (3,072 candidates) and a
# [yolov8] head beside it (1,024), past the 2,048 of the 64x64x3 arena
MIXED_CFG = """[net]
width=64
height=64
channels=3

[convolutional]
batch_normalize=1
filters=8
size=3
stride=2
pad=1
activation=leaky

[convolutional]
filters=21
size=1
stride=1
pad=0
activation=linear

[yolo]
mask = 0,1,2
anchors = 8,8, 16,16, 28,28, 40,40, 52,52, 60,60
classes=2
ignore_thresh = .35

[route]
layers=-3

[convolutional]
filters=34
size=1
stride=1
pad=0
activation=linear

[yolov8]
classes=2
reg_max=8
stride=2
conf=0.45
"""


def test_max_candidates(v8_160):
    """A pure-v8 graph's candidate count is its grid total (one a cell, no
    arena); a graph with a [yolo] head is clamped by the arena; both as
    JAX's ``_max_candidates``."""
    jir, tir, jp, tp = v8_160
    net = pt.Net(tir, tp, mode="parity", device="cpu")
    assert net._max_candidates() == sum((SIZE // s) ** 2
                                        for s in (8, 16, 32)) == 525
    assert not net._has_yolo_heads
    jnet = jt.Net.__new__(jt.Net)
    jnet.ir = jir
    assert jt.Net._max_candidates(jnet) == 525
    mir, mtir = jparse(MIXED_CFG, is_path=False), pt.parse_cfg(
        MIXED_CFG, is_path=False)
    mp = tload(mtir, pt.synth_weights_bytes(mtir, seed=3))[0]
    mnet = pt.Net(mtir, mp, mode="parity", device="cpu")
    jnet.ir = mir
    assert mnet._max_candidates() == jt.Net._max_candidates(jnet) == 2048


def _mixed_cfg(seed):
    """A random graph of tests/test_random_graphs.py (its [yolo] head),
    with a [yolov8] head on the blob before the yolo conv."""
    from test_random_graphs import SIZE as RSIZE, _gen_cfg
    rng = np.random.RandomState(3000 + seed)
    cfg = _gen_cfg(rng)
    ir = pt.parse_cfg(cfg, is_path=False)
    h = ir.blobs[len(ir.layers) - 2].h
    rm = int(rng.choice([4, 8, 16]))
    return cfg + "\n".join([
        "", "[route]", "layers=-3", "",
        "[convolutional]", f"filters={4 * rm + 2}", "size=1", "stride=1",
        "pad=0", "activation=linear", "",
        "[yolov8]", "classes=2", f"reg_max={rm}", f"stride={RSIZE // h}",
        "conf=0.45", ""]), RSIZE


@pytest.mark.parametrize("seed", range(2))
def test_mixed_graph_equals_jax(seed):
    """A random graph with both a [yolo] and a [yolov8] head (the mixed
    branch of JAX's pipeline: both decodes, the arena, min IoU at 0.5):
    pre-NMS candidates to 1e-4 and parity detections as JAX's."""
    cfg, size = _mixed_cfg(seed)
    jir, tir = jparse(cfg, is_path=False), pt.parse_cfg(cfg, is_path=False)
    assert {l.type.name for l in tir.layers} >= {"YOLO", "YOLOV8"}
    params = jload(jir, synth_weights_bytes(jir, seed=seed,
                                            obj_bias=1.5))[0]
    frames = _frames(size, 2, seed=seed)
    x = jpre.letterbox(jnp.asarray(frames), size, size)
    jfeats = jax.jit(lambda v: jbuild.forward_features(
        jir, jbuild.params_to_pytree(params), v,
        precision=jax.lax.Precision.HIGHEST))(x)
    tfeats = tbuild.forward_features(tir, tbuild.params_from_numpy(params),
                                     torch.from_numpy(np.asarray(x)))
    jheads = [l for l in jir.layers if l.type.name in ("YOLO", "YOLOV8")]
    want = jyolo.concat_heads([
        jyolo.decode_head_v8(f, l, size, size) if l.type.name == "YOLOV8"
        else jyolo.decode_head(f, l, size, size)
        for f, l in zip(jfeats, jheads)])
    got = tyolo.decode_heads(tir, tfeats, size, size)
    np.testing.assert_array_equal(got.classes.numpy(),
                                  np.asarray(want.classes))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores),
                               rtol=0, atol=1e-4)
    wb = np.asarray(want.boxes)
    np.testing.assert_allclose(got.boxes.numpy(), wb, rtol=0,
                               atol=1e-4 * np.abs(wb).max())
    tnet = pt.Net(tir, params, mode="parity", topk=256, device="cpu")
    jnet = jt.Net(jir, params, mode="parity", topk=256)
    assert tnet._max_candidates() == jnet._max_candidates()
    _assert_same_detections(tnet.detect(frames), jnet.detect(frames))


# --------------------------------------------------------------------- NMS
def test_union_iou_nms():
    """iou_kind='union' is the standard metric (the v8 policy): the port's
    nms against the oracle's use_min=False path and JAX's nms."""
    rng = np.random.RandomState(3)
    n = 40
    xy = rng.rand(n, 2) * 200
    wh = rng.rand(n, 2) * 80 + 10
    boxes = np.concatenate([xy, xy + wh], 1).astype(np.float32)
    scores = rng.rand(n).astype(np.float32)
    classes = rng.randint(0, 3, n)
    res = tnms.nms(torch.from_numpy(boxes)[None],
                   torch.from_numpy(scores)[None],
                   torch.from_numpy(classes)[None], k=n, threshold=0.5,
                   iou_kind="union")
    jres = jnms.nms(jnp.asarray(boxes)[None], jnp.asarray(scores)[None],
                    jnp.asarray(classes)[None], k=n, threshold=0.5,
                    iou_kind="union")
    for a, b in zip(res, jres):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    keep = res.scores[0].numpy() > 0
    got = sorted((float(s), int(c), *map(float, b)) for s, c, b in
                 zip(res.scores[0].numpy()[keep],
                     res.classes[0].numpy()[keep],
                     res.boxes[0].numpy()[keep]))
    o = numpy_ref.nms([(int(c), np.float32(s), *map(float, b))
                       for c, s, b in zip(classes, scores, boxes)],
                      0.5, False, 1, 1)
    want = sorted((float(s), int(c), *map(float, b)) for c, s, *b in o)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g[1] == w[1]
        np.testing.assert_allclose(g[:1] + g[2:], w[:1] + w[2:], atol=1e-3)


@pytest.mark.parametrize("k", [2048, 8400])
def test_union_keep_mask_at_v8n_k(k):
    """K2's plain version (what a CPU tensor takes) in union IoU at v8n's
    top-k ladder (8,400 = its 640x640 candidate count) against JAX's XLA
    scan, bit for bit, on candidates with equal scores and five classes."""
    rng = np.random.RandomState(k)
    xy = rng.randint(0, 640, (1, k, 2)).astype(np.float32)
    wh = rng.randint(0, 96, (1, k, 2)).astype(np.float32)
    boxes = np.concatenate([xy, xy + wh], -1)
    scores = rng.choice([0.3, 0.5, 0.75, 0.9], (1, k)).astype(np.float32)
    scores[rng.rand(1, k) < 0.2] = 0
    order = np.argsort(-scores, axis=1, kind="stable")
    boxes = np.take_along_axis(boxes, order[..., None], axis=1)
    scores = np.take_along_axis(scores, order, axis=1)
    classes = rng.randint(0, 5, (1, k)).astype(np.int32)
    want = np.asarray(jax.jit(lambda b, s, c: jnms._keep_mask_scan(
        b, s, c, k, 0.7, "union"))(boxes, scores, classes))
    got = tknms.nms_keep_mask(torch.from_numpy(boxes),
                              torch.from_numpy(scores),
                              torch.from_numpy(classes), threshold=0.7,
                              iou_kind="union")
    assert 0 < int(want.sum()) < int((scores > 0).sum())
    np.testing.assert_array_equal(got.numpy(), want)


def test_v8_nms_threshold_follows_the_flag(monkeypatch, v8_64):
    _, tir, _, tp = v8_64
    assert tnms.V8_NMS_THRESHOLD == jnms.V8_NMS_THRESHOLD == 0.7
    assert pt.Net(tir, tp, mode="parity", device="cpu")._v8_iou == 0.7
    monkeypatch.setenv("FFCNN_V8_NMS_IOU", "0.6")
    assert tnms.v8_nms_threshold() == jnms.v8_nms_threshold() == 0.6
    assert pt.Net(tir, tp, mode="parity", device="cpu")._v8_iou == 0.6


# ----------------------------------------------------------- serving paths
def test_detect_stream_pure_v8(v8_64):
    """detect_stream (depth 2) on a pure-v8 Net yields serial detect's
    detections, which equal JAX's."""
    jir, tir, jp, tp = v8_64
    net = pt.Net(tir, tp, mode="parity", device="cpu")
    rng = np.random.RandomState(11)
    batches = [rng.randint(0, 256, (2, 64, 64, 3), np.uint8)
               for _ in range(3)]
    got = list(net.detect_stream(iter(batches), depth=2))
    jnet = jt.Net(jir, jp, mode="parity")
    assert len(got) == 3
    for b, frames in zip(batches, got):
        assert frames == net.detect(b)
        _assert_same_detections(frames, jnet.detect(b))
    assert sum(len(d) for f in got for d in f) > 0


def test_warmup_topk_ladder_pure_v8(v8_64):
    """warmup(topk_ladder=True) builds the K buckets up to the grid total
    (84 at 64x64: no arena), as JAX's ladder does."""
    _, tir, _, tp = v8_64
    net = pt.Net(tir, tp, mode="parity", topk=16, device="cpu")
    net.warmup(topk_ladder=True)
    assert sorted(k[3] for k in net._pipelines) == [16, 64, 84]


def test_serving_pure_v8(v8_64, tmp_path):
    """The HTTP server answers for a pure-v8 Net as net.detect does."""
    _, tir, _, tp = v8_64
    net = pt.Net(tir, tp, mode="parity", device="cpu")
    service = DetectorService(net, max_batch=1)
    srv = make_server(service, "127.0.0.1", 0)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        service.warmup()
        img = np.random.RandomState(5).randint(0, 256, (64, 64, 3),
                                               dtype=np.uint8)
        p = str(tmp_path / "in.bmp")
        bmp_save(p, img)
        with open(p, "rb") as f:
            body = f.read()
        url = "http://127.0.0.1:%d/detect" % srv.server_address[1]
        req = urllib.request.Request(url, data=body, method="POST")
        dets = json.loads(urllib.request.urlopen(req).read())["detections"]
        want = net.detect(img)
        assert len(dets) == len(want) > 0
        for d, w in zip(dets, want):
            assert d["class_id"] == w.class_id
            assert abs(d["score"] - w.score) < 1e-3
            assert [round(v, 2) for v in d["box"]] == \
                [round(v, 2) for v in (w.x1, w.y1, w.x2, w.y2)]
    finally:
        srv.shutdown()
        srv.server_close()
        service._batcher.close()


# ----------------------------------------------------- converter entry points
@pytest.fixture(scope="module")
def sd_file(sd, tmp_path_factory):
    path = tmp_path_factory.mktemp("v8") / "v8n_sd.pt"
    torch.save({k: torch.as_tensor(v) for k, v in sd.items()}, path)
    return str(path)


def test_cli_convert_v8_equals_jax(sd_file, tmp_path, capsys):
    """cli convert-v8 writes the same two files as ffcnn_tpu.cli's; detect
    on the CPU serves them."""
    args = ["--size", "160", "--conf", "0.05"]
    assert tcli.main(["convert-v8", sd_file, "-o", str(tmp_path / "t"),
                      *args]) == 0
    assert jcli_main(["convert-v8", sd_file, "-o", str(tmp_path / "j"),
                      *args]) == 0
    for ext in (".cfg", ".weights"):
        with open(tmp_path / ("t" + ext), "rb") as a, \
                open(tmp_path / ("j" + ext), "rb") as b:
            assert a.read() == b.read(), ext
    out = capsys.readouterr().out
    assert "3 v8 heads" in out
    img = str(tmp_path / "in.bmp")
    bmp_save(img, _frames(160, 1, seed=5)[0])
    assert tcli.main(["detect", img, "--cfg", str(tmp_path / "t.cfg"),
                      "--weights", str(tmp_path / "t.weights"), "--mode",
                      "parity", "-o", str(tmp_path / "o.bmp"),
                      "--device", "cpu"]) == 0
    assert "times inference" in capsys.readouterr().out


def test_load_from_a_saved_state_dict(sd, sd_file):
    """yolov8.load reads a torch.save'd plain state dict (weights_only) and
    gives the Net the dict gives; a non-dict file is refused."""
    a = ty.load(sd_file, NC, SCALE, size=64, conf=0.05, mode="parity",
                device="cpu")
    b = ty.load(sd, NC, SCALE, size=64, conf=0.05, mode="parity",
                device="cpu")
    img = _frames(64, 2, seed=6)
    assert a.device.type == "cpu" and a.detect(img) == b.detect(img)
    bad = os.path.join(os.path.dirname(sd_file), "list.pt")
    torch.save([torch.zeros(2)], bad)
    with pytest.raises(ValueError, match="plain state dict"):
        ty.load(bad, device="cpu")


def test_load_defaults_to_the_card(sd):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        ty.load(sd, NC, SCALE, size=64)


def test_torch_differential(sd):
    """The independent torch nn model of tools/torch_yolov8_ref.py and the
    port's float32 forward give the same raw head maps and the same
    candidates on every cell (conf 0: no threshold edge)."""
    torch_ref = pytest.importorskip("torch_yolov8_ref")
    model = torch_ref.build_model(sd, NC, SCALE)
    x = np.random.RandomState(7).rand(SIZE, SIZE, 3).astype(np.float32)
    raws = torch_ref.forward_heads(model, x)
    cfg0, w0 = ty.convert(sd, NC, SCALE, size=SIZE, conf=0.0)
    ir0 = pt.parse_cfg(cfg0, is_path=False)
    params = tbuild.params_from_numpy(tload(ir0, w0)[0])
    feats = tbuild.forward_features(ir0, params, torch.from_numpy(x)[None])
    for f, r in zip(feats, raws):
        np.testing.assert_allclose(f[0].numpy(), r, rtol=0,
                                   atol=1e-4 * np.abs(r).max())
    got = tyolo.decode_heads(ir0, feats, SIZE, SIZE)
    want = torch_ref.decode(raws, NC, conf=0.0)
    assert got.scores.shape[1] == len(want) == 525
    np.testing.assert_array_equal(got.classes[0].numpy(),
                                  [w[0] for w in want])
    np.testing.assert_allclose(got.scores[0].numpy(),
                               [float(w[1]) for w in want], atol=1e-3)
    np.testing.assert_allclose(got.boxes[0].numpy(),
                               [w[2:] for w in want], atol=1e-2)


def test_candidates_fn_equals_jax(v8_64):
    """The pre-NMS candidate program (letterbox, float32 forward,
    decode_head_v8) equals JAX's candidates_fn."""
    jir, tir, jp, tp = v8_64
    img = _frames(64, 2, seed=8)
    want = jax.jit(jy.candidates_fn(jir, 64))(jbuild.params_to_pytree(jp),
                                              jnp.asarray(img))
    got = ty.candidates_fn(tir, 64)(tbuild.params_from_numpy(tp),
                                    torch.from_numpy(img))
    np.testing.assert_array_equal(got.classes.numpy(),
                                  np.asarray(want.classes))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores),
                               atol=1e-5)
    wb = np.asarray(want.boxes)
    np.testing.assert_allclose(got.boxes.numpy(), wb,
                               atol=1e-4 * np.abs(wb).max())


def test_int8_on_v8(v8_64):
    """int8 on a v8 graph (tests/test_yolov8.py::test_int8_plan_on_v8):
    the plan keeps the six box/cls 1x1 convs behind the concat routes and
    the blobs that feed the decode float, as JAX's does; the calibrated
    Net's plan has JAX's blobs and convs, and it detects."""
    from ffcnn_tpu import quant as jq
    from ffcnn_tpu_torch import quant as tq
    ir, tir, params, tp = v8_64
    img = (np.random.RandomState(3).rand(64, 64, 3) * 255).astype(np.uint8)
    net = pt.Net(tir, tp, mode="int8", device="cpu")
    net.calibrate(img[None])
    blobs, convs = tq._head_protect(tir)
    assert (blobs, convs) == jq._head_protect(ir) and len(convs) == 6
    assert not set(net.quant.weights) & convs
    assert not set(net.quant.blob_scale) & blobs
    assert net.quant.weights and net.quant.blob_scale
    want = jq.calibrate(ir, jbuild.params_to_pytree(params), img[None])
    assert sorted(net.quant.blob_scale) == sorted(want.blob_scale)
    assert sorted(net.quant.weights) == sorted(want.weights)
    assert isinstance(net.detect(img), list)


# ------------------------------------------------- still refused, by name

@pytest.mark.parametrize("argv,item", [
    (["export", "out.pt2"], None),             # test_export_artifact_v8
    (["bench", "--dp"], "M14"),                # test_dp_sharded_pipeline_v8
    (["bench", "--sp", "2"], "M14"),           # test_pp_pipeline_v8
], ids=["export", "dp", "pp"])
def test_v8_refusals_name_their_item(argv, item, sd, tmp_path, capsys,
                                     monkeypatch):
    """``bench --dp`` and ``--sp`` on converted v8 files, refused before,
    naming ROADMAP M14, are ported: each prints its line over two CPU
    slots (the mesh's devices, one CPU slot with ``--device cpu``, made
    two here), and (tests/test_yolov8.py's test_dp_sharded_pipeline_v8 and
    test_pp_pipeline_v8) the sharded pipeline on 8 data slots and the
    GPipe pipeline over 4 stages, every v8 head in the last, give the
    parity Net's detections (DFL decode, union NMS).  ``export`` (M15),
    refused before, is ported: the v8 artifact reproduces the Net's bucket
    bit for bit, as test_export_artifact_v8 holds JAX's."""
    cfg, wbytes = ty.convert(sd, NC, SCALE, size=64)
    (tmp_path / "v8.cfg").write_text(cfg)
    (tmp_path / "v8.weights").write_bytes(wbytes)
    if item is None:
        from ffcnn_tpu_torch import export as ex
        out = str(tmp_path / argv[1])
        assert tcli.main(argv[:1] + [out, "--cfg", str(tmp_path / "v8.cfg"),
                                     "--weights", str(tmp_path / "v8.weights"),
                                     "--device", "cpu"]) == 0
        art = ex.load_exported(out)
        assert art.meta["custom_ops"] == ["ffcnn::nms_keep_mask.default"]
        x = np.random.RandomState(3).randint(0, 256, (1, 64, 64, 3),
                                             dtype=np.uint8)
        net = pt.Net.load(str(tmp_path / "v8.cfg"), str(tmp_path /
                                                        "v8.weights"),
                          mode="fast", device="cpu")
        assert all(torch.equal(a, b) for a, b in
                   zip(art.call(x), net.detect_device(x)))
        return
    from ffcnn_tpu_torch.parallel import mesh
    monkeypatch.setattr(mesh, "slot_devices",
                        lambda device: [torch.device(device)] * 2)
    assert tcli.main(argv + ["--cfg", str(tmp_path / "v8.cfg"), "--weights",
                             str(tmp_path / "v8.weights"), "--device", "cpu",
                             "--size", "64", "--batch", "2", "--iters",
                             "1"]) == 0
    assert capsys.readouterr().out.startswith("batch 2 @64x64 ")
    from ffcnn_tpu_torch import parallel as tpar
    from ffcnn_tpu_torch.darknet.ir import LayerType
    from ffcnn_tpu_torch.graph.build import params_from_numpy
    # the heads' score gate at 0.05: the synthetic class scores sit near 0.1
    _, tir, _, params = _graph(sd, 64, 0.05)
    images = _frames(64, 8, seed=4)[:, :48]
    cpu = [torch.device("cpu")]
    if item == "M14" and argv[1] == "--dp":
        fn, place = tpar.build_sharded_pipeline(
            tir, tpar.make_mesh(cpu * 8), 48, 64, dtype=torch.float32,
            topk=64)
        got = fn(place(params_from_numpy(params)), images, (0.0,) * 3,
                 (1 / 255.0,) * 3)
    else:
        stages = tpar.plan_stages(tir, 4)
        heads = {li for li, l in enumerate(tir.layers)
                 if l.type == LayerType.YOLOV8}
        assert heads <= set(range(stages[-1].start, stages[-1].stop))
        fn = tpar.build_pp_pipeline(
            tir, params_from_numpy(params),
            tpar.make_mesh(cpu * 4, pipeline_parallel=4), 48, 64,
            n_microbatches=4, topk=64)
        got = fn(images)
    want = pt.Net(tir, params, mode="parity", topk=64,
                  device="cpu").detect_device(images)
    assert int(want.count.sum()) > 0
    assert torch.equal(got.count, want.count)
    assert torch.equal(got.classes[want.scores > 0],
                       want.classes[want.scores > 0])
    torch.testing.assert_close(got.scores, want.scores, atol=1e-5, rtol=0)
    torch.testing.assert_close(got.boxes[want.scores > 0],
                               want.boxes[want.scores > 0], atol=1e-3,
                               rtol=0)


# -------------------------------------------------------------- the bench
def test_bench_on_converted_v8_files(sd, tmp_path, capsys):
    """The port's bench serves convert-v8's files (on the CPU here): the
    candidate parity gate (a synthesized v8n ties scores), the fast gate,
    then one JSON line."""
    from ffcnn_tpu_torch import bench
    cfg, wbytes = ty.convert(sd, NC, SCALE, size=64, conf=0.05)
    (tmp_path / "v8.cfg").write_text(cfg)
    (tmp_path / "v8.weights").write_bytes(wbytes)
    row = bench.main(["--cfg", str(tmp_path / "v8.cfg"), "--weights",
                      str(tmp_path / "v8.weights"), "--device", "cpu",
                      "--batches", "2", "--windows", "1", "--iters", "1",
                      "--parity-gate", "candidates"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == json.loads(json.dumps(row))
    assert line["metric"] == "v8 64x64 pixels-to-boxes throughput"
    assert line["gflop_per_image"] > 0 and line["mfu"] is None
    assert line["gates"].startswith("parity candidates")


def test_parity_candidates_gate(v8_64):
    """bench.parity_candidates passes two Nets of one model and refuses
    two whose forwards differ."""
    from ffcnn_tpu_torch.bench import parity_candidates
    _, tir, _, tp = v8_64
    frames = _frames(64, 2, seed=9)
    a = pt.Net(tir, tp, mode="parity", device="cpu")
    assert parity_candidates(a, pt.Net(tir, tp, mode="parity",
                                       device="cpu"), frames) > 0
    other = {li: dataclasses.replace(p, bias=p.bias + 0.01)
             for li, p in tp.items()}
    with pytest.raises(AssertionError, match="parity gate"):
        parity_candidates(a, pt.Net(tir, other, mode="parity",
                                    device="cpu"), frames)


def test_roofline_equals_jax_on_v8():
    """roofline.py costs a v8 graph (SiLU convs, grouped routes, the
    [yolov8] heads) as JAX's: FLOPs and weight bytes equal, activation
    bytes JAX's plus the blobs JAX models as fused away by XLA
    (tests/test_torch_roofline.py's rule)."""
    from collections import defaultdict

    from ffcnn_tpu import roofline as jroof
    from ffcnn_tpu_torch import roofline as troof
    from test_torch_roofline import _xla_fused_away
    cfg, _ = ty.build_graph(NC, SCALE, size=640)
    jir, tir = jparse(cfg, is_path=False), pt.parse_cfg(cfg, is_path=False)
    for dtype in ("bf16", "f32"):
        want = jroof.layer_costs(jir, 4, dtype)
        got = troof.layer_costs(tir, 4, dtype)
        extra = defaultdict(int)
        for b in _xla_fused_away(tir, None):
            blob = tir.blobs[b]
            n = troof.stored_bytes(blob.w, blob.h, blob.c, 4, dtype)
            extra[b - 1] += n
            extra[b] += n
        assert extra
        for g, w in zip(got, want):
            assert (g.index, g.flops, g.vpu_flops, g.bytes_w) == \
                (w.index, w.flops, w.vpu_flops, w.bytes_w)
            assert g.bytes_act == w.bytes_act + extra[g.index]
    # v8n's published 8.7 GFLOPs at 640x640
    assert troof.model_flops(tir) == sum(
        c.flops + c.vpu_flops for c in jroof.layer_costs(jir, 1)) == \
        8742912000


@pytest.mark.parametrize("mode", ["parity", "fast"])
def test_forward_raw_equals_jax(v8_64, mode):
    """forward_raw (the unfused forward of a preprocessed input, in the
    net's dtype) on a v8 graph against JAX's."""
    jir, tir, jp, tp = v8_64
    x = np.random.RandomState(10).rand(2, 64, 64, 3).astype(np.float32)
    got = pt.Net(tir, tp, mode=mode, device="cpu").forward_raw(x)
    want = jt.Net(jir, jp, mode=mode).forward_raw(x)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        w = np.asarray(jnp.asarray(w, jnp.float32))
        g = g.float().numpy()
        scale = np.abs(w).max()
        if mode == "parity":
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4 * scale)
        else:
            err = np.abs(g - w)
            assert err.max() <= HEAD_MAX_TOL * scale
            assert err.mean() <= HEAD_MEAN_TOL * scale
