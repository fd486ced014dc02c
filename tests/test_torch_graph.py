"""The port's graph builder (``ffcnn_tpu_torch/graph/build.py``) against
the JAX package's on the CPU: segments (``start``, ``stop``, ``blobs_in``,
``keep_blobs``), the float32 layer sets and what the two float32 knobs
compute (mirrors ``tests/test_f32_stages.py``), per-blob parity on every
``models/*.cfg`` at ``tests/test_model_zoo.py``'s sizes, the random graphs
of ``tests/test_random_graphs.py`` (``[yolo]`` and ``[yolov8]`` heads), and
``tests/test_ops.py``'s oracle cases, all on seeded numpy inputs."""

import glob
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import ffcnn_tpu as jt
import ffcnn_tpu_torch as pt
from ffcnn_tpu.darknet import parse_cfg as jparse
from ffcnn_tpu.darknet.ir import Layer, LayerType as JLT
from ffcnn_tpu.darknet.weights import load_weights, synth_weights_bytes
from ffcnn_tpu.graph import build as jbuild
from ffcnn_tpu.kernels import block_fused as jbf
from ffcnn_tpu.kernels import head_fused as jhf
from ffcnn_tpu.ops import nms as jnms
from ffcnn_tpu.ops import pool as jpool
from ffcnn_tpu.ops import preprocess as jpre
from ffcnn_tpu.ops import yolo as jyolo
from ffcnn_tpu.oracle import numpy_ref
from ffcnn_tpu.parallel import plan_stages
from ffcnn_tpu_torch.darknet import parse_cfg as tparse
from ffcnn_tpu_torch.darknet.ir import Layer as TLayer, LayerType
from ffcnn_tpu_torch.graph import build as tbuild
from ffcnn_tpu_torch.ops import nms as tnms
from ffcnn_tpu_torch.ops import pool as tpool
from ffcnn_tpu_torch.ops import preprocess as tpre
from ffcnn_tpu_torch.ops import yolo as tyolo

from test_model_zoo import SIZES, TIE_PRONE
from test_random_graphs import SIZE as RSIZE, _gen_cfg
from ffcnn_tpu_torch.testing import cap_threads

cap_threads()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFGS = sorted(glob.glob(os.path.join(REPO, "models", "*.cfg")))
CFG_IDS = [os.path.splitext(os.path.basename(p))[0] for p in CFGS]
MICRO = os.path.join(REPO, "models", "ffcnn-micro.cfg")
XL = os.path.join(REPO, "models", "yolo-fastest-xl.cfg")
# float32 through the whole net in another sum order: 1e-4 of the range
F32_TOL = 1e-4
# bf16 blobs: one-ulp flips between two float32 sum orders, carried
# through the depth (test_torch_net.py's fast bounds)
BF16_MAX_TOL, BF16_MEAN_TOL = 2 ** -3, 2 ** -8


def _model(cfg, size, seed=42, is_path=True):
    jir = jparse(cfg, size, size, is_path=is_path)
    tir = tparse(cfg, size, size, is_path=is_path)
    params, _ = load_weights(jir, synth_weights_bytes(jir, seed=seed,
                                                      obj_bias=2.0))
    return jir, tir, params


def _frames(size, n, seed):
    return np.random.RandomState(seed).randint(0, 256, (n, size, size, 3),
                                               dtype=np.uint8)


def _jax_blobs(jir, params, x, **kw):
    """JAX's heads and every blob it materialises, from one jitted run."""
    keep = list(range(len(jir.layers) + 1))
    heads, blobs = jax.jit(lambda v: jbuild.forward_features(
        jir, params, v, keep_blobs=keep, **kw))(x)
    return heads, {i: v for i, v in blobs.items() if v is not None}


def _close(got, want, tol=F32_TOL, what=""):
    want = np.asarray(jnp.asarray(want, jnp.float32))
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * max(np.abs(want).max(), 1e-6),
                               err_msg=what)


# ----------------------------------------------------------------- segments
def _stage_cuts(jir, n):
    return [(s.start, s.stop, list(s.live_out))
            for s in plan_stages(jir, n)]


@pytest.mark.parametrize("cfg,size", [(MICRO, 64), (XL, 160)],
                         ids=["micro", "xl"])
def test_segments_compose_to_whole(cfg, size):
    """Parity forward in three segments (JAX's plan_stages cuts, each
    passing on its live blobs) equals the whole forward bit for bit, and
    each segment's heads and live blobs equal JAX's at the same cuts
    (mirrors tests/test_pp.py::TestSegmentedForward on in-repo inputs)."""
    jir, tir, params = _model(cfg, size)
    tp = tbuild.params_from_numpy(params)
    jp = jbuild.params_to_pytree(params)
    x = np.random.RandomState(3).rand(2, size, size, 3).astype(np.float32)
    whole = tbuild.forward_features(tir, tp, torch.from_numpy(x))
    cuts = _stage_cuts(jir, 3)
    assert len(cuts) == 3
    heads, tblobs, jblobs = [], {}, {}
    for i, (start, stop, live) in enumerate(cuts):
        assert live == tbuild.live_blobs(tir, stop) or i == 2
        h, tblobs = tbuild.forward_features(
            tir, tp, torch.from_numpy(x) if i == 0 else None, start=start,
            stop=stop, blobs_in=tblobs, keep_blobs=live)
        jh, jblobs = jax.jit(lambda v, b, s=start, e=stop, k=live:
                             jbuild.forward_features(
                                 jir, jp, v, start=s, stop=e, blobs_in=b,
                                 keep_blobs=k,
                                 precision=jax.lax.Precision.HIGHEST))(
            jnp.asarray(x) if i == 0 else None, jblobs)
        assert sorted(tblobs) == sorted(jblobs) == live
        for bi in live:
            _close(tblobs[bi], jblobs[bi], what=f"blob {bi} at {stop}")
        for a, b in zip(h, jh):
            _close(a, b, what=f"head of segment {i}")
        heads.extend(h)
    assert len(heads) == len(whole) > 0
    for a, b in zip(heads, whole):
        assert torch.equal(a, b)


def test_segments_default_to_the_whole_graph():
    _, tir, params = _model(MICRO, 64)
    tp = tbuild.params_from_numpy(params)
    x = torch.from_numpy(np.random.RandomState(4).rand(
        1, 64, 64, 3).astype(np.float32))
    whole = tbuild.forward_features(tir, tp, x)
    assert isinstance(whole, list)
    heads, kept = tbuild.forward_features(tir, tp, x, keep_blobs=[0, 5])
    assert all(torch.equal(a, b) for a, b in zip(heads, whole))
    assert sorted(kept) == [0, 5] and torch.equal(kept[0], x)


def _fast_net(tir, params, monkeypatch, flags):
    for k, v in flags.items():
        monkeypatch.setenv(k, v)
    net = pt.Net(tir, params, mode="fast", device="cpu")
    for k in flags:
        monkeypatch.delenv(k)
    return net


def _net_forward(net, x, **kw):
    """A fast Net's forward (folded params, its runs) through
    forward_features, with ``kw`` (segments, hooks) passed on."""
    p, c0 = net._folded_params(pt.DEFAULT_MEAN, pt.DEFAULT_NORM)
    return tbuild.forward_features(
        net.ir, p, x, input_dtype=torch.bfloat16,
        fused_runs=net._fused_runs, fused_params=net._fused_params,
        fused_groups=net._fused_groups, mega_runs=net._mega_runs,
        fused_mid_dtype=net._mid_dtype, head_runs=net._head_runs,
        head_params=net._head_params, conv0_pallas=c0 is not None,
        conv0_params=c0, f32_layers=net._f32_layers, **kw)


REGION_FLAGS = {"FFCNN_FUSED_DOWN": "1", "FFCNN_FUSED_MINC": "8",
                "FFCNN_CONV0_PALLAS": "1", "FFCNN_FUSED_HEADS": "1"}


def test_fused_segments_between_runs_compose(monkeypatch):
    """Fast mode with the region plan (stem, runs 1-80 and 81-108, head
    chain 116-120), cut between runs: the segments equal the whole."""
    _, tir, params = _model(XL, 64)
    net = _fast_net(tir, params, monkeypatch, REGION_FLAGS)
    assert net._conv0_pallas and net._head_runs
    x = torch.from_numpy(_frames(64, 2, seed=5))
    x = tpre.letterbox_uint8(x, 64, 64)
    whole = _net_forward(net, x)
    heads, blobs = [], {}
    for i, (start, stop) in enumerate(((0, 81), (81, 116),
                                       (116, len(tir.layers)))):
        live = tbuild.live_blobs(tir, stop)
        h, blobs = _net_forward(net, x if i == 0 else None, start=start,
                                stop=stop, blobs_in=blobs, keep_blobs=live)
        heads.extend(h)
    assert len(heads) == len(whole) == 2
    assert all(torch.equal(a, b) for a, b in zip(heads, whole))


@pytest.mark.parametrize("start,stop,what", [
    (0, 60, "fused run L1-L80"),          # inside the run at layer 1
    (90, 120, "fused run L81-L108"),      # a run straddles start
    (109, 118, "head chain L116-L120"),
    (0, 1, "stem"),                       # layer 0 alone, stem on
])
def test_straddling_segment_refused(start, stop, what, monkeypatch):
    _, tir, params = _model(XL, 64)
    net = _fast_net(tir, params, monkeypatch, REGION_FLAGS)
    x = tpre.letterbox_uint8(torch.from_numpy(_frames(64, 1, seed=6)),
                             64, 64)
    with pytest.raises(ValueError, match=what.split(" L")[0]) as e:
        _net_forward(net, x if start == 0 else None, start=start, stop=stop,
                     keep_blobs=[])
    assert what in str(e.value)


# --------------------------------------------------------- float32 knobs
@pytest.mark.parametrize("cfg_path", CFGS, ids=CFG_IDS)
def test_layer_sets_equal_jax(cfg_path):
    """stage_layer_set at every width of the graph and head_chain_layers
    equal JAX's."""
    jir, tir = jparse(cfg_path, 320, 320), tparse(cfg_path, 320, 320)
    widths = sorted({b.w for b in tir.blobs if b.w})
    for w in widths + [",".join(map(str, widths[:2]))]:
        assert tbuild.stage_layer_set(tir, str(w)) == \
            jbuild.stage_layer_set(jir, str(w))
    assert tbuild.head_chain_layers(tir) == jbuild.head_chain_layers(jir)
    assert tbuild.head_chain_layers(tir) or "micro" in cfg_path


KNOBS = {"head": {"FFCNN_HEAD_F32": "1"},
         "stage20": {"FFCNN_F32_STAGES": "20"},
         "both": {"FFCNN_HEAD_F32": "1", "FFCNN_F32_STAGES": "20"}}


def _jax_knob_plan(jir, flags):
    """The runs JAX's _build_pipeline traces under ``flags`` (block runs
    unless FFCNN_FUSED=0, head chains where FFCNN_FUSED_HEADS=1), from
    JAX's planners and sets, and its float32 set."""
    runs = [] if flags.get("FFCNN_FUSED") == "0" else jbf.plan_runs(jir)
    hruns = (jhf.plan_head_runs(jir)
             if flags.get("FFCNN_FUSED_HEADS") == "1" else [])
    f32set = None
    if flags.get("FFCNN_HEAD_F32") == "1":
        f32set, hruns = jbuild.head_chain_layers(jir), []
    if flags.get("FFCNN_F32_STAGES"):
        f32set = frozenset(jbuild.stage_layer_set(
            jir, flags["FFCNN_F32_STAGES"]) | set(f32set or ()))
        runs, hruns = ([r for r in rs if not any(
            li in f32set for li in range(r.start, r.end + 1))]
            for rs in (runs, hruns))
    return runs, hruns, f32set


@pytest.mark.parametrize("knob", list(KNOBS))
def test_f32_knob_plans_equal_jax(knob, monkeypatch):
    """yolo-fastest-xl at 320x320 with the head chains planned: the block
    runs and head chains a fast Net keeps, and its float32 set, equal what
    JAX's pipeline traces under the same knobs."""
    jir, tir, params = _model(XL, 320)
    flags = dict(KNOBS[knob], FFCNN_FUSED_HEADS="1")
    net = _fast_net(tir, params, monkeypatch, flags)
    runs, hruns, f32set = _jax_knob_plan(jir, flags)
    assert [(r.start, r.end) for r in net._fused_runs] == \
        [(r.start, r.end) for r in runs]
    assert [(r.start, r.end) for r in net._head_runs] == \
        [(r.start, r.end) for r in hruns]
    assert net._f32_layers == f32set and f32set
    assert (len(runs) < len(jbf.plan_runs(jir))) == (knob != "head")
    assert (hruns == []) == (knob != "stage20")


@pytest.mark.parametrize("knob", list(KNOBS))
def test_f32_knobs_equal_jax(knob, monkeypatch):
    """yolo-fastest-xl fast at 160x160 (stage 20: the blocks of the run at
    38-57): every blob equals JAX's in the same dtype, within the bf16
    tolerances; the forced blobs are float32, and the heads are float32
    exactly where the head chains are forced (a forced stage is local).
    ``both`` keeps its planned runs (the block runs, JAX's in interpret
    mode, one dropped; the head chains superseded); the other two run
    with no fused run (FFCNN_FUSED=0), so that JAX runs no interpreter."""
    jir, tir, params = _model(XL, 160)
    flags = dict(KNOBS[knob], **({"FFCNN_FUSED_HEADS": "1"} if knob == "both"
                                 else {"FFCNN_FUSED": "0"}))
    net = _fast_net(tir, params, monkeypatch, flags)
    runs, hruns, f32set = _jax_knob_plan(jir, flags)
    assert [(r.start, r.end) for r in net._fused_runs] == \
        [(r.start, r.end) for r in runs]
    assert net._head_runs == hruns == [] and net._f32_layers == f32set
    assert bool(runs) == (knob == "both")
    frames = _frames(160, 1, seed=7)
    tblobs = {}
    heads = _net_forward(net, tpre.letterbox_uint8(
        torch.from_numpy(frames), 160, 160),
        blob_hook=lambda i, v: tblobs.__setitem__(i, v))
    jp = jbuild.fold_input_transform(jir, jbuild.params_to_pytree(params),
                                     pt.DEFAULT_MEAN, pt.DEFAULT_NORM)
    jheads, jblobs = _jax_blobs(
        jir, jp, jpre.letterbox_uint8(jnp.asarray(frames), 160, 160),
        input_dtype=jnp.bfloat16, fused_runs=runs or None,
        fused_interpret=True, f32_layers=f32set)
    forced = {li + 1 for li in f32set}
    assert forced <= set(tblobs)
    for bi, v in tblobs.items():
        want = jblobs[bi]
        assert str(v.dtype).split(".")[-1] == str(want.dtype), bi
        assert v.dtype == torch.float32 or bi not in forced, bi
        g = v.float().numpy()
        w = np.asarray(jnp.asarray(want, jnp.float32))
        err, scale = np.abs(g - w), max(np.abs(w).max(), 1e-6)
        assert err.max() <= BF16_MAX_TOL * scale, (bi, err.max() / scale)
        assert err.mean() <= BF16_MEAN_TOL * scale, (bi, err.mean() / scale)
    if knob == "stage20":              # the next stage is bf16 again
        assert any(v.dtype == torch.bfloat16 for bi, v in tblobs.items()
                   if bi > max(forced))
    for h, jh in zip(heads, jheads):
        assert (h.dtype == torch.float32) == (knob != "stage20") == \
            (jh.dtype == jnp.float32)


def test_f32_knobs_reach_the_pipeline(monkeypatch):
    """Net.detect under both knobs runs and differs from the plain fast
    Net's heads only by rounding; the roofline follows the dropped plan."""
    _, tir, params = _model(XL, 160)
    plain = _fast_net(tir, params, monkeypatch, {})
    net = _fast_net(tir, params, monkeypatch, KNOBS["both"])
    frames = torch.from_numpy(_frames(160, 1, seed=8))
    for a, b in zip(net.forward_heads(frames), plain.forward_heads(frames)):
        assert a.dtype == torch.float32 and b.dtype == torch.bfloat16
        _close(a, b.float(), tol=BF16_MAX_TOL)
    assert isinstance(net.detect(frames.numpy()), list)
    costs = {c.index: c for c in net.roofline_costs(1)}
    dropped = {li for r in plain._fused_runs for li in range(r.start + 1,
                                                             r.end + 1)
               if not any(q.start <= li <= q.end for q in net._fused_runs)}
    assert dropped and all(costs[li].bytes_act > 0 for li in dropped
                           if tir.layers[li].type == LayerType.CONV)


# ------------------------------------------------------------------ zoo
@pytest.mark.parametrize("cfg_path", CFGS, ids=CFG_IDS)
def test_zoo_blobs_equal_jax(cfg_path):
    """Every blob of the parity forward equals JAX's (HIGHEST precision)
    at test_model_zoo.py's sizes, to 1e-4 of its range; detections equal
    JAX's parity detections, except yolov4's (TIE_PRONE there: deep
    synthetic nets tie scores), which are held on the pre-NMS candidates."""
    name = os.path.splitext(os.path.basename(cfg_path))[0]
    size = SIZES.get(name, 160)
    jir, tir, params = _model(cfg_path, size)
    img = _frames(size, 1, seed=0)
    x = jpre.letterbox(jnp.asarray(img), size, size)
    jheads, jblobs = _jax_blobs(jir, jbuild.params_to_pytree(params), x,
                                precision=jax.lax.Precision.HIGHEST)
    tblobs = {}
    theads = tbuild.forward_features(
        tir, tbuild.params_from_numpy(params), torch.from_numpy(
            np.asarray(x)), blob_hook=lambda i, v: tblobs.__setitem__(i, v))
    assert sorted(tblobs) == sorted(i for i in jblobs if i)
    for i in tblobs:
        _close(tblobs[i], jblobs[i], what=f"blob {i}")
    got = tyolo.decode_heads(tir, theads, size, size)
    want = jyolo.concat_heads([jyolo.decode_head(f, l, size, size)
                               for f, l in zip(jheads, jir.yolo_layers)])
    if name in TIE_PRONE:
        live = np.asarray(want.scores) > 0
        assert live.any()
        np.testing.assert_array_equal(got.scores.numpy() > 0, live)
        _close(got.scores, want.scores, what="scores")
        np.testing.assert_array_equal(got.classes.numpy()[live],
                                      np.asarray(want.classes)[live])
        return
    # the parity pipeline's tail on each side's candidates: the arena, the
    # top-k and min-IoU NMS at 0.5 (Net.detect's, without a second compile
    # of the forward)
    cap = jyolo.arena_capacity(size, size, 3)
    got = tnms.nms(*tyolo.apply_arena_cap(got, cap), k=128, threshold=0.5)
    want = jnms.nms(*jyolo.apply_arena_cap(want, cap), k=128, threshold=0.5)
    assert int(got.count[0]) == int(want.count[0]) > 0
    # paired as sets: synthetic weights give near-equal scores, which
    # float32 noise may order either way
    gl = got.scores[0].numpy() > 0
    wl = np.asarray(want.scores[0]) > 0
    free = list(zip(np.asarray(want.classes[0])[wl],
                    np.asarray(want.scores[0])[wl],
                    np.asarray(want.boxes[0])[wl].astype(int).tolist()))
    for g in zip(got.classes[0].numpy()[gl], got.scores[0].numpy()[gl],
                 got.boxes[0].numpy()[gl].astype(int).tolist()):
        w = next(w for w in free if w[0] == g[0] and w[2] == g[2]
                 and abs(w[1] - g[1]) <= 1e-4)
        free.remove(w)


# ----------------------------------------------------------- random graphs
@pytest.mark.parametrize("head", ["yolo", "yolov8"])
@pytest.mark.parametrize("seed", range(4))
def test_random_graph_equals_jax(seed, head):
    """tests/test_random_graphs.py's generator (its seeds), both head
    types: the pre-NMS candidates of the parity forward equal JAX's
    (classes, scores to 1e-4, boxes to 1e-4 of their range); a score may
    sit on the other side of the gate only within 1e-4 of it."""
    rng = np.random.RandomState((2000 if head == "yolov8" else 1000) + seed)
    cfg = _gen_cfg(rng, head=head)
    jir, tir, params = _model(cfg, 0, seed=seed, is_path=False)
    img = rng.randint(0, 256, (2, RSIZE, RSIZE, 3), dtype=np.uint8)
    x = jpre.letterbox(jnp.asarray(img), RSIZE, RSIZE)
    jheads, _ = _jax_blobs(jir, jbuild.params_to_pytree(params), x,
                           precision=jax.lax.Precision.HIGHEST)
    theads = tbuild.forward_features(tir, tbuild.params_from_numpy(params),
                                     torch.from_numpy(np.asarray(x)))
    layer = [l for l in jir.layers if l.type.name == head.upper()][0]
    dec = jyolo.decode_head_v8 if head == "yolov8" else jyolo.decode_head
    want = dec(jheads[0], layer, RSIZE, RSIZE)
    got = tyolo.decode_heads(tir, theads, RSIZE, RSIZE)
    ws, gs = np.asarray(want.scores), got.scores.numpy()
    both = (ws > 0) == (gs > 0)
    edge = np.abs(np.maximum(ws, gs) - layer.ignore_thres) <= 1e-4
    assert np.all(both | edge), cfg
    np.testing.assert_allclose(gs[both], ws[both], atol=1e-4, err_msg=cfg)
    np.testing.assert_array_equal(got.classes.numpy(),
                                  np.asarray(want.classes), err_msg=cfg)
    wb = np.asarray(want.boxes)
    np.testing.assert_allclose(got.boxes.numpy(), wb, rtol=0,
                               atol=1e-4 * np.abs(wb).max(), err_msg=cfg)


# ----------------------------------------------- tests/test_ops.py's cases
@pytest.mark.parametrize("fs,stride", [(3, 1), (5, 1), (9, 1), (2, 2),
                                       (3, 2), (2, 1)])
@pytest.mark.parametrize("is_max", [True, False])
def test_pool_equals_jax_and_oracle(fs, stride, is_max):
    rng = np.random.RandomState(fs * 10 + stride)
    for (h, w) in [(14, 10), (7, 9), (5, 5)]:
        x = rng.randn(h, w, 6).astype(np.float32)
        f = tpool.maxpool2d if is_max else tpool.avgpool2d
        jf = jpool.maxpool2d if is_max else jpool.avgpool2d
        got = f(torch.from_numpy(x)[None], fs, stride)[0].numpy()
        # max is exact; a clipped average sums in another order (1 ulp)
        np.testing.assert_allclose(
            got, np.asarray(jf(jnp.asarray(x)[None], fs, stride)[0]),
            rtol=0 if is_max else 1e-6, atol=0 if is_max else 1e-7)
        np.testing.assert_allclose(
            got, numpy_ref.pool_forward(x, fs, stride, is_max), atol=1e-6)


def test_upsample_equals_jax_and_oracle():
    x = np.random.RandomState(1).randn(7, 5, 3).astype(np.float32)
    got = tpool.upsample_nearest(torch.from_numpy(x)[None], 2)[0].numpy()
    np.testing.assert_array_equal(got, numpy_ref.upsample_forward(x, 2))
    np.testing.assert_array_equal(got, np.asarray(jpool.upsample_nearest(
        jnp.asarray(x)[None], 2)[0]))


@pytest.mark.parametrize("img_hw,net_hw", [
    ((424, 640), (448, 640)), ((100, 50), (64, 64)),
    ((50, 100), (64, 64)), ((64, 64), (64, 64))])
def test_letterbox_equals_jax_and_oracle(img_hw, net_hw):
    (h, w), (nh, nw) = img_hw, net_hw
    bgr = np.random.RandomState(h + w).randint(0, 255, (h, w, 3)
                                               ).astype(np.uint8)
    mean, norm = (1.0, 2.0, 3.0), (0.5, 0.25, 0.125)
    got = tpre.letterbox(torch.from_numpy(bgr)[None], nw, nh, mean,
                         norm)[0].numpy()
    np.testing.assert_array_equal(got, np.asarray(jpre.letterbox(
        jnp.asarray(bgr)[None], nw, nh, mean, norm)[0]))
    want, _, _ = numpy_ref.letterbox(bgr, nw, nh, mean, norm)
    np.testing.assert_allclose(got, want, atol=1e-6)


def _layers(kind):
    kw = dict(class_num=80, anchors=((12, 18), (37, 49), (52, 132)),
              ignore_thres=0.45, scale_x_y=1.0) if kind == "yolo" else \
        dict(class_num=80, reg_max=16, stride=32, ignore_thres=0.25)
    t = LayerType.YOLO if kind == "yolo" else LayerType.YOLOV8
    j = JLT.YOLO if kind == "yolo" else JLT.YOLOV8
    return TLayer(index=0, type=t, **kw), Layer(index=0, type=j, **kw)


@pytest.mark.parametrize("kind", ["yolo", "yolov8"])
def test_decode_equals_jax_and_oracle(kind):
    tl, jl = _layers(kind)
    rng = np.random.RandomState(42)
    c = 3 * 85 if kind == "yolo" else 4 * 16 + 80
    feat = (rng.randn(6, 4, c) * 2).astype(np.float32)
    if kind == "yolov8":
        feat[..., 64:] -= 3.0
    dec = tyolo.decode_head if kind == "yolo" else tyolo.decode_head_v8
    jdec = jyolo.decode_head if kind == "yolo" else jyolo.decode_head_v8
    odec = (numpy_ref.yolo_decode if kind == "yolo"
            else numpy_ref.yolov8_decode)
    got = dec(torch.from_numpy(feat)[None], tl, 320, 320)
    want = jdec(jnp.asarray(feat)[None], jl, 320, 320)
    np.testing.assert_array_equal(got.classes.numpy(),
                                  np.asarray(want.classes))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores),
                               atol=1e-6)
    # boxes: exp and logsumexp from two libraries (test_torch_yolov8.py's
    # decode tolerance)
    wb = np.asarray(want.boxes)
    np.testing.assert_allclose(got.boxes.numpy(), wb, rtol=0,
                               atol=1e-4 * np.abs(wb).max())
    scores, boxes = got.scores[0].numpy(), got.boxes[0].numpy()
    kept = np.flatnonzero(scores > 0)
    oracle = odec(feat, jl, 320, 320)
    assert len(kept) == len(oracle) > 0
    for idx, (cls, score, x1, y1, x2, y2) in zip(kept, oracle):
        assert got.classes[0, idx] == cls
        np.testing.assert_allclose(scores[idx], score, atol=1e-5)
        np.testing.assert_allclose(boxes[idx], [x1, y1, x2, y2], atol=1e-3,
                                   rtol=1e-5)


def test_nms_equals_jax_and_oracle():
    """Greedy min-IoU NMS with the rescale, as test_nms_vs_oracle."""
    rng = np.random.RandomState(42)
    n = 60
    centers = rng.rand(n, 2) * 100
    sizes = rng.rand(n, 2) * 40 + 5
    boxes = np.concatenate([centers - sizes / 2, centers + sizes / 2],
                           axis=1).astype(np.float32)
    scores = rng.rand(n).astype(np.float32)
    scores[rng.rand(n) < 0.3] = 0.0
    classes = rng.randint(0, 3, n)
    res = tnms.nms(torch.from_numpy(boxes)[None],
                   torch.from_numpy(scores)[None],
                   torch.from_numpy(classes)[None], k=64, threshold=0.5,
                   scale1=7, scale2=3)
    jres = jnms.nms(jnp.asarray(boxes)[None], jnp.asarray(scores)[None],
                    jnp.asarray(classes)[None], k=64, threshold=0.5,
                    scale1=7, scale2=3)
    # the kept slots as JAX's (the empty slots' boxes follow each sort's
    # order of the zero scores)
    live = np.asarray(jres.scores) > 0
    for f in ("scores", "count", "saturated"):
        np.testing.assert_array_equal(getattr(res, f).numpy(),
                                      np.asarray(getattr(jres, f)))
    for f in ("classes", "boxes"):
        np.testing.assert_array_equal(getattr(res, f).numpy()[live],
                                      np.asarray(getattr(jres, f))[live])
    want = numpy_ref.nms([(int(classes[i]), scores[i], *boxes[i])
                          for i in range(n) if scores[i] > 0], 0.5, True,
                         7, 3)
    ks = res.scores[0].numpy()
    got = [(int(res.classes[0, i]), ks[i], *res.boxes[0, i].numpy())
           for i in range(len(ks)) if ks[i] > 0]
    assert int(res.count[0]) == len(want) == len(got)
    for g, w in zip(got, want):
        assert g[0] == w[0]
        np.testing.assert_allclose(g[1], w[1], atol=1e-6)
        np.testing.assert_allclose(g[2:], w[2:], atol=1e-3)
