"""AOT export on a par with the JAX package's (``ffcnn_tpu_torch/export.py``
against ``ffcnn_tpu/export.py``), on the CPU: the ``platforms`` argument of
``export_net``, ``Net.export`` and ``cli export --platforms`` (the sidecar,
``ExportedNet.platforms``, ``ArtifactNet.dump`` as JAX's), the loader's
choice of program, and export under the float32 knobs, whose forced convs
are the op ``ffcnn::conv2d_f32`` (micro for the platforms, xl at batch 1
for the knobs).  A file with a card program and a CPU program is written
only on the card; ``chip_smoke.py`` phase 13 covers it."""

import json
import os

import numpy as np
import pytest
import torch

import ffcnn_tpu_torch as pt
from ffcnn_tpu_torch import export as ex
from ffcnn_tpu_torch.kernels import ops
from ffcnn_tpu_torch.ops import conv as oc
from ffcnn_tpu_torch.runtime import to_detections
from ffcnn_tpu_torch.testing import cap_threads

cap_threads()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MICRO = os.path.join(REPO, "models", "ffcnn-micro.cfg")
XL = os.path.join(REPO, "models", "yolo-fastest-xl.cfg")
# the knob sets of tests/test_torch_graph.py, with the head chains planned
# (so that K7 is in the stage-20 program)
KNOBS = {"head": {"FFCNN_HEAD_F32": "1"},
         "stage20": {"FFCNN_F32_STAGES": "20"},
         "both": {"FFCNN_HEAD_F32": "1", "FFCNN_F32_STAGES": "20"}}
HEADS = {"FFCNN_FUSED_HEADS": "1"}
# fast mode's bound (chip_smoke.py phase 4): 90% of each side's detections
# have a same-class candidate of the other side within 4 px and 0.02 in
# score (bf16 drift reorders near-equal scores, so top-k and greedy NMS
# may keep another member of a cluster)
MATCH_PX, MATCH_SCORE, MATCH_FRAC = 4.0, 0.02, 0.9


def _weights(path, cfg, seed):
    with open(path, "wb") as f:
        f.write(pt.synth_weights_bytes(pt.parse_cfg(cfg), seed=seed,
                                       obj_bias=2.0))
    return str(path)


def _net(cfg, wpath, flags=None, mode="fast"):
    with pytest.MonkeyPatch.context() as mp:
        for k, v in (flags or {}).items():
            mp.setenv(k, v)
        return pt.Net.load(cfg, wpath, mode=mode, device="cpu")


def _frames(net, n, seed):
    h, w = net.ir.blobs[0].h, net.ir.blobs[0].w
    return np.random.RandomState(seed).randint(0, 256, (n, h, w, 3),
                                               dtype=np.uint8)


def _same(got, want):
    for a, b, nm in zip(got, want,
                        ("boxes", "scores", "classes", "count", "sat")):
        assert torch.equal(a, b), nm


def _frac(dets, cands):
    """Fast mode's detection bound (``chip_smoke.py`` phase 4): the share
    of one image's ``dets`` with a same-class candidate (decoded, before
    NMS; ``cands``: that image's boxes, scores, classes) within MATCH_PX
    and MATCH_SCORE."""
    boxes, scores, classes = (np.asarray(t, np.float32) for t in cands)
    live = scores > 0
    boxes, scores, classes = boxes[live], scores[live], classes[live]
    if not dets:
        return 1.0
    return sum(bool(np.any((classes == d.class_id)
                           & (np.abs(boxes - np.asarray(d[2:])).max(1)
                              <= MATCH_PX)
                           & (np.abs(scores - d.score) <= MATCH_SCORE)))
               for d in dets) / len(dets)


@pytest.fixture(scope="module")
def micro(tmp_path_factory):
    """A fast micro Net and its artifact exported with platforms=["cpu"]."""
    d = tmp_path_factory.mktemp("platforms")
    wpath = _weights(d / "micro.weights", MICRO, 7)
    net = _net(MICRO, wpath)
    path = str(d / "micro.pt2")
    assert net.export(path, batch_size=2, platforms=["cpu"]) == \
        os.path.getsize(path)
    return net, wpath, path, d


# ------------------------------------------------------------- platforms
def test_cpu_platform_roundtrip(micro):
    """platforms=["cpu"] writes one program that replays Net.detect bit for
    bit, and the loaded artifact reports its platforms as JAX's does."""
    net, _, path, _ = micro
    art = ex.load_exported(path)
    assert art.platforms == ("cpu",) and art.device.type == "cpu"
    frames = _frames(net, 2, 3)
    _same(art.call(frames), net.detect_device(frames))
    assert to_detections(art.call(frames)) == net.detect(frames)
    with open(ex.meta_path(path)) as f:
        meta = json.load(f)
    assert meta["platforms"] == ["cpu"] and meta["device"] == "cpu"
    assert meta["probe"]["expected_by_platform"] == {
        "cpu": meta["probe"]["expected"]}


def test_sidecar_platforms_match_jax(micro, monkeypatch):
    """The sidecar's ``platforms`` equals the one JAX's export_net writes
    for the same micro model and platforms, under the same key."""
    from ffcnn_tpu import Net as JNet
    from ffcnn_tpu import export as jex

    _, wpath, path, d = micro
    jpath = str(d / "micro.jax")
    jex.export_net(JNet.load(MICRO, wpath, mode="fast"), jpath,
                   batch_size=2, platforms=["cpu"])
    with open(jex.meta_path(jpath)) as f, open(ex.meta_path(path)) as g:
        assert json.load(f)["platforms"] == json.load(g)["platforms"] \
            == ["cpu"]
    assert jex.load_exported(jpath).platforms == \
        ex.load_exported(path).platforms


def test_dump_names_platforms_as_jax(micro):
    """ArtifactNet.dump() ends each artifact's line with its platforms, in
    the words of JAX's dump."""
    from ffcnn_tpu import Net as JNet
    from ffcnn_tpu import export as jex

    _, wpath, path, d = micro
    jpath = str(d / "dump.jax")
    jex.export_net(JNet.load(MICRO, wpath, mode="fast"), jpath,
                   batch_size=2, platforms=["cpu"])
    (jline,) = jex.ArtifactNet([jpath]).dump().splitlines()[1:]
    (line,) = ex.ArtifactNet([path]).dump().splitlines()[1:]
    tail = jline[jline.index("platforms"):]
    assert tail == "platforms cpu" and line.endswith("  " + tail)
    assert "device cpu  mode fast" in line


@pytest.mark.parametrize("platforms", [["tpu"], ["rocm"], ["cpus"], "gpu",
                                       ["cpu", "cpu"], []],
                         ids=["tpu", "rocm", "typo", "str", "twice",
                              "empty"])
def test_unknown_platforms_refused(micro, platforms):
    """A platform the port cannot export for raises ValueError naming the
    accepted ones, before anything is written."""
    net, _, _, d = micro
    path = str(d / "refused.pt2")
    with pytest.raises(ValueError, match=r"\['cuda', 'cpu'\]"):
        net.export(path, platforms=platforms)
    assert not os.path.exists(path)


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_cuda_platform_needs_the_card(micro):
    """A card program is traced on the card: without one, "cuda" raises,
    alone or beside "cpu"."""
    net, _, _, d = micro
    for plats in (["cuda"], ["cuda", "cpu"]):
        with pytest.raises(RuntimeError, match="needs the card"):
            net.export(str(d / "card.pt2"), platforms=plats)


@pytest.mark.parametrize("plats,device,cuda,want", [
    (("cpu",), None, False, "cpu"),
    (("cpu",), None, True, "cpu"),
    (("cuda", "cpu"), None, True, "cuda"),
    (("cuda", "cpu"), None, False, "cpu"),
    (("cpu", "cuda"), None, True, "cuda"),
    (("cuda",), None, True, "cuda"),
    (("cuda", "cpu"), "cpu", True, "cpu"),
    (("cuda", "cpu"), "cuda:0", True, "cuda"),
    (("cuda",), None, False, RuntimeError),
    (("cuda",), "cpu", True, ValueError),
    (("cpu",), "cuda", True, ValueError),
    (("cuda", "cpu"), "cuda", False, RuntimeError),
], ids=lambda v: str(v))
def test_choose_platform(plats, device, cuda, want):
    """The loader's choice: the asked device's program, else the card's
    where there is one and the file has it, else the CPU's; never another
    device's program in place of the one asked for."""
    if isinstance(want, str):
        assert ex.choose_platform(plats, device, cuda) == want
    else:
        with pytest.raises(want, match=r"platforms|no CUDA device") as e:
            ex.choose_platform(plats, device, cuda, name="a.pt2")
        assert e.type is RuntimeError or str(list(plats)) in str(e.value)


def test_several_programs_in_one_file(micro, monkeypatch):
    """The layout of a file with several programs: with no card the loader
    opens the CPU member only, reports both platforms and checks the CPU
    member's own probe; a card asked for raises.  (The "cuda" member here
    is a copy of the CPU program: a real one is traced on the card.)"""
    net, _, path, d = micro
    ep = torch.export.load(path)
    both = str(d / "both.pt2")
    ex.save_programs(both, {"cuda": ep, "cpu": ep}, "fast")
    with open(ex.meta_path(path)) as f:
        meta = json.load(f)
    probe = meta["probe"]
    with open(ex.meta_path(both), "w") as f:
        json.dump({**meta, "device": "cuda", "platforms": ["cuda", "cpu"],
                   "probe": {**probe, "expected": [[[0, 0.5, 0, 0, 1, 1]]],
                             "expected_by_platform": {
                                 "cuda": [[[0, 0.5, 0, 0, 1, 1]]],
                                 "cpu": probe["expected"]}}}, f)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    art = ex.load_exported(both)
    assert art.platforms == ("cuda", "cpu") and art.device.type == "cpu"
    ex.verify_artifact(art)
    frames = _frames(net, 2, 4)
    _same(art.call(frames), net.detect_device(frames))
    assert "platforms cuda,cpu" in ex.ArtifactNet([both]).dump()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ex.load_exported(both, device="cuda")


def test_cli_export_platforms(micro, capsys):
    """``cli export --platforms cpu`` names the platforms on its line, as
    JAX's command does."""
    from ffcnn_tpu_torch.cli import main

    _, wpath, _, d = micro
    out = str(d / "cli.pt2")
    assert main(["export", out, "--platforms", "cpu", "--cfg", MICRO,
                 "--weights", wpath, "--device", "cpu"]) == 0
    (line,) = capsys.readouterr().out.strip().splitlines()
    assert line == (f"wrote {out}: {os.path.getsize(out)} bytes (batch 1, "
                    f"device cpu, platforms cpu)")
    assert ex.load_exported(out).platforms == ("cpu",)


# ---------------------------------------------------------- float32 knobs
@pytest.mark.parametrize("shape,fs,stride,groups", [
    ((1, 10, 10, 96), 1, 1, 1), ((2, 20, 20, 16), 3, 2, 1),
    ((1, 13, 13, 32), 5, 1, 32), ((2, 1, 1, 8), 1, 1, 8)],
    ids=["pw", "dense-s2", "dw5", "1x1-map"])
def test_conv2d_f32_op(shape, fs, stride, groups):
    """ffcnn::conv2d_f32's CPU implementation is today's float32
    conv2d_fused bit for bit; its fake implementation's shape, dtype and
    strides are the real one's (opcheck); it is registered for the CPU,
    the card and fake tensors."""
    rng = np.random.RandomState(sum(shape) + fs)
    c, fn = shape[-1], 2 * shape[-1] if groups == 1 else shape[-1]
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal(
        (fn, c // groups, fs, fs)).astype(np.float32) * 0.3)
    s = torch.from_numpy(rng.rand(fn).astype(np.float32) + 0.5)
    b = torch.from_numpy(rng.standard_normal(fn).astype(np.float32))
    args = (x, w, s, b, stride, fs // 2, groups, 2)
    got = oc.conv2d_f32(x, w, s, b, stride=stride, pad=fs // 2,
                        groups=groups, act=2)
    want = oc.conv2d_fused(x, w, s, b, stride=stride, pad=fs // 2,
                           groups=groups, act=2)
    assert torch.equal(got, want) and got.dtype == torch.float32
    torch.library.opcheck(oc.CONV2D_F32_OP, args)
    with torch._subclasses.fake_tensor.FakeTensorMode() as mode:
        fake = oc.CONV2D_F32_OP(*[mode.from_tensor(a) if isinstance(
            a, torch.Tensor) else a for a in args])
    assert (fake.shape, fake.stride(), fake.dtype) == \
        (got.shape, got.stride(), got.dtype)
    op = ops.PRECISION_OPS["conv2d_f32"]
    assert op is torch.ops.ffcnn.conv2d_f32.default is oc.CONV2D_F32_OP
    for key in ("CPU", "CUDA", "Meta"):
        assert torch._C._dispatch_has_kernel_for_dispatch_key(op.name(), key)
    with pytest.raises(ValueError, match="float32"):
        oc.conv2d_f32(x.bfloat16(), w, s, b, stride=stride, pad=fs // 2,
                      groups=groups, act=2)


@pytest.fixture(scope="module")
def xl_weights(tmp_path_factory):
    d = tmp_path_factory.mktemp("knobs")
    return _weights(d / "xl.weights", XL, 42), d


@pytest.fixture(scope="module", params=["none"] + list(KNOBS))
def knob_art(request, xl_weights):
    """xl fast at 320x320, the head chains planned, under a knob set (or
    none), and its artifact at batch 1, loaded."""
    wpath, d = xl_weights
    flags = {**HEADS, **KNOBS.get(request.param, {})}
    net = _net(XL, wpath, flags)
    path = str(d / f"{request.param}.pt2")
    net.export(path)
    return request.param, flags, net, ex.load_exported(path)


def test_knob_program_holds_one_op_a_forced_conv(knob_art):
    """The exported program calls ffcnn::conv2d_f32 once for each conv the
    knobs force (10 head-chain convs, 20 at width 20, 25 under both) and
    never without the knobs; K7 is in the stage-20 program only."""
    knob, _, net, art = knob_art
    forced = [li for li in net._f32_layers or ()
              if net.ir.layers[li].type == pt.LayerType.CONV]
    nodes = [n for n in art.program.graph.nodes
             if n.target is oc.CONV2D_F32_OP]
    assert len(nodes) == len(forced) == {"none": 0, "head": 10,
                                         "stage20": 20, "both": 25}[knob]
    has = "ffcnn::conv2d_f32.default" in art.meta["custom_ops"]
    assert has == (knob != "none")
    assert ("ffcnn::head_run.default" in art.meta["custom_ops"]) == \
        (knob in ("none", "stage20"))


@pytest.mark.parametrize("knob_art", list(KNOBS), indirect=True)
def test_knob_artifact_equals_net(knob_art):
    """Under each knob set the artifact's detections are Net.detect's, bit
    for bit, and its golden probe replays."""
    _, _, net, art = knob_art
    frames = _frames(net, 1, 21)
    _same(art.call(frames), net.detect_device(frames))
    assert to_detections(art.call(frames)) == net.detect(frames)
    ex.verify_artifact(art)


@pytest.mark.parametrize("knob_art", list(KNOBS), indirect=True)
def test_knob_artifact_matches_jax_artifact(knob_art, xl_weights,
                                            monkeypatch):
    """The port's artifact against JAX's, exported on the CPU from the same
    weights under the same flags, by fast mode's bound: each side's
    detections on seeded frames among the other side's candidates (the
    port's: its Net's forward decoded; JAX's: its folded bf16 forward with
    the same float32 layers, decoded)."""
    import jax.numpy as jnp

    from ffcnn_tpu import Net as JNet
    from ffcnn_tpu import export as jex
    from ffcnn_tpu.graph import build as jbuild
    from ffcnn_tpu.ops import preprocess as jpre
    from ffcnn_tpu.ops.yolo import concat_heads, decode_head
    from ffcnn_tpu_torch.ops.yolo import decode_heads

    knob, flags, net, art = knob_art
    wpath, d = xl_weights
    for k, v in flags.items():
        monkeypatch.setenv(k, v)
    jnet = JNet.load(XL, wpath, mode="fast")
    jpath = str(d / f"{knob}.jax")
    jex.export_net(jnet, jpath, platforms=["cpu"])
    frames = _frames(net, 1, 22)
    got = to_detections(art.call(frames))
    want = JNet._to_detections(jex.load_exported(jpath).call(frames))
    assert sum(map(len, want)) > 0 and sum(map(len, got)) > 0
    h, w = net.ir.blobs[0].h, net.ir.blobs[0].w
    tc = decode_heads(net.ir, net.forward_heads(torch.from_numpy(frames)),
                      w, h)
    jir = jnet.ir
    feats = jbuild.forward_features(
        jir, jbuild.fold_input_transform(jir, jnet.params, pt.DEFAULT_MEAN,
                                         pt.DEFAULT_NORM),
        jpre.letterbox_uint8(jnp.asarray(frames), w, h),
        input_dtype=jnp.bfloat16, f32_layers=net._f32_layers)
    jc = concat_heads([decode_head(f, l, w, h) for f, l in zip(
        feats, [l for l in jir.layers if l.type.name == "YOLO"])])
    for i in range(len(frames)):
        assert _frac(got[i], [np.asarray(jnp.asarray(t[i], jnp.float32))
                              for t in (jc.boxes, jc.scores, jc.classes)]
                     ) >= MATCH_FRAC
        assert _frac(want[i], [t[i].float().numpy() for t in (
            tc.boxes, tc.scores, tc.classes)]) >= MATCH_FRAC
