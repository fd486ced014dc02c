"""AOT export artifacts on the port (``ffcnn_tpu_torch/export.py``), case
for case the cases of tests/test_export.py on the micro model, on the CPU:
the ``torch.export`` program must be self-contained (weights baked),
bit-identical to the live bucket, loadable without the cfg/weights pair or
the graph builder, and refused on a semantic (golden-probe) mismatch."""

import json
import os
import shutil
import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch

import ffcnn_tpu_torch as pt
from ffcnn_tpu_torch import export as ex
from ffcnn_tpu_torch import serve
from ffcnn_tpu_torch.testing import cap_threads

cap_threads()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MICRO = os.path.join(REPO, "models", "ffcnn-micro.cfg")
# micro's blocks are narrower than the default MIN_CHANNELS gate: these
# flags plan its fused run, so that K1's op is in the artifact too
RUN_FLAGS = {"FFCNN_FUSED_DOWN": "1", "FFCNN_FUSED_MINC": "8"}


def _weights(path, seed):
    ir = pt.parse_cfg(MICRO)
    with open(path, "wb") as f:
        f.write(pt.synth_weights_bytes(ir, seed=seed, obj_bias=2.0))
    return str(path)


def _net(wpath, mode="fast", flags=None):
    with pytest.MonkeyPatch.context() as mp:
        for k, v in (flags or {}).items():
            mp.setenv(k, v)
        return pt.Net.load(MICRO, wpath, mode=mode, device="cpu")


@pytest.fixture(scope="module")
def art_dir(tmp_path_factory):
    return tmp_path_factory.mktemp("artifacts")


@pytest.fixture(scope="module")
def micro(art_dir):
    """A fast micro Net with its fused run, its artifacts at batch 1 and 4
    and each loaded (exported and loaded once for the module: a load takes
    about a second here)."""
    net = _net(_weights(art_dir / "micro.weights", 7), flags=RUN_FLAGS)
    paths, arts = {}, {}
    for b in (1, 4):
        paths[b] = str(art_dir / f"micro.b{b}.pt2")
        assert net.export(paths[b], batch_size=b) == \
            os.path.getsize(paths[b])
        arts[b] = ex.load_exported(paths[b])
    return net, paths, arts


def _hw(net):
    return net.ir.blobs[0].h, net.ir.blobs[0].w


def _same(got, want):
    for a, b, nm in zip(got, want,
                        ("boxes", "scores", "classes", "count", "sat")):
        assert torch.equal(a, b), nm


def test_export_roundtrip_bit_identical(micro):
    net, paths, arts = micro
    h, w = _hw(net)
    batch = np.random.RandomState(0).randint(0, 256, (4, h, w, 3),
                                             dtype=np.uint8)
    assert os.path.getsize(paths[4]) > 1000
    art = arts[4]
    assert art.in_shape == (4, h, w, 3)
    assert (art.device.type, art.mode) == ("cpu", "fast")
    _same(art.call(batch), net.detect_device(batch))


@pytest.mark.parametrize("hw", [(64, 64), (48, 80)], ids=["64x64", "48x80"])
def test_probe_image_is_the_jax_packages(hw):
    """The golden probe's frame is the JAX package's, byte for byte, so a
    probe checks the same pixels in either package."""
    from ffcnn_tpu import export as jex
    np.testing.assert_array_equal(ex._probe_image(*hw), jex._probe_image(*hw))


def test_artifact_detections_match_jax(micro, art_dir, monkeypatch):
    """The micro artifact's detections on seeded frames against the JAX
    Net's, built from the same weights file under the same flags in fast
    mode: 90% of each side's detections have a same-class detection on
    the other within 4 px and 0.02 in score (the fast-mode match of
    test_torch_conv0_int8.py: bf16 drift may let NMS keep another member
    of a cluster)."""
    import ffcnn_tpu as jt
    net, paths, _ = micro
    h, w = _hw(net)
    frames = np.random.RandomState(12).randint(0, 256, (4, h, w, 3),
                                               dtype=np.uint8)
    got = ex.ArtifactNet([paths[4]]).detect(frames)
    for k, v in RUN_FLAGS.items():
        monkeypatch.setenv(k, v)
    want = jt.Net.load(MICRO, str(art_dir / "micro.weights"),
                       mode="fast").detect(frames)
    assert sum(map(len, want)) > 0

    def frac(a, b):
        hits = sum(any(e.class_id == d.class_id
                       and abs(e.score - d.score) <= 0.02
                       and max(abs(e.x1 - d.x1), abs(e.y1 - d.y1),
                               abs(e.x2 - d.x2), abs(e.y2 - d.y2)) <= 4.0
                       for e in bb) for aa, bb in zip(a, b) for d in aa)
        return hits / max(1, sum(map(len, a)))
    assert frac(got, want) >= 0.9 and frac(want, got) >= 0.9


def test_export_artifact_is_self_contained(art_dir):
    """Loading needs neither the Net nor the cfg or weights objects: only
    the artifact file."""
    wpath = _weights(art_dir / "own.weights", 7)
    net = _net(wpath)
    h, w = _hw(net)
    path = str(art_dir / "own.pt2")
    net.export(path)
    want = net.detect_device(np.zeros((1, h, w, 3), np.uint8))
    del net
    os.remove(wpath)
    got = ex.load_exported(path).call(np.zeros((1, h, w, 3), np.uint8))
    assert torch.equal(got.count, want.count)
    assert torch.equal(got.scores, want.scores)


def test_artifact_net_serving(micro, art_dir):
    """ArtifactNet routes to the right bucket, pads, and serves through
    DetectorService end to end: a worker with only artifact files."""
    from ffcnn_tpu_torch.imageio.bmp import bmp_save

    net, paths, _ = micro
    h, w = _hw(net)
    anet = ex.ArtifactNet([paths[1], paths[4]])
    assert anet.input_hw == (h, w)
    assert anet.max_batch == 4
    assert "batch    4" in anet.dump()

    batch = np.random.RandomState(3).randint(0, 256, (3, h, w, 3),
                                             dtype=np.uint8)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)   # saturation
        got = anet.detect(batch)                  # pads 3 -> the 4-bucket
        want = net.detect(batch)
        # async dispatch (the micro-batcher's overlap) gives the same
        got_async = anet.detect_async(batch)()
    assert len(got) == 3
    for g, w_ in zip(got, want):
        assert [d.class_id for d in g] == [d.class_id for d in w_]
        for a, b in zip(g, w_):
            assert abs(a.score - b.score) < 1e-6
    assert got_async == got

    with pytest.raises(ValueError, match="exceeds largest"):
        anet.detect(np.zeros((5, h, w, 3), np.uint8))
    with pytest.raises(ValueError, match="no artifact for"):
        anet.detect(np.zeros((1, h + 32, w, 3), np.uint8))

    svc = serve.DetectorService(anet, max_batch=anet.max_batch)
    svc.warmup()
    assert svc.ready
    p = str(art_dir / "req.bmp")
    bmp_save(p, batch[0])
    with open(p, "rb") as f:
        dets = svc.detect_bmp_bytes(f.read())
    assert dets == [{"score": round(d.score, 4), "class_id": d.class_id,
                     "box": [round(v, 2) for v in (d.x1, d.y1, d.x2, d.y2)]}
                    for d in want[0]]


def test_cli_export_multi_bucket(art_dir, capsys):
    from ffcnn_tpu_torch.cli import main

    wpath = _weights(art_dir / "cli.weights", 7)
    out = str(art_dir / "m.pt2")
    assert main(["export", out, "--batch", "1,2", "--mode", "fast",
                 "--cfg", MICRO, "--weights", wpath, "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 2 and lines[0].startswith("wrote ")
    anet = ex.ArtifactNet([str(art_dir / "m.b1.pt2"),
                           str(art_dir / "m.b2.pt2")])
    assert anet.max_batch == 2


def test_export_int8_mode_roundtrip(micro, art_dir):
    """Export composes with the int8 pipeline: the plan's codes and scales
    are baked in like the float weights, and the int8 conv is an op of the
    program."""
    net = _net(str(art_dir / "micro.weights"), mode="int8")
    h, w = _hw(net)
    calib = np.random.RandomState(5).randint(0, 256, (2, h, w, 3),
                                             dtype=np.uint8)
    # micro's convs are narrower than the default 32-channel gate
    net.calibrate(calib, min_channels=8)
    assert net.quant.weights
    path = str(art_dir / "micro_int8.pt2")
    net.export(path, batch_size=2)
    art = ex.load_exported(path)
    assert art.mode == "int8"
    assert "ffcnn::conv_int8.default" in art.meta["custom_ops"]
    _same(art.call(calib), net.detect_device(calib))


def test_export_writes_meta_sidecar(micro):
    """The sidecar records the ffcnn:: ops the program calls (K2 in every
    mode, K1 for the fused run), torch's version, the device and mode, the
    kernels' source hash and a golden probe."""
    from ffcnn_tpu_torch.kernels import _build

    _, paths, arts = micro
    with open(ex.meta_path(paths[1])) as f:
        meta = json.load(f)
    assert meta["custom_ops"] == ["ffcnn::fused_block.default",
                                  "ffcnn::nms_keep_mask.default"]
    assert meta["torch_version"] == torch.__version__
    assert (meta["device"], meta["mode"], meta["format"]) == ("cpu", "fast",
                                                              1)
    assert meta["kernel_hash"] == _build.source_hash()
    assert meta["probe"]["seed"] == 20260817 and meta["probe"]["expected"]
    assert arts[1].meta == meta


def test_artifact_probe_gate(micro, art_dir):
    """The semantic health gate: a worker serving an artifact whose baked
    probe does not reproduce must not go ready; DetectorService.warmup
    raises and readiness stays off."""
    _, paths, arts = micro
    ex.verify_artifact(arts[1])                       # a healthy one passes
    ex.ArtifactNet([paths[1]]).warmup()

    # a stale artifact: the same graph, other weights; shapes pass
    other = _net(_weights(art_dir / "other.weights", 99), flags=RUN_FLAGS)
    stale = str(art_dir / "stale.pt2")
    other.export(stale, batch_size=1)
    # with the good artifact's sidecar: the deployment thinks it shipped
    # the good model, but the program is another net's
    shutil.copy(ex.meta_path(paths[1]), ex.meta_path(stale))
    with pytest.raises(RuntimeError, match="golden-probe mismatch"):
        ex.verify_artifact(ex.load_exported(stale))

    svc = serve.DetectorService(ex.ArtifactNet([stale]))
    with pytest.raises(RuntimeError, match="golden-probe mismatch"):
        svc.warmup()
    assert not svc.ready
    assert "golden-probe mismatch" in svc.error


def test_artifact_without_meta_warns_not_fails(micro, art_dir):
    """A bare artifact (no sidecar) still serves, with a warning that the
    semantic gate is unavailable; its mode comes from the program file."""
    _, paths, _ = micro
    path = str(art_dir / "bare.pt2")
    shutil.copy(paths[1], path)
    anet = ex.ArtifactNet([path])
    assert anet._arts[0].meta is None and anet._arts[0].mode == "fast"
    with pytest.warns(RuntimeWarning, match="no .meta.json"):
        anet.warmup()


def test_export_rejects_wrong_shape(micro):
    net, _, arts = micro
    h, w = _hw(net)
    art = arts[4]
    with pytest.raises(ValueError, match="artifact expects"):
        art.call(np.zeros((3, h, w, 3), np.uint8))
    with pytest.raises(ValueError, match="artifact expects"):
        art.call(np.zeros((4, h, w, 3), np.float32))


def test_card_artifact_refuses_the_cpu(micro, art_dir, monkeypatch):
    """An artifact exported on the card does not quietly run on the CPU:
    where there is no card it refuses to load."""
    _, paths, _ = micro
    path = str(art_dir / "card.pt2")
    shutil.copy(paths[1], path)
    with open(ex.meta_path(paths[1])) as f:
        meta = json.load(f)
    with open(ex.meta_path(path), "w") as f:
        json.dump({**meta, "device": "cuda"}, f)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="exported on the card"):
        ex.load_exported(path)


def test_load_in_a_fresh_process_without_model_files(micro, art_dir):
    """A fresh interpreter that imports only ffcnn_tpu_torch.export loads
    and runs an artifact from a copy of the package with no models/ beside
    it and no weights file, imports no graph builder, Net or cfg parser,
    and reproduces the live bucket bit for bit."""
    net, paths, _ = micro
    h, w = _hw(net)
    work = art_dir / "fresh"
    shutil.copytree(os.path.join(REPO, "ffcnn_tpu_torch"),
                    work / "pkg" / "ffcnn_tpu_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    art = str(work / "a.pt2")
    shutil.copy(paths[4], art)
    shutil.copy(ex.meta_path(paths[4]), ex.meta_path(art))
    batch = np.random.RandomState(11).randint(0, 256, (4, h, w, 3),
                                              dtype=np.uint8)
    np.save(work / "batch.npy", batch)
    want = net.detect_device(batch)
    code = (
        "import sys, numpy as np, torch\n"
        "sys.path.insert(0, 'pkg')\n"
        "from ffcnn_tpu_torch.export import load_exported, verify_artifact\n"
        "art = load_exported('a.pt2')\n"
        "verify_artifact(art)\n"
        "res = art.call(np.load('batch.npy'))\n"
        "torch.save(tuple(res), 'res.pt')\n"
        "bad = [m for m in ('ffcnn_tpu_torch.net', 'ffcnn_tpu_torch.graph."
        "build', 'ffcnn_tpu_torch.darknet.cfg', 'jax', 'ffcnn_tpu') "
        "if m in sys.modules]\n"
        "print('LOADED', bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=work,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "LOADED []" in out.stdout
    _same(torch.load(work / "res.pt"), want)
