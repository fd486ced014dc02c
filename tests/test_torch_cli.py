"""The port's command line (``ffcnn_tpu_torch/cli.py``) against the JAX
package's (``ffcnn_tpu/cli.py``) on the CPU, byte for byte where both print
the same thing: ``dump`` for every ``models/*.cfg``; ``detect``'s score
lines and output BMP (micro with seed-7 weights on a seeded 64x64 frame,
xl with seed-42 weights on the 320x320 fixture, parity); ``batch``'s
per-image lines, whole and in chunks of 2.  Then the port's own: what
``profile``, ``bench`` and ``roofline`` print, the refusals that name a
ROADMAP item, and the port's bench (``ffcnn_tpu_torch/bench.py``)."""

import glob
import json
import os
import re

import numpy as np
import pytest
import torch

from ffcnn_tpu import cli as jcli
from ffcnn_tpu_torch import bench as tbench
from ffcnn_tpu_torch import cli as tcli
from ffcnn_tpu_torch.darknet.cfg import parse_cfg
from ffcnn_tpu_torch.darknet.weights import synth_weights_bytes
from ffcnn_tpu_torch.imageio.bmp import bmp_save

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFGS = sorted(glob.glob(os.path.join(REPO, "models", "*.cfg")))
MICRO = os.path.join(REPO, "models", "ffcnn-micro.cfg")
XL = os.path.join(REPO, "models", "yolo-fastest-xl.cfg")
BMP = os.path.join(REPO, "tests", "fixtures", "test320.bmp")
REGION_FLAGS = {"FFCNN_FUSED_DOWN": "1", "FFCNN_FUSED_MINC": "8",
                "FFCNN_CONV0_PALLAS": "1", "FFCNN_FUSED_HEADS": "1"}


@pytest.fixture(autouse=True)
def _no_compile_cache(monkeypatch):
    """The JAX CLI writes no persistent compile cache under HOME."""
    monkeypatch.setenv("FFCNN_NO_COMPILE_CACHE", "1")


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """micro's and xl's synthesized weights, and three seeded 64x64 BMPs."""
    d = tmp_path_factory.mktemp("cli")
    out = {}
    for name, cfg, seed in (("micro", MICRO, 7), ("xl", XL, 42)):
        out[name] = str(d / f"{name}.weights")
        with open(out[name], "wb") as f:
            f.write(synth_weights_bytes(parse_cfg(cfg), seed=seed,
                                        obj_bias=2.0))
    rng = np.random.RandomState(1)
    out["images"] = []
    for i in range(3):
        p = str(d / f"img{i}.bmp")
        bmp_save(p, rng.randint(0, 256, (64, 64, 3), dtype=np.uint8))
        out["images"].append(p)
    return out


def _run(main, argv, capsys) -> str:
    assert main(argv) == 0
    return capsys.readouterr().out


@pytest.mark.parametrize("size", [0, 416])
@pytest.mark.parametrize("cfg", CFGS,
                         ids=lambda p: os.path.basename(p)[:-4])
def test_dump_equals_jax(cfg, size, capsys):
    argv = ["dump", "--cfg", cfg, "--width", str(size), "--height",
            str(size)]
    want = _run(jcli.main, argv, capsys)
    assert _run(tcli.main, argv, capsys) == want
    assert "yolo" in want


@pytest.mark.parametrize("model", ["micro", "xl"])
def test_detect_equals_jax(model, files, tmp_path, capsys):
    """Parity (the default mode): the same score lines, and the same output
    BMP bytes, boxes drawn."""
    cfg, image = (MICRO, files["images"][0]) if model == "micro" \
        else (XL, BMP)
    outs = {}
    for tag, main, extra in (("jax", jcli.main, []),
                             ("port", tcli.main, ["--device", "cpu"])):
        path = str(tmp_path / f"{tag}.bmp")
        text = _run(main, ["detect", image, "--cfg", cfg, "--weights",
                           files[model], "-o", path] + extra, capsys)
        lines = text.splitlines()
        assert re.fullmatch(r"1 times inference: \d+ ms", lines[0])
        with open(path, "rb") as f:
            outs[tag] = (lines[1:], f.read())
    assert len(outs["jax"][0]) > 0
    assert outs["port"][1] == outs["jax"][1]
    if model == "micro":
        assert outs["port"][0] == outs["jax"][0]
    else:
        # xl's 686 detections hold runs of equal printed scores: within
        # one, two float32 sums in another order may swap a pair one ulp
        # apart, and at K == M JAX orders exact ties otherwise (ROADMAP
        # Queue 3); the lines of each run must be the same, runs in order
        assert _score_runs(outs["port"][0]) == _score_runs(outs["jax"][0])


def _score_runs(lines):
    """The score lines as consecutive runs of one printed score, each run
    sorted."""
    runs = []
    for line in lines:
        score = line.split(",")[0]
        if runs and runs[-1][0] == score:
            runs[-1][1].append(line)
        else:
            runs.append((score, [line]))
    return [(s, sorted(r)) for s, r in runs]


@pytest.mark.parametrize("chunk", [None, 2], ids=["whole", "chunked"])
def test_batch_equals_jax(chunk, files, tmp_path, capsys):
    """Every image's path and score lines; the port with the params cache
    (``--cache-dir``)."""
    argv = ["batch", *files["images"], "--cfg", MICRO, "--weights",
            files["micro"], "--mode", "parity"]
    if chunk:
        argv += ["--batch", str(chunk)]
    want = _run(jcli.main, argv, capsys).splitlines()
    got = _run(tcli.main, argv + ["--device", "cpu", "--cache-dir",
                                  str(tmp_path / "cache")],
               capsys).splitlines()
    assert re.fullmatch(r"3 images: \d+ ms \([\d.]+ img/s\)", got[0])
    assert got[1:] == want[1:]
    assert sum("score:" in l for l in want) > 0
    assert os.listdir(tmp_path / "cache")


def test_profile_and_bench_print(files, capsys):
    """``profile`` on a CPU Net: CPU times labelled as such, the roofline
    with them merged in, and no memory number; ``bench``'s line."""
    out = _run(tcli.main, ["profile", "--cfg", MICRO, "--weights",
                           files["micro"], "--batch", "2", "--size", "64",
                           "--iters", "1", "--device", "cpu"], capsys)
    assert "profile (CPU us per step on cpu, 1 steps averaged):" in out
    assert "roofline (batch 2," in out and "TOTAL" in out
    assert "CPU us" in out and "x floor" in out
    assert out.splitlines()[-1] == "memory: not measured (CPU Net)"
    assert "device us" not in out
    out = _run(tcli.main, ["bench", "--cfg", MICRO, "--weights",
                           files["micro"], "--batch", "2", "--size", "64",
                           "--iters", "1", "--device", "cpu"], capsys)
    assert re.fullmatch(r"batch 2 @64x64 fast: [\d.]+ ms/batch, \d+ img/s",
                        out.strip())


def test_roofline_prints_the_region_plan(monkeypatch, capsys):
    """No device, no weights: the stage table and the runs the region
    flags plan, at a batch the TPU's quantum would refuse."""
    for k, v in REGION_FLAGS.items():
        monkeypatch.setenv(k, v)
    out = _run(tcli.main, ["roofline", "--cfg", XL, "--batch", "63"],
               capsys)
    assert "roofline (batch 63, 3350 GB/s HBM" in out and "TOTAL" in out
    assert "fused runs: L1-80, L81-108" in out
    assert "head runs: L116-120" in out
    out = _run(tcli.main, ["roofline", "--cfg", XL, "--no-fused"], capsys)
    assert "runs:" not in out


def test_detect_int8_equals_net(files, tmp_path, capsys, monkeypatch):
    """``detect --mode int8`` (once refused) calibrates on its image and
    prints Net.detect's lines under that calibration, its BMP drawn
    (micro, its blobs of 8 channels and more int8: FFCNN_INT8_MINC=8)."""
    import ffcnn_tpu_torch as pt
    monkeypatch.setenv("FFCNN_INT8_MINC", "8")
    image = files["images"][0]
    text = _run(tcli.main, ["detect", image, "--cfg", MICRO, "--weights",
                            files["micro"], "--mode", "int8", "--device",
                            "cpu", "-o", str(tmp_path / "o.bmp")], capsys)
    bgr = pt.bmp_load(image)
    net = pt.load(MICRO, files["micro"], input_w=64, input_h=64,
                  mode="int8", device="cpu")
    dets = net.detect(bgr)
    assert net.quant is not None and net.quant.weights
    assert text.splitlines()[1:] == [
        "score: %.2f, category: %2d, rect: (%3d %3d %3d %3d)"
        % (d.score, d.class_id, int(d.x1), int(d.y1), int(d.x2), int(d.y2))
        for d in dets]
    assert os.path.getsize(tmp_path / "o.bmp") > 64 * 64 * 3


@pytest.mark.parametrize("argv,item", [
    (["bench", "--dp", "--device", "cpu"], "M14"),
    (["bench", "--sp", "2", "--device", "cpu"], "M14"),
    (["export", "out.pt2"], None),
], ids=["dp", "sp", "export"])
def test_unported_commands_name_their_item(argv, item, files, tmp_path,
                                           capsys, monkeypatch):
    """``bench --dp`` and ``--sp``, refused before, naming ROADMAP M14, are
    ported: over two CPU slots (the mesh's devices, one CPU slot with
    ``--device cpu``, made two here) they print the JAX bench's line with its
    mesh label (tests/test_torch_multiprocess.py holds their results
    against ``Net.detect``).  ``export`` (M15) is ported: it writes an
    artifact whose program reproduces the Net's bucket, as
    tests/test_torch_export.py holds it in full."""
    if item == "M14":
        from ffcnn_tpu_torch.parallel import mesh
        monkeypatch.setattr(mesh, "slot_devices",
                            lambda device: [torch.device(device)] * 2)
        assert tcli.main(argv + ["--cfg", MICRO, "--weights",
                                 files["micro"], "--size", "64", "--batch",
                                 "4", "--iters", "1"]) == 0
        label = ("dp mesh {'data': 2, 'spatial': 1, 'model': 1}"
                 if "--dp" in argv else
                 "mesh {'data': 1, 'spatial': 2, 'model': 1}")
        assert re.fullmatch(rf"batch 4 @64x64 {re.escape(label)}: "
                            r"[0-9.]+ ms/batch, [0-9]+ img/s\n",
                            capsys.readouterr().out)
        return
    if item is None:
        from ffcnn_tpu_torch import export as ex
        out = str(tmp_path / argv[1])
        assert tcli.main([argv[0], out, "--cfg", MICRO, "--weights",
                          files["micro"], "--device", "cpu"]) == 0
        assert capsys.readouterr().out.startswith(f"wrote {out}: ")
        net = tcli.Net.load(MICRO, files["micro"], mode="fast",
                            device="cpu")
        x = np.zeros((1, 64, 64, 3), np.uint8)
        got, want = ex.load_exported(out).call(x), net.detect_device(x)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        return
    with pytest.raises(SystemExit) as e:
        tcli.main(argv)
    assert e.value.code != 0
    assert f"ROADMAP {item}" in capsys.readouterr().err


def test_no_card_fails(files, capsys):
    """Without --device cpu every command that loads a Net asks for the
    card, and fails where there is none, as the bench does."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for argv in (["detect", BMP], ["batch", BMP], ["bench"], ["profile"]):
        with pytest.raises(SystemExit) as e:
            tcli.main(argv + ["--cfg", MICRO, "--weights", files["micro"]])
        assert e.value.code != 0
        assert "no CUDA device" in capsys.readouterr().err
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tbench.main(["--cfg", MICRO])


def test_bench_prints_one_json_line(capsys):
    """The whole protocol at a tiny size: gates, then every row; the last
    line of standard output is one JSON object with the keys a reader of
    the root bench's line finds, plus mfu, device and flags (no device
    metric from a CPU run)."""
    row = tbench.main(["--device", "cpu", "--cfg", MICRO, "--batches", "2",
                       "--windows", "1", "--iters", "1"])
    out = capsys.readouterr().out.strip().splitlines()
    assert json.loads(out[-1]) == row
    for k in ("metric", "value", "unit", "batch", "fast_windows_img_s",
              "fast_window_spread_pct", "parity_img_s", "parity_batch",
              "parity_windows_img_s", "stream_host_input_img_s",
              "demo_640x448_img_s", "p50_batch1_ms", "batch1_device_ms",
              "mfu", "device", "flags"):
        assert k in row, k
    assert row["unit"] == "img/s" and row["value"] > 0
    assert row["batch"] == row["parity_batch"] == 2
    assert row["device"] == {"name": "cpu", "power_limit": None}
    assert row["mfu"] is None and row["batch1_device_ms"] is None
    assert row["gflop_per_image"] > 0
