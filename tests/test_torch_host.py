"""The port's own host code (``ffcnn_tpu_torch/darknet``, ``imageio``,
``tuning``) against the JAX package's, which it copies: the same IR for
every ``models/*.cfg``, the same folded weights, the same pixels, the same
BMP bytes written and drawn, the same batches loaded, the same flag
resolution; and no file of the port imports the JAX package (the codec's
build-and-load module ``imageio/native.py`` included)."""

import ast
import dataclasses
import glob
import os
import subprocess
import sys

import numpy as np
import pytest

from ffcnn_tpu import tuning as jtuning
from ffcnn_tpu.darknet import cfg as jcfg
from ffcnn_tpu.darknet import weights as jweights
from ffcnn_tpu.imageio import bmp as jbmp
from ffcnn_tpu.imageio import loader as jloader
from ffcnn_tpu_torch import tuning as ttuning
from ffcnn_tpu_torch.darknet import cfg as tcfg
from ffcnn_tpu_torch.darknet import weights as tweights
from ffcnn_tpu_torch.imageio import bmp as tbmp
from ffcnn_tpu_torch.imageio import loader as tloader
from ffcnn_tpu_torch.testing import cap_threads

cap_threads()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFGS = sorted(glob.glob(os.path.join(REPO, "models", "*.cfg")))
CFG_IDS = [os.path.splitext(os.path.basename(p))[0] for p in CFGS]
BMP = os.path.join(REPO, "tests", "fixtures", "test320.bmp")


@pytest.mark.parametrize("size", [0, 160, 416])
@pytest.mark.parametrize("cfg_path", CFGS, ids=CFG_IDS)
def test_parse_cfg_equals_jax(cfg_path, size):
    """Every Layer field and blob shape, the [net] dims and the dump table;
    each side parsed by its own parser (``size`` 0: the cfg's own)."""
    want = jcfg.parse_cfg(cfg_path, size, size)
    got = tcfg.parse_cfg(cfg_path, size, size)
    assert len(got.layers) == len(want.layers) > 0
    for g, w in zip(got.layers, want.layers):
        assert dataclasses.astuple(g) == dataclasses.astuple(w), g.index
        assert g.type.name == w.type.name
    assert [dataclasses.astuple(b) for b in got.blobs] == \
        [dataclasses.astuple(b) for b in want.blobs]
    assert (got.cfg_width, got.cfg_height, got.cfg_channels) == \
        (want.cfg_width, want.cfg_height, want.cfg_channels)
    assert got.darknet_file_floats() == want.darknet_file_floats()
    assert got.weight_size_floats() == want.weight_size_floats()
    assert tcfg.dump(got) == jcfg.dump(want)


def test_parse_cfg_quirks_equal_jax():
    """The reference's tolerant parsing, on text: a missing stride and a
    garbage number, relative and absolute routes, an unknown section, an
    unknown activation."""
    text = ("[net]\nwidth=64\nheight=48\nchannels=3\n"
            "[convolutional]\nfilters=8\nsize=3\npad=1\nstride=x\n"
            "activation=leakyish\n"
            "[maxpool]\nsize=2\nstride=2\n"
            "[region]\nfoo=1\n"
            "[convolutional]\nfilters=4\nsize=1\nactivation=swish\n"
            "[route]\nlayers=-1,-3\n"
            "[shortcut]\nfrom=-2\nactivation=bogus\n")
    want, got = jcfg.parse_cfg(text), tcfg.parse_cfg(text)
    assert [dataclasses.astuple(l) for l in got.layers] == \
        [dataclasses.astuple(l) for l in want.layers]
    assert got.blobs == tuple(tcfg.BlobShape(*dataclasses.astuple(b))
                              for b in want.blobs)


@pytest.mark.parametrize("cfg_path", CFGS, ids=CFG_IDS)
def test_load_weights_equals_jax(cfg_path):
    """The same synthesized file from both packages, and the same folded
    arrays (HWIO weights, BN-folded scale and bias) from both readers."""
    jir, tir = jcfg.parse_cfg(cfg_path), tcfg.parse_cfg(cfg_path)
    raw = jweights.synth_weights_bytes(jir, seed=42, obj_bias=2.0)
    assert tweights.synth_weights_bytes(tir, seed=42, obj_bias=2.0) == raw
    want, jhead = jweights.load_weights(jir, raw)
    got, thead = tweights.load_weights(tir, raw)
    assert dataclasses.astuple(thead) == dataclasses.astuple(jhead)
    assert sorted(got) == sorted(want)
    for li in want:
        for f in ("weights", "scale", "bias"):
            np.testing.assert_array_equal(getattr(got[li], f),
                                          getattr(want[li], f), err_msg=li)
    zw, zt = jweights.zero_weights(jir), tweights.zero_weights(tir)
    assert all(np.array_equal(zt[li].weights, zw[li].weights)
               and np.array_equal(zt[li].scale, zw[li].scale) for li in zw)


def test_load_weights_refuses_a_short_file():
    tir = tcfg.parse_cfg(CFGS[0])
    raw = tweights.synth_weights_bytes(tir, seed=1)
    with pytest.raises(ValueError):
        tweights.load_weights(tir, raw[:-4])
    with pytest.raises(ValueError):
        tweights.load_weights(tir, raw[:10])
    got, _ = tweights.load_weights(tir, raw + b"\0" * 8, allow_mismatch=True)
    assert len(got) == sum(l.type == 0 for l in tir.layers)


def test_bmp_load_equals_jax(tmp_path):
    """The fixture's pixels, and an odd-width image (row padding) written
    by the JAX package's writer."""
    np.testing.assert_array_equal(tbmp.bmp_load(BMP), jbmp.bmp_load(BMP))
    img = np.random.RandomState(0).randint(0, 256, (3, 5, 3), dtype=np.uint8)
    path = str(tmp_path / "odd.bmp")
    jbmp.bmp_save(path, img)
    np.testing.assert_array_equal(tbmp.bmp_load(path), img)
    np.testing.assert_array_equal(tbmp.bmp_load(path), jbmp.bmp_load(path))
    with open(path, "rb") as f:
        raw = f.read()
    with pytest.raises(ValueError):
        tbmp.bmp_decode(raw[:20])
    with pytest.raises(ValueError):
        tbmp.bmp_decode(b"XX" + raw[2:])


@pytest.mark.parametrize("shape", [(3, 5), (7, 4), (64, 64)])
def test_bmp_writer_and_drawing_equal_jax(shape, tmp_path):
    """bmp_save writes the JAX package's bytes (odd widths pad their rows);
    setpixel (clamped, clipped), getpixel (the reference's B/G/R quirk,
    zeros outside) and draw_rectangle (clipped outlines, any corner order)
    leave the same pixels."""
    rng = np.random.RandomState(sum(shape))
    img = rng.randint(0, 256, shape + (3,), dtype=np.uint8)
    t, j = img.copy(), img.copy()
    h, w = shape
    for x1, y1, x2, y2 in ((1, 1, w - 2, h - 2), (-3, 2, w + 4, h // 2),
                           (w - 1, h - 1, 0, 0), (2, -5, 2, h + 5)):
        tbmp.draw_rectangle(t, x1, y1, x2, y2, 0, 255, 0)
        jbmp.draw_rectangle(j, x1, y1, x2, y2, 0, 255, 0)
    for x, y, rgb in ((0, 0, (300, -4, 17)), (w - 1, h - 1, (1, 2, 3)),
                      (w, 0, (9, 9, 9)), (-1, h // 2, (7, 7, 7))):
        tbmp.setpixel(t, x, y, *rgb)
        jbmp.setpixel(j, x, y, *rgb)
    np.testing.assert_array_equal(t, j)
    for x, y in ((0, 0), (w - 1, h - 1), (w, 0), (-1, -1), (w // 2, h // 2)):
        assert tbmp.getpixel(t, x, y) == jbmp.getpixel(j, x, y)
    tp, jp = str(tmp_path / "t.bmp"), str(tmp_path / "j.bmp")
    tbmp.bmp_save(tp, t)
    jbmp.bmp_save(jp, j)
    with open(tp, "rb") as a, open(jp, "rb") as b:
        assert a.read() == b.read()


def test_load_batch_equals_jax(tmp_path):
    """Same-sized BMPs into one batch, in path order, with any thread
    count; mixed sizes and an empty list refused."""
    rng = np.random.RandomState(3)
    paths = []
    for i in range(5):
        paths.append(str(tmp_path / f"{i}.bmp"))
        jbmp.bmp_save(paths[-1], rng.randint(0, 256, (6, 9, 3),
                                             dtype=np.uint8))
    want = jloader.load_batch(paths)
    for threads in (0, 1, 3):
        got = tloader.load_batch(paths, threads)
        assert got.dtype == np.uint8 and got.shape == (5, 6, 9, 3)
        np.testing.assert_array_equal(got, want)
    jbmp.bmp_save(str(tmp_path / "odd.bmp"), np.zeros((4, 4, 3), np.uint8))
    with pytest.raises(IOError):
        tloader.load_batch(paths + [str(tmp_path / "odd.bmp")])
    with pytest.raises(ValueError):
        tloader.load_batch([])


def test_get_flag_follows_the_environment(monkeypatch):
    """The environment wins, else the default; with the tuned file pinned
    off (as the tests pin it), the JAX package resolves alike."""
    monkeypatch.delenv("FFCNN_PORT_PROBE", raising=False)
    assert ttuning.get_flag("FFCNN_PORT_PROBE", "d") == "d"
    monkeypatch.setenv("FFCNN_PORT_PROBE", "7")
    assert ttuning.get_flag("FFCNN_PORT_PROBE", "d") == "7"
    monkeypatch.setenv("FFCNN_PORT_PROBE", "")
    assert ttuning.get_flag("FFCNN_PORT_PROBE", "d") == ""
    assert os.environ.get("FFCNN_TUNED_DEFAULTS") == ""
    for v in ("1", "f32"):
        monkeypatch.setenv("FFCNN_FUSED_STORE", v)
        assert ttuning.get_flag("FFCNN_FUSED_STORE", "input") == \
            jtuning.get_flag("FFCNN_FUSED_STORE", "input") == v


def _port_files():
    files = sorted(glob.glob(os.path.join(REPO, "ffcnn_tpu_torch", "**",
                                          "*.py"), recursive=True))
    return files + [os.path.join(REPO, "chip_smoke.py")]


# What the port must not import: jax, the JAX package, and the scripts under
# tools/ (the reference's probes), by package or by their own names.
_FORBIDDEN = {"jax", "jaxlib", "ffcnn_tpu", "tools"} | {
    os.path.splitext(os.path.basename(p))[0]
    for p in glob.glob(os.path.join(REPO, "tools", "*.py"))}


def test_scan_covers_the_cli_and_its_modules():
    """The command line, the bench, the YOLOv8 converter and the modules
    they call are scanned."""
    scanned = {os.path.relpath(p, REPO) for p in _port_files()}
    for name in ("cli.py", "profiling.py", "roofline.py", "bench.py",
                 "imageio/loader.py", "yolov8.py"):
        assert os.path.join("ffcnn_tpu_torch", name) in scanned, name


def test_scan_covers_export_and_the_ops():
    """The artifact module, the runtime it shares with net.py, the op
    registry and the ops' namespace module are scanned."""
    scanned = {os.path.relpath(p, REPO) for p in _port_files()}
    for name in ("export.py", "runtime.py", "kernels/ops.py",
                 "kernels/_library.py"):
        assert os.path.join("ffcnn_tpu_torch", name) in scanned, name


def test_scan_covers_the_bmp_codec():
    """The codec's build-and-load module and the two modules that call it
    are scanned."""
    scanned = {os.path.relpath(p, REPO) for p in _port_files()}
    for name in ("imageio/native.py", "imageio/bmp.py", "imageio/loader.py"):
        assert os.path.join("ffcnn_tpu_torch", name) in scanned, name


@pytest.mark.parametrize("module", ["ffcnn_tpu_torch.kernels.ops",
                                    "ffcnn_tpu_torch.export"])
def test_ops_module_imports_no_graph_builder(module):
    """An artifact loader imports the op registry (and the export module):
    in a fresh interpreter neither pulls in the graph builder, net.py or
    the cfg parser, nor jax or the JAX package."""
    code = (f"import sys; sys.path.insert(0, {REPO!r}); import {module}; "
            "print(sorted(m for m in sys.modules if m in ("
            "'ffcnn_tpu_torch.graph.build', 'ffcnn_tpu_torch.net', "
            "'ffcnn_tpu_torch.darknet.cfg') or m.split('.')[0] in ("
            "'jax', 'ffcnn_tpu')))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_port_file_imports_nothing_of_jax(path):
    """No file of the port, nor chip_smoke.py, imports jax, any module of
    the JAX package or any script under tools/ (relative imports stay
    inside the port)."""
    with open(path) as f:
        tree = ast.parse(f.read())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names]
    names += [n.module for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.level == 0]
    bad = [m for m in names if m.split(".")[0] in _FORBIDDEN]
    assert not bad, bad


def test_capture_holds_the_collector_off(monkeypatch):
    """A CUDA graph capture (a Net's bucket, ``bench_block``'s timing
    graphs) runs in ``thread_local`` mode with the garbage collector off:
    a collection that frees a dead graph mid-capture destroys it there and
    invalidates the capture.  The collector is back on after it, also where
    the captured block raises."""
    import contextlib
    import gc

    import torch
    from ffcnn_tpu_torch import runtime

    modes = []

    @contextlib.contextmanager
    def graph(cuda_graph, pool=None, capture_error_mode="global"):
        modes.append(capture_error_mode)
        yield

    monkeypatch.setattr(torch.cuda, "graph", graph)
    assert gc.isenabled()
    assert runtime.capture(None, lambda x: gc.isenabled(), None,
                           None) is False
    assert gc.isenabled()
    with pytest.raises(ValueError):
        with runtime.capturing(None):
            assert not gc.isenabled()
            raise ValueError
    assert gc.isenabled() and modes == ["thread_local"] * 2


def test_cap_threads_gives_a_worker_its_share(monkeypatch):
    """Under xdist a worker's torch pool takes max(1, cores // workers)
    threads; outside xdist the pool is left as it is."""
    import torch
    from ffcnn_tpu_torch import testing
    before = torch.get_num_threads()
    monkeypatch.setattr(testing.os, "sched_getaffinity",
                        lambda pid: set(range(8)), raising=False)
    try:
        monkeypatch.setenv("PYTEST_XDIST_WORKER_COUNT", "6")
        assert testing.cap_threads() == 1 == torch.get_num_threads()
        monkeypatch.setenv("PYTEST_XDIST_WORKER_COUNT", "2")
        assert testing.cap_threads() == 4 == torch.get_num_threads()
        monkeypatch.delenv("PYTEST_XDIST_WORKER_COUNT")
        assert testing.cap_threads() == 4 == torch.get_num_threads()
    finally:
        torch.set_num_threads(before)
