"""The port's native BMP codec (``ffcnn_tpu_torch/native/bmp_codec.c``, built
by ``ffcnn_tpu_torch/imageio/native.py``) behind ``bmp_load``, ``bmp_save``
and ``load_batch``: byte for byte with the port's numpy versions and the
JAX package's numpy paths on good inputs; the same error classes and
messages as the JAX package's own codec (``native/bmp_codec.c``, compiled
here into a temporary directory as the reference) on bad ones; the
extension's ``draw_rectangle`` against the port's; and the build itself,
in fresh processes on a copy of the codec's modules: nothing compiled at
import, one build reused, concurrent builds, and a failed build that
raises."""

import importlib.util
import os
import shutil
import struct
import subprocess
import sys
import sysconfig
import textwrap
from pathlib import Path

import numpy as np
import pytest

from ffcnn_tpu.imageio import bmp as jbmp
from ffcnn_tpu.imageio import loader as jloader
from ffcnn_tpu_torch.imageio import bmp as tbmp
from ffcnn_tpu_torch.imageio import loader as tloader
from ffcnn_tpu_torch.imageio import native
from ffcnn_tpu_torch.testing import cap_threads

cap_threads()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BMP = os.path.join(REPO, "tests", "fixtures", "test320.bmp")
SHAPES = [(1, 1), (3, 5), (7, 4), (64, 64)]


@pytest.fixture(scope="module")
def jax_codec(tmp_path_factory):
    """The JAX package's codec, compiled from ``native/bmp_codec.c`` (read
    only) with ``native/build.py``'s flags into a temporary directory."""
    out = tmp_path_factory.mktemp("jax_codec") / (
        "_ffcnn_native" + (sysconfig.get_config_var("EXT_SUFFIX") or ".so"))
    cmd = [os.environ.get("CC", "gcc"), "-O2", "-Wall", "-shared", "-fPIC",
           f"-I{sysconfig.get_path('include')}",
           os.path.join(REPO, "native", "bmp_codec.c"), "-o", str(out),
           "-lpthread"]
    subprocess.run(cmd, check=True, capture_output=True)
    spec = importlib.util.spec_from_file_location(
        "jax_reference._ffcnn_native", out)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture
def jax_numpy(monkeypatch):
    """The JAX package's numpy paths, whether or not its extension is
    built."""
    monkeypatch.setattr(jbmp, "_native", None)
    monkeypatch.setattr(jloader, "_native", None)


def _image(shape, seed=0):
    return np.random.RandomState(seed + sum(shape)).randint(
        0, 256, shape + (3,), dtype=np.uint8)


def _bmp_bytes(img, top_down=False, bits=24, rows=None):
    """A BMP file's bytes in the reference's framing; ``top_down`` writes a
    negative height, ``rows`` keeps only that many pixel rows."""
    h, w = img.shape[:2]
    stride = (w * 3 + 3) & ~3
    body = np.zeros((h, stride), np.uint8)
    body[:, : w * 3] = img.reshape(h, w * 3)
    if not top_down:
        body = body[::-1]
    header = struct.pack("<HIHHIIiiHHIIIIII", 0x4D42, 54 + stride * h, 0, 0,
                         54, 40, w, -h if top_down else h, 1, bits, 0,
                         stride * h, 0, 0, 0, 0)
    return header + body[: h if rows is None else rows].tobytes()


def _write(path, raw):
    with open(path, "wb") as f:
        f.write(raw)
    return str(path)


def _good_inputs(tmp_path):
    """(name, path, pixels): the fixture, the seeded shapes (odd widths pad
    their rows) and a top-down file."""
    cases = [("fixture", BMP, None)]
    for shape in SHAPES:
        img = _image(shape)
        cases.append((f"{shape[0]}x{shape[1]}",
                      _write(tmp_path / f"{shape[0]}x{shape[1]}.bmp",
                             _bmp_bytes(img)), img))
    img = _image((5, 7), 1)
    cases.append(("top-down", _write(tmp_path / "top_down.bmp",
                                     _bmp_bytes(img, top_down=True)), img))
    return cases


# ---------------------------------------------------------------- (a) good


def test_bmp_load_equals_the_numpy_paths(tmp_path, jax_numpy):
    """The codec's pixels equal the port's numpy version's and the JAX
    package's numpy path's, in a writable contiguous array (callers draw
    into it and upload it)."""
    for name, path, img in _good_inputs(tmp_path):
        got = tbmp.bmp_load(path)
        assert got.dtype == np.uint8 and got.flags.c_contiguous, name
        assert got.flags.writeable, name
        np.testing.assert_array_equal(got, tbmp.bmp_load_plain(path), name)
        np.testing.assert_array_equal(got, jbmp.bmp_load(path), name)
        if img is not None:
            np.testing.assert_array_equal(got, img, name)
    np.testing.assert_array_equal(tbmp.bmp_load(tmp_path / "3x5.bmp"),
                                  tbmp.bmp_load(str(tmp_path / "3x5.bmp")))


@pytest.mark.parametrize("shape", SHAPES + ["fixture", "strided"],
                         ids=str)
def test_bmp_save_equals_the_numpy_paths(shape, tmp_path, jax_numpy,
                                         jax_codec):
    """The codec writes the bytes of the port's numpy version, of the JAX
    package's numpy path and of its codec; a strided view writes its
    pixels."""
    if shape == "fixture":
        img = tbmp.bmp_load_plain(BMP)
    elif shape == "strided":
        img = _image((6, 9)).transpose(1, 0, 2)
        assert not img.flags.c_contiguous
    else:
        img = _image(shape)
    paths = [str(tmp_path / f"{k}.bmp") for k in range(4)]
    tbmp.bmp_save(paths[0], img)
    tbmp.bmp_save_plain(paths[1], img)
    jbmp.bmp_save(paths[2], img)
    jax_codec.bmp_save(paths[3], np.ascontiguousarray(img).tobytes(),
                       *img.shape[:2])
    raws = []
    for p in paths:
        with open(p, "rb") as f:
            raws.append(f.read())
    assert raws[0] == raws[1] == raws[2] == raws[3]
    np.testing.assert_array_equal(tbmp.bmp_load(paths[0]), img)


@pytest.mark.parametrize("threads", [0, 1, 3])
def test_load_batch_equals_the_numpy_paths(threads, tmp_path, jax_numpy):
    """The codec's batch, in path order, equals the port's thread pool and
    the JAX package's numpy loader, with any thread count; paths may be
    ``Path`` objects."""
    rng = np.random.RandomState(3)
    paths = [_write(tmp_path / f"{i}.bmp",
                    _bmp_bytes(rng.randint(0, 256, (6, 9, 3), np.uint8),
                               top_down=i == 2)) for i in range(5)]
    want = jloader.load_batch(paths)
    got = tloader.load_batch(paths, threads)
    assert got.dtype == np.uint8 and got.shape == (5, 6, 9, 3)
    assert got.flags.c_contiguous and got.flags.writeable
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tloader.load_batch_plain(paths, threads),
                                  want)
    np.testing.assert_array_equal(
        tloader.load_batch([Path(p) for p in paths], threads), want)
    fixture = tloader.load_batch([BMP] * 3, threads)
    np.testing.assert_array_equal(fixture, jloader.load_batch([BMP] * 3))


@pytest.mark.parametrize("top_down", [False, True], ids=["bottom-up",
                                                         "top-down"])
def test_rows_past_one_read_block(top_down, tmp_path, jax_numpy, jax_codec):
    """The codec reads pixel rows in blocks of 1 MiB: a 600x700 frame
    (1,800-byte rows, 582 a block) spans two, decoded alone and in a batch
    as the numpy paths decode it; the file cut short in its second block
    raises as the JAX package's codec (which reads row by row) does."""
    img = _image((700, 600), 5)
    raw = _bmp_bytes(img, top_down=top_down)
    path = _write(tmp_path / "big.bmp", raw)
    got = tbmp.bmp_load(path)
    np.testing.assert_array_equal(got, img)
    np.testing.assert_array_equal(got, jbmp.bmp_load(path))
    batch = tloader.load_batch([path, path, path], 2)
    np.testing.assert_array_equal(batch, np.stack([img] * 3))
    cut = _write(tmp_path / "cut.bmp", _bmp_bytes(img, top_down=top_down,
                                                 rows=600))
    for fn, args in (("bmp_load", (cut,)), ("load_batch", ([path, cut], 2))):
        got = _outcome(lambda: getattr(tloader if fn == "load_batch"
                                       else tbmp, fn)(*args))
        want = _outcome(lambda: getattr(jax_codec, fn)(*args))
        assert got is not None and got == want, (fn, got, want)


# ----------------------------------------------------------------- (b) bad


def _outcome(fn):
    try:
        fn()
    except Exception as e:          # noqa: BLE001 -- the class is compared
        return type(e), str(e)
    return None


def _bad_files(tmp_path):
    img = _image((4, 6))
    hostile = bytearray(_bmp_bytes(img))
    struct.pack_into("<i", hostile, 18, 0x7FFFFFF0)
    wide = bytearray(_bmp_bytes(img))
    struct.pack_into("<i", wide, 18, 32769)
    tall = bytearray(_bmp_bytes(img))
    struct.pack_into("<i", tall, 22, -32769)
    negative = bytearray(_bmp_bytes(img))
    struct.pack_into("<i", negative, 18, -6)
    files = {"truncated header": _bmp_bytes(img)[:30],
             "wrong magic": b"XX" + _bmp_bytes(img)[2:],
             "32-bit": _bmp_bytes(img, bits=32),
             "rows cut short": _bmp_bytes(img, rows=2),
             "no rows": _bmp_bytes(img, rows=0),
             "hostile width": bytes(hostile), "width past 32768": bytes(wide),
             "height past 32768": bytes(tall),
             "negative width": bytes(negative)}
    paths = {k: _write(tmp_path / f"bad{i}.bmp", v)
             for i, (k, v) in enumerate(files.items())}
    paths["missing"] = str(tmp_path / "missing.bmp")
    return paths


def test_bmp_load_raises_as_the_jax_codec(tmp_path, jax_codec):
    """A missing file, a truncated header, the wrong magic, a 32-bit file,
    rows cut short and hostile dimensions: the class and message of the
    JAX package's codec."""
    for name, path in _bad_files(tmp_path).items():
        got = _outcome(lambda: tbmp.bmp_load(path))
        want = _outcome(lambda: jax_codec.bmp_load(path))
        assert got is not None and got == want, (name, got, want)
    assert _outcome(lambda: tbmp.bmp_load(
        _bad_files(tmp_path)["rows cut short"]))[0] is OSError


def test_bmp_save_raises_as_the_jax_codec(tmp_path, jax_codec):
    """Hostile dimensions, an empty image and a directory that does not
    exist: the JAX package's codec's classes and messages; an image that is
    not (H, W, 3) is refused, as the numpy version refuses it."""
    p = str(tmp_path / "x.bmp")
    for h, w in ((1 << 20, 1), (1, 32769), (32769, 1)):
        got = _outcome(lambda: native.codec().bmp_save(p, b"\0" * 12, h, w))
        want = _outcome(lambda: jax_codec.bmp_save(p, b"\0" * 12, h, w))
        assert got is not None and got == want, (h, w, got)
    cases = ((np.zeros((32769, 1, 3), np.uint8), p),
             (np.zeros((0, 4, 3), np.uint8), p),
             (_image((3, 5)), str(tmp_path / "no" / "x.bmp")))
    for img, path in cases:
        got = _outcome(lambda: tbmp.bmp_save(path, img))
        want = _outcome(lambda: jax_codec.bmp_save(
            path, img.tobytes(), *img.shape[:2]))
        assert got is not None and got == want, (img.shape, got, want)
    assert not os.path.exists(p)
    for shape in ((2, 2, 4), (2, 2)):
        img = np.zeros(shape, np.uint8)
        got = _outcome(lambda: tbmp.bmp_save(p, img))
        assert got is not None and got[0] is ValueError, (shape, got)
        assert _outcome(lambda: tbmp.bmp_save_plain(p, img))[0] is \
            ValueError
        assert not os.path.exists(p)


def test_load_batch_raises_as_the_jax_codec(tmp_path, jax_codec):
    """Mixed sizes (the first failing index named), a bad first path, a
    bad later one and an empty list: the JAX package's codec's classes and
    messages."""
    rng = np.random.RandomState(4)
    good = [_write(tmp_path / f"g{i}.bmp", _bmp_bytes(
        rng.randint(0, 256, (6, 9, 3), np.uint8))) for i in range(6)]
    odd = _write(tmp_path / "odd.bmp", _bmp_bytes(_image((4, 4))))
    bad = _bad_files(tmp_path)
    cases = {"mixed sizes": good[:3] + [odd] + good[3:],
             "mixed sizes at the end": good + [odd],
             "bad first path": [bad["wrong magic"]] + good,
             "missing first path": [bad["missing"]] + good,
             "rows cut short later": good[:2] + [bad["rows cut short"]],
             "missing later": good[:4] + [bad["missing"]],
             "empty": []}
    for name, paths in cases.items():
        for threads in (0, 1, 3):
            got = _outcome(lambda: tloader.load_batch(paths, threads))
            want = _outcome(lambda: jax_codec.load_batch(paths, threads))
            assert got is not None and got == want, (name, threads, got)
    assert _outcome(lambda: tloader.load_batch(cases["mixed sizes"]))[0] \
        is OSError
    assert _outcome(lambda: tloader.load_batch([]))[0] is ValueError


# ---------------------------------------------------------- (c) rectangles


@pytest.mark.parametrize("rect", [(1, 1, 10, 8), (-5, 10, 70, 35),
                                  (59, 39, 0, 0), (30, -4, 12, 50),
                                  (-9, -9, -1, 3), (60, 40, 60, 40),
                                  (5, 7, 5, 7)], ids=str)
def test_draw_rectangle_equals_the_port(rect, jax_codec):
    """The extension's ``draw_rectangle`` (clipped per pixel, any corner
    order) leaves the pixels the port's numpy one does, as the JAX
    package's codec does."""
    img = _image((40, 60), 2)
    want = img.copy()
    tbmp.draw_rectangle(want, *rect, 200, 100, 50)
    for codec in (native.codec(), jax_codec):
        buf = bytearray(img.tobytes())
        codec.draw_rectangle(buf, 40, 60, *rect, 200, 100, 50)
        np.testing.assert_array_equal(
            np.frombuffer(buf, np.uint8).reshape(40, 60, 3), want)


# ---------------------------------------------------------------- (d) build


CHILD = textwrap.dedent("""
    import sys, threading
    from ffcnn_tpu_torch.imageio import bmp, loader, native
    print("imported", native.MODULE in sys.modules,
          native.BUILD_DIR.exists(), flush=True)
    out = []
    def run():
        out.append(bmp.bmp_load(sys.argv[1]).sum())
    ts = [threading.Thread(target=run) for _ in range(3)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    print("decoded", len(out), int(out[0]), native.codec().__file__,
          flush=True)
""")


@pytest.fixture
def pkg_copy(tmp_path):
    """A copy of the package's codec modules (its ``__init__``,
    ``imageio/`` and ``native/``) with no ``_build/``, and a compiler that
    logs each call, waits and runs gcc."""
    src = os.path.join(REPO, "ffcnn_tpu_torch")
    dst = tmp_path / "ffcnn_tpu_torch"
    shutil.copytree(os.path.join(src, "imageio"), dst / "imageio",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copytree(os.path.join(src, "native"), dst / "native")
    shutil.copy(os.path.join(src, "__init__.py"), dst)
    cc = tmp_path / "cc.sh"
    cc.write_text(f"#!/bin/sh\necho $$ >> {tmp_path / 'cc.log'}\n"
                  f"sleep 0.5\nexec {os.environ.get('CC', 'gcc')} \"$@\"\n")
    cc.chmod(0o755)
    return tmp_path


def _start(root):
    """A fresh process in ``root`` that runs CHILD with the logging
    compiler."""
    return subprocess.Popen(
        [sys.executable, "-c", CHILD, BMP], cwd=root,
        env=dict(os.environ, CC=str(root / "cc.sh")), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)


def _child(root):
    proc = _start(root)
    out, err = proc.communicate(timeout=120)
    return out, err, proc.returncode


def _compiles(root):
    log = root / "cc.log"
    return len(log.read_text().split()) if log.exists() else 0


def test_import_compiles_nothing_then_one_build_is_reused(pkg_copy):
    """Importing the modules starts no compiler and makes no build
    directory; the first ``bmp_load`` (three threads at once) builds one
    library into ``_build/``; a second process loads it without a
    compiler."""
    want = int(tbmp.bmp_load_plain(BMP).sum())
    out, err, rc = _child(pkg_copy)
    assert rc == 0, err
    lines = out.splitlines()
    assert lines[0] == "imported False False"
    built = pkg_copy / "ffcnn_tpu_torch" / "_build"
    libs = sorted(built.iterdir())
    assert len(libs) == 1 and libs[0].name.startswith("bmp_codec-")
    assert lines[1] == f"decoded 3 {want} {libs[0]}"
    assert _compiles(pkg_copy) == 1
    stamp = libs[0].stat().st_mtime_ns
    out, err, rc = _child(pkg_copy)
    assert rc == 0, err
    assert out.splitlines() == ["imported False True",
                                f"decoded 3 {want} {libs[0]}"]
    assert _compiles(pkg_copy) == 1
    assert sorted(built.iterdir()) == libs
    assert libs[0].stat().st_mtime_ns == stamp


def test_two_processes_building_at_once_both_load(pkg_copy):
    """Two processes (three threads each) that build at once both load a
    whole library, and no temporary file is left."""
    want = int(tbmp.bmp_load_plain(BMP).sum())
    procs = [_start(pkg_copy) for _ in range(2)]
    for proc in procs:
        out, err = proc.communicate(timeout=120)
        assert proc.returncode == 0, err
        assert out.splitlines()[1].startswith(f"decoded 3 {want} ")
    assert _compiles(pkg_copy) == 2
    names = [p.name for p in
             (pkg_copy / "ffcnn_tpu_torch" / "_build").iterdir()]
    assert len(names) == 1 and not names[0].endswith(".tmp"), names


def test_a_failed_build_raises(pkg_copy):
    """With a compiler that fails, ``bmp_load``, ``bmp_save`` and
    ``load_batch`` raise with the build's error, return nothing, and no
    library is left."""
    code = textwrap.dedent("""
        import sys
        import numpy as np
        from ffcnn_tpu_torch.imageio import bmp, loader
        for name, fn in (
                ("bmp_load", lambda: bmp.bmp_load(sys.argv[1])),
                ("bmp_save", lambda: bmp.bmp_save(
                    sys.argv[2], np.zeros((2, 2, 3), np.uint8))),
                ("load_batch", lambda: loader.load_batch([sys.argv[1]]))):
            try:
                got = fn()
            except RuntimeError as e:
                print(name, "raised", str(e).splitlines()[0])
            else:
                print(name, "returned", type(got).__name__)
    """)
    res = subprocess.run(
        [sys.executable, "-c", code, BMP, str(pkg_copy / "x.bmp")],
        cwd=pkg_copy, env=dict(os.environ, CC="false"), capture_output=True,
        text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    lines = res.stdout.splitlines()
    assert [ln.split()[:2] for ln in lines] == [
        ["bmp_load", "raised"], ["bmp_save", "raised"],
        ["load_batch", "raised"]], lines
    assert all("building the BMP codec failed (exit 1): false " in ln
               for ln in lines), lines
    assert not (pkg_copy / "x.bmp").exists()
    assert list((pkg_copy / "ffcnn_tpu_torch" / "_build").iterdir()) == []


def test_the_codec_is_built_from_the_ports_source():
    """The loaded library is the one built into the port's ``_build/`` from
    the port's own source; nothing under the JAX package's ``native/`` is
    read."""
    pkg = os.path.join(REPO, "ffcnn_tpu_torch")
    assert str(native.SOURCE) == os.path.join(pkg, "native", "bmp_codec.c")
    assert native.codec().__file__ == str(native.library_path())
    assert str(native.library_path()).startswith(
        os.path.join(pkg, "_build", "bmp_codec-"))
    assert native.codec().__name__ == native.MODULE
    assert sys.modules[native.MODULE] is native.codec()
