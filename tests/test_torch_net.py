"""The port's graph and Net (ffcnn_tpu_torch) against the JAX package's on
the CPU, blob by blob and detection by detection, with synthesized weights
(seed 42, as tests/test_model_zoo.py makes them)."""

import os
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import ffcnn_tpu as jt
import ffcnn_tpu_torch as pt
from ffcnn_tpu.darknet import parse_cfg
from ffcnn_tpu.darknet.weights import load_weights, synth_weights_bytes
from ffcnn_tpu.graph import build as jbuild
from ffcnn_tpu.imageio.bmp import bmp_load
from ffcnn_tpu.kernels import block_fused as jbf
from ffcnn_tpu.ops import preprocess as jpre
from ffcnn_tpu_torch.graph import build as tbuild
from ffcnn_tpu_torch.testing import cap_threads

cap_threads()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MICRO = os.path.join(REPO, "models", "ffcnn-micro.cfg")
XL = os.path.join(REPO, "models", "yolo-fastest-xl.cfg")
BMP = os.path.join(REPO, "tests", "fixtures", "test320.bmp")


def _model(cfg, size, seed=42):
    """JAX's IR, the port's IR (each package's own parser) and the folded
    params, which both packages take."""
    ir = parse_cfg(cfg, size, size)
    params, _ = load_weights(ir, synth_weights_bytes(ir, seed=seed,
                                                     obj_bias=2.0))
    return ir, pt.parse_cfg(cfg, size, size), params


def _frames(size, n, seed=0):
    rng = np.random.RandomState(seed)
    return rng.randint(0, 256, (n, size, size, 3), dtype=np.uint8)


@pytest.mark.parametrize("cfg,size", [(MICRO, 64), (XL, 160)],
                         ids=["micro", "xl"])
def test_parity_blobs_agree(cfg, size):
    """Every materialised blob of the float32 forward agrees with JAX's
    (HIGHEST precision) through the two blob hooks."""
    ir, tir, params = _model(cfg, size)
    x = jpre.letterbox(jnp.asarray(_frames(size, 2)), size, size)
    jblobs, tblobs = {}, {}
    jbuild.forward_features(ir, jbuild.params_to_pytree(params), x,
                            precision=jax.lax.Precision.HIGHEST,
                            blob_hook=lambda i, v: jblobs.__setitem__(
                                i, np.asarray(v)))
    tbuild.forward_features(tir, tbuild.params_from_numpy(params),
                            torch.from_numpy(np.asarray(x)),
                            blob_hook=lambda i, v: tblobs.__setitem__(
                                i, v.numpy()))
    assert sorted(tblobs) == sorted(jblobs)
    for i in sorted(jblobs):
        want, got = jblobs[i], tblobs[i]
        assert got.shape == want.shape, i
        # float32 sums in another order, compounded over the depth: 1e-4
        # of the blob's own range
        scale = max(np.abs(want).max(), 1e-6)
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * scale,
                                   err_msg=f"blob {i}")


def _assert_same_detections(got, want, score_tol):
    assert len(got) == len(want)
    for dg, dw in zip(got, want):
        assert len(dg) == len(dw)
        for g, w in zip(dg, dw):
            assert g.class_id == w.class_id
            assert [int(v) for v in (g.x1, g.y1, g.x2, g.y2)] == \
                [int(v) for v in (w.x1, w.y1, w.x2, w.y2)]
            assert abs(g.score - w.score) <= score_tol


@pytest.mark.parametrize("cfg,size", [(MICRO, 64), (XL, 160)],
                         ids=["micro", "xl"])
def test_parity_detect_equals_jax(cfg, size):
    ir, tir, params = _model(cfg, size)
    frames = _frames(size, 2, seed=1)
    if cfg == XL:
        # the fixture frame, letterboxed down from 320x320
        frames = np.stack([bmp_load(BMP)] * 2)
        frames[1] = _frames(320, 1, seed=1)[0]
    got = pt.Net(tir, params, mode="parity", topk=64,
                 device="cpu").detect(frames)
    want = jt.Net(ir, params, mode="parity", topk=64).detect(frames)
    assert sum(map(len, want)) > 0
    # scores: float32 noise through the whole net (see the blob test)
    _assert_same_detections(got, want, score_tol=1e-4)


def test_fast_heads_match_jax_fused_interpret():
    """Fast mode (folded conv-1, bf16 blobs, fused runs) against JAX's
    forward with its fused Pallas runs in interpret mode."""
    ir, tir, params = _model(XL, 64)
    frames = _frames(64, 2, seed=2)
    net = pt.Net(tir, params, mode="fast", device="cpu")
    assert [(r.start, r.end) for r in net._fused_runs] == \
        [(r.start, r.end) for r in jbf.plan_runs(ir)]
    got = net.forward_heads(torch.from_numpy(frames))
    jp = jbuild.fold_input_transform(ir, jbuild.params_to_pytree(params),
                                     pt.DEFAULT_MEAN, pt.DEFAULT_NORM)
    want = jax.jit(lambda x: jbuild.forward_features(
        ir, jp, jpre.letterbox_uint8(x, 64, 64), input_dtype=jnp.bfloat16,
        fused_runs=jbf.plan_runs(ir), fused_interpret=True))(
            jnp.asarray(frames))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        g, w = g.float().numpy(), np.asarray(jnp.asarray(w, jnp.float32))
        scale = np.abs(w).max()
        # bf16 blobs: one-ulp (2^-8) rounding flips between two float32
        # sum orders, carried through ~100 layers
        err = np.abs(g - w)
        assert err.max() <= 2 ** -3 * scale, err.max() / scale
        assert err.mean() <= 2 ** -8 * scale, err.mean() / scale


def test_detect_resize_path():
    """A 640x448 frame letterboxes onto the 96x96 net and its boxes come
    back in the frame's pixels: parity equals JAX's, fast mode runs."""
    ir, tir, params = _model(XL, 96)
    frame = np.random.RandomState(4).randint(0, 256, (448, 640, 3),
                                             dtype=np.uint8)
    got = pt.Net(tir, params, mode="parity", topk=64,
                 device="cpu").detect(frame)
    want = jt.Net(ir, params, mode="parity", topk=64).detect(frame)
    assert len(want) > 0
    _assert_same_detections([got], [want], score_tol=1e-4)
    fast = pt.Net(tir, params, mode="fast", topk=64,
                  device="cpu").detect(frame)
    assert fast and all(0 < d.score <= 1 for d in fast)


def test_parity_saturation_grows_k():
    """With topk below the candidate count, parity mode retries at a larger
    K, like the JAX Net, and reports every survivor."""
    _, tir, params = _model(MICRO, 64)
    frames = _frames(64, 2, seed=5)
    got = pt.Net(tir, params, mode="parity", topk=8,
                 device="cpu").detect(frames)
    full = pt.Net(tir, params, mode="parity", topk=4096,
                  device="cpu").detect(frames)
    assert got == full
    assert max(map(len, got)) > 8


def test_dump_and_modes():
    ir, tir, params = _model(MICRO, 64)
    net = pt.Net(tir, params, mode="parity", device="cpu")
    assert net.dump() == jt.Net(ir, params, mode="parity").dump()
    n8 = pt.Net(tir, params, mode="int8", device="cpu")
    assert n8.dump() == net.dump() and n8.quant is None
    assert n8._dtype == torch.bfloat16 and n8._can_fold_input()
    with pytest.raises(ValueError):
        pt.Net(tir, params, mode="turbo", device="cpu")


def test_cuda_device_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, tir, params = _model(MICRO, 64)
    with pytest.raises(RuntimeError):
        pt.Net(tir, params, device="cuda")


def test_entry_points_default_to_the_card(tmp_path):
    """Net, Net.load (also through the params cache), load and the
    server's main run on the card unless the caller asks for the CPU: with
    no card they raise instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from ffcnn_tpu_torch import serve
    _, tir, params = _model(MICRO, 64)
    w = pt.synth_weights_bytes(tir, seed=42)
    wpath = str(tmp_path / "micro.weights")
    with open(wpath, "wb") as f:
        f.write(w)
    cache = str(tmp_path / "cache")
    for make in (lambda: pt.Net(tir, params),
                 lambda: pt.Net.load(MICRO, w),
                 lambda: pt.Net.load(MICRO, wpath, cache_dir=cache),
                 lambda: pt.load(MICRO, w, mode="parity"),
                 lambda: serve.main(["--cfg", MICRO, "--weights", wpath])):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()
    assert pt.load(MICRO, w, device="cpu").device.type == "cpu"
    assert pt.Net.load(MICRO, wpath, cache_dir=cache,
                       device="cpu").device.type == "cpu"


def test_chip_smoke_names_only_the_port():
    """chip_smoke.py reaches the darknet and BMP host code through the
    port's re-exports: it imports neither jax nor the JAX package."""
    import ast
    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    names = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names}
    names |= {n.module for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom)}
    assert "ffcnn_tpu_torch" in names
    assert not {n.split(".")[0] for n in names} & {"jax", "ffcnn_tpu"}, names


def test_port_runs_without_jax(tmp_path):
    """The port imports neither jax nor the JAX package: with both made
    unimportable it loads a model and detects on the CPU, through the
    port's names only, and no module of the JAX package was loaded."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['ffcnn_tpu'] = None\n"
        "import numpy as np\n"
        "import ffcnn_tpu_torch as pt\n"
        f"cfg = {MICRO!r}\n"
        "w = pt.synth_weights_bytes(pt.parse_cfg(cfg), seed=42,\n"
        "                           obj_bias=2.0)\n"
        "for mode in ('fast', 'parity'):\n"
        "    net = pt.load(cfg, w, mode=mode, device='cpu')\n"
        "    img = np.random.RandomState(0).randint(0, 256, (64, 64, 3),\n"
        "                                           dtype=np.uint8)\n"
        "    dets = net.detect(img)\n"
        "    assert dets and all(d.score > 0 for d in dets), mode\n"
        "assert not any(m.split('.')[0] in ('jax', 'ffcnn_tpu')\n"
        "               for m, v in sys.modules.items() if v is not None)\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"
