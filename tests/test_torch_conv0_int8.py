"""Conv-1 in int8 straight off the uint8 pixels (``FFCNN_CONV0_INT8=1``):
the port's ``ops.conv.conv0_int8_from_u8`` and the int8 conv's uint8 mode
(``kernels/conv_int8.py``) against ``ffcnn_tpu/ops/conv.py::
conv0_int8_from_u8`` on the CPU, and a fast Net under the flag against the
JAX forward and detect under it, with the JAX package's guard (its
precedence over the stem kernel, parity mode ignoring the flag)."""

import os

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
from ffcnn_tpu.ops import conv as jconv
from ffcnn_tpu.ops import preprocess as jpre
from ffcnn_tpu_torch.graph import build as tbuild
from ffcnn_tpu_torch.kernels import conv_int8 as tci
from ffcnn_tpu_torch.ops import conv as tconv

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MICRO = os.path.join(REPO, "models", "ffcnn-micro.cfg")
XL = os.path.join(REPO, "models", "yolo-fastest-xl.cfg")
REGION_FLAGS = {"FFCNN_FUSED_DOWN": "1", "FFCNN_FUSED_MINC": "8",
                "FFCNN_CONV0_PALLAS": "1", "FFCNN_FUSED_HEADS": "1"}


def _model(cfg, size, seed=42):
    ir = parse_cfg(cfg, size, size)
    params, _ = load_weights(ir, synth_weights_bytes(ir, seed=seed,
                                                     obj_bias=2.0))
    return ir, pt.parse_cfg(cfg, size, size), params


def _frames(size, n, seed):
    return np.random.RandomState(seed).randint(0, 256, (n, size, size, 3),
                                               dtype=np.uint8)


@pytest.fixture(scope="module")
def xl_layer0():
    """xl's layer 0 with the demo input transform folded in, as a fast Net
    runs it: HWIO float32 weights, scale, bias, and the layer."""
    ir, _, params = _model(XL, 64)
    jp = jbuild.fold_input_transform(ir, jbuild.params_to_pytree(params),
                                     pt.DEFAULT_MEAN, pt.DEFAULT_NORM)
    p = jp[0]
    return (np.array(p["weights"], np.float32),
            np.array(p["scale"], np.float32),
            np.array(p["bias"], np.float32), ir.layers[0])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("size", [320, 322])
def test_conv0_int8_from_u8_equals_jax(xl_layer0, size, dtype):
    """The port's function against JAX's on seeded uint8 pixels at xl's
    layer 0 (3x3, stride 2, 16 filters, leaky), 320x320 and 322x322 (odd
    output rows and border taps).  Both take the same weight codes and the
    same exact integer sums; only the float32 epilogue (acc + 128 M) * eff
    + bias may round apart, if XLA fuses a multiply-add: one float32 ulp,
    which a bf16 store turns into at most one bf16 ulp."""
    w, scale, bias, l0 = xl_layer0
    x = np.random.RandomState(size).randint(0, 256, (2, size, size, 3),
                                            dtype=np.uint8)
    kw = dict(stride=l0.stride, pad=l0.pad, act=l0.activation)
    want = np.asarray(jnp.asarray(jconv.conv0_int8_from_u8(
        jnp.asarray(x), w, scale, bias, float_dtype=getattr(jnp, dtype),
        **kw), jnp.float32))
    got = tconv.conv0_int8_from_u8(
        torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(scale),
        torch.from_numpy(bias), float_dtype=getattr(torch, dtype), **kw)
    assert got.dtype == getattr(torch, dtype)
    got = got.float().numpy()
    assert got.shape == want.shape == (2, (size + 1) // 2, (size + 1) // 2,
                                       16)
    ulp = 2 ** -23 if dtype == "float32" else 2 ** -8
    np.testing.assert_allclose(got, want, rtol=ulp, atol=ulp * np.abs(
        want).max())
    assert np.mean(got == want) >= 0.99


def test_uint8_mode_accumulates_exactly(xl_layer0):
    """The uint8 mode's int32 accumulators are those of the int8 conv on the
    shifted codes x - 128, and adding 128 M gives the float64 conv of the
    raw pixels with the weight codes exactly."""
    w, scale, bias, l0 = xl_layer0
    x = torch.from_numpy(_frames(32, 2, seed=3))
    cp = tci.prepare_conv0(torch.from_numpy(w), torch.from_numpy(scale),
                           torch.from_numpy(bias), h=32, w=32,
                           stride=l0.stride, pad=l0.pad, act=l0.activation)
    acc = tci.conv_int8(x, cp, raw=True)
    shifted = (x.to(torch.int16) - 128).to(torch.int8)
    assert torch.equal(acc, tci.conv_int8_plain(
        shifted, tci.dataclasses.replace(cp, m128=None), raw=True))
    direct = torch.nn.functional.conv2d(
        x.permute(0, 3, 1, 2).double(), cp.wq.permute(3, 2, 0, 1).double(),
        stride=l0.stride, padding=l0.pad).permute(0, 2, 3, 1)
    assert torch.equal(acc.double() + cp.m128.view(16, 16, 16).double(),
                       direct)
    with pytest.raises(ValueError, match="another geometry"):
        tci.conv_int8(torch.from_numpy(_frames(16, 1, seed=4)), cp)


@pytest.mark.parametrize("cfg", [MICRO, XL], ids=["micro", "xl"])
def test_flag_net_heads_match_jax(cfg, monkeypatch):
    """A fast Net under FFCNN_CONV0_INT8=1 (conv-1 through the uint8 mode,
    its default fused runs) against JAX's folded forward with conv0_int8 at
    64x64: bf16 blobs carry one-ulp flips through the depth (the bounds of
    the default fast path's test in test_torch_net.py)."""
    ir, tir, params = _model(cfg, 64)
    frames = _frames(64, 2, seed=5)
    monkeypatch.setenv("FFCNN_CONV0_INT8", "1")
    net = pt.Net(tir, params, mode="fast", device="cpu")
    calls = []
    monkeypatch.setattr(tbuild, "conv_int8",
                        lambda *a, **k: calls.append(a[0].dtype)
                        or tci.conv_int8(*a, **k))
    got = net.forward_heads(torch.from_numpy(frames))
    assert calls == [torch.uint8]
    jp = jbuild.fold_input_transform(ir, jbuild.params_to_pytree(params),
                                     pt.DEFAULT_MEAN, pt.DEFAULT_NORM)
    want = jax.jit(lambda v: jbuild.forward_features(
        ir, jp, jpre.letterbox_uint8(v, 64, 64), input_dtype=jnp.bfloat16,
        conv0_int8=True))(jnp.asarray(frames))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = g.float().numpy(), np.asarray(jnp.asarray(w, jnp.float32))
        scale = np.abs(w).max()
        err = np.abs(g - w)
        assert err.max() <= 2 ** -3 * scale, err.max() / scale
        assert err.mean() <= 2 ** -8 * scale, err.mean() / scale


@pytest.mark.parametrize("cfg", [MICRO, XL], ids=["micro", "xl"])
def test_flag_detect_matches_jax(cfg, monkeypatch):
    """``detect`` under the flag against the JAX Net's at 64x64: 90% of each
    side's detections have a same-class detection on the other within 4 px
    and 0.02 in score (bf16 drift may let NMS keep another member of a
    cluster, as chip_smoke.py's fast-mode match allows)."""
    ir, tir, params = _model(cfg, 64)
    frames = _frames(64, 2, seed=6)
    monkeypatch.setenv("FFCNN_CONV0_INT8", "1")
    got = pt.Net(tir, params, mode="fast", device="cpu").detect(frames)
    want = jt.Net(ir, params, mode="fast").detect(frames)
    assert sum(map(len, want)) > 0

    def frac(a, b):
        hits = sum(any(e.class_id == d.class_id
                       and abs(e.score - d.score) <= 0.02
                       and max(abs(e.x1 - d.x1), abs(e.y1 - d.y1),
                               abs(e.x2 - d.x2), abs(e.y2 - d.y2)) <= 4.0
                       for e in bb) for aa, bb in zip(a, b) for d in aa)
        return hits / max(1, sum(map(len, a)))
    assert frac(got, want) >= 0.9 and frac(want, got) >= 0.9


def test_flag_takes_precedence_over_the_stem(monkeypatch):
    """With the region flags and FFCNN_CONV0_INT8=1 conv-1 runs in int8 and
    the stem kernel (K6) gives way, as JAX's guard orders them; the run at
    layer 1 then takes blob 1 as stored.  The heads equal those of the
    region Net without the stem flag, but with the int8 conv-1, bit for
    bit."""
    _, tir, params = _model(XL, 64)
    for k, v in {**REGION_FLAGS, "FFCNN_CONV0_INT8": "1"}.items():
        monkeypatch.setenv(k, v)
    net = pt.Net(tir, params, mode="fast", device="cpu")
    assert net._conv0_pallas and net._folded_all(
        pt.DEFAULT_MEAN, pt.DEFAULT_NORM)[2] is not None

    def refuse(*a, **k):
        raise AssertionError("the stem kernel ran under FFCNN_CONV0_INT8")
    monkeypatch.setattr(tbuild, "conv0_cs", refuse)
    x = torch.from_numpy(_frames(64, 2, seed=7))
    got = net.forward_heads(x)
    monkeypatch.setenv("FFCNN_CONV0_PALLAS", "0")
    ref = pt.Net(tir, params, mode="fast", device="cpu")
    assert all(torch.equal(g, w) for g, w in zip(got, ref.forward_heads(x)))


def test_parity_and_unfolded_paths_ignore_the_flag(monkeypatch):
    """Parity mode never folds conv-1, so the flag changes nothing there,
    as in JAX; nor on a fast Net's unfolded path (a nonzero mean)."""
    _, tir, params = _model(MICRO, 64)
    x = torch.from_numpy(_frames(64, 1, seed=8))
    base = pt.Net(tir, params, mode="parity", device="cpu").forward_heads(x)
    monkeypatch.setenv("FFCNN_CONV0_INT8", "1")
    net = pt.Net(tir, params, mode="parity", device="cpu")
    assert not net._conv0_int8
    assert all(torch.equal(g, w)
               for g, w in zip(net.forward_heads(x), base))

    def refuse(*a, **k):
        raise AssertionError("conv-1 ran in int8 on the unfolded path")
    fast = pt.Net(tir, params, mode="fast", device="cpu")
    monkeypatch.setattr(tbuild, "conv_int8", refuse)
    fast.forward_heads(x, mean=(1.0, 2.0, 3.0))
