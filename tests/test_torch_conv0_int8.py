"""Conv-1 in int8 straight off the uint8 pixels (``FFCNN_CONV0_INT8=1``):
the port's ``ops.conv.conv0_int8_from_u8`` and the int8 conv's uint8 mode
(``kernels/conv_int8.py``) against ``ffcnn_tpu/ops/conv.py::
conv0_int8_from_u8`` on the CPU, and a fast Net under the flag against the
JAX forward and detect under it, with the JAX package's guard (its
precedence over the stem kernel, parity mode ignoring the flag)."""

import dataclasses
import functools
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
from ffcnn_tpu_torch.testing import cap_threads

cap_threads()

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


# ------------------------------------------------ the stems the u8 path takes
# (tag, cfg, activation) of each stem shape the kernel's u8 path has an
# instance for beside xl's: micro F 8 s2, yolov3-tiny F 16 s1, yolov4-tiny
# F 32 s2, yolov4 F 32 s1 mish, YOLOv8n's F 16 s2 swish (cfg None)
STEMS = {"micro": MICRO,
         "yolov3-tiny": os.path.join(REPO, "models", "yolov3-tiny.cfg"),
         "yolov4-tiny": os.path.join(REPO, "models", "yolov4-tiny.cfg"),
         "yolov4": os.path.join(REPO, "models", "yolov4.cfg"),
         "v8n": None}


def _stem(tag, size):
    """(folded HWIO float32 weights, scale, bias, stride, act) of a stem:
    the cfg's layer 0 with ``synth_weights_bytes`` (its first draws, the
    graph cut to that layer) and the demo input transform folded in;
    YOLOv8n's a seeded random filter bank (F 16, stride 2, swish)."""
    cfg = STEMS[tag]
    if cfg is None:
        rng = np.random.RandomState(11)
        return (rng.normal(0, 0.05, (3, 3, 3, 16)).astype(np.float32),
                (rng.rand(16) + 0.5).astype(np.float32),
                rng.normal(0, 0.1, 16).astype(np.float32), 2, 6)
    ir = parse_cfg(cfg, size, size)
    ir = dataclasses.replace(ir, layers=ir.layers[:1], blobs=ir.blobs[:2])
    params, _ = load_weights(ir, synth_weights_bytes(ir, seed=42))
    p = jbuild.fold_input_transform(ir, jbuild.params_to_pytree(params),
                                    pt.DEFAULT_MEAN, pt.DEFAULT_NORM)[0]
    l0 = ir.layers[0]
    return (np.array(p["weights"], np.float32),
            np.array(p["scale"], np.float32),
            np.array(p["bias"], np.float32), l0.stride, l0.activation)


@pytest.mark.parametrize("size", [33, 34])
@pytest.mark.parametrize("tag", list(STEMS))
def test_stem_plain_equals_jax(tag, size):
    """The plain uint8 mode (the u8 path's yardstick on the card) against
    JAX's ``conv0_int8_from_u8`` at every stem shape the u8 path has an
    instance for, on seeded pixels, float32 and bf16.  The integer sums are
    exact on both sides; linear and leaky take one float32 ulp (an XLA
    multiply-add) with 99% equal; mish and swish round their
    transcendentals apart on the two CPUs (up to 3.7e-7 relative): rtol
    1e-6; a bf16 output one bf16 ulp."""
    w, scale, bias, stride, act = _stem(tag, size)
    x = np.random.RandomState(size).randint(0, 256, (2, size, size, 3),
                                            dtype=np.uint8)
    kw = dict(stride=stride, pad=1, act=act)
    smooth = act in (4, 6)
    # linear and leaky eager (jitted, XLA fuses a multiply-add into the
    # epilogue), mish and swish jitted (eager compiles each of their ops);
    # JAX's bf16 output is its float32 result's last cast
    fn = functools.partial(jconv.conv0_int8_from_u8, weights=w,
                           scale=scale, bias=bias, float_dtype=jnp.float32,
                           **kw)
    y = (jax.jit(fn) if smooth else fn)(jnp.asarray(x))
    for dtype in ("float32", "bfloat16"):
        want = np.asarray(y.astype(getattr(jnp, dtype)).astype(jnp.float32))
        got = tconv.conv0_int8_from_u8(
            torch.from_numpy(x), torch.from_numpy(w),
            torch.from_numpy(scale), torch.from_numpy(bias),
            float_dtype=getattr(torch, dtype), **kw)
        assert got.dtype == getattr(torch, dtype)
        got = got.float().numpy()
        oh = (size - 1) // stride + 1
        assert got.shape == want.shape == (2, oh, oh, w.shape[3])
        tol = 2 ** -8 if dtype == "bfloat16" else 1e-6 if smooth else 2 ** -23
        np.testing.assert_allclose(got, want, rtol=tol,
                                   atol=tol * np.abs(want).max())
        if dtype == "float32" and not smooth:
            assert np.mean(got == want) >= 0.99


def _byte_perm(x, y, sel):
    """CUDA's __byte_perm on uint32 arrays: result byte i is byte (sel >>
    4i) & 7 of the eight bytes y:x."""
    b = np.stack([(x >> (8 * i)) & 0xFF for i in range(4)]
                 + [(y >> (8 * i)) & 0xFF for i in range(4)])
    out = np.zeros(np.broadcast(x, y, sel).shape, np.uint32)
    for i in range(4):
        nib = (np.broadcast_to(sel, out.shape) >> (4 * i)) & 7
        out |= np.take_along_axis(b, nib[None].astype(np.int64), 0)[0] \
            << np.uint32(8 * i)
    return out


def _u8_stem_sums(x, wp, stride):
    """A numpy model of the u8 path's stem instance (k 3, C 3, pad 1): the
    staged rows (pad bytes 0, a row's first tap at byte 3 s ox + 13), each
    lane's three aligned words and __byte_perm picks, the 32 K slots (lanes
    t < 3: row t's bytes 0..3 and 4..7; lane 3: byte 8 of each row) against
    the weight codes permuted to match, and their sum S = sum wq * x.
    Returns S (n, oh, ow, F) int64."""
    n, h, w, _ = x.shape
    oh, ow = (h - 1) // stride + 1, (w - 1) // stride + 1
    ld = -(-(16 + 3 * w + 32) // 16) * 16
    rows = np.zeros((n, h + 2 + stride, ld), np.uint8)   # input row iy at
    rows[:, 1:h + 1, 16:16 + 3 * w] = x.reshape(n, h, 3 * w)   # row iy + 1
    words = rows.view("<u4").astype(np.uint32)           # (n, rows, ld / 4)
    ox = np.arange(ow)
    o = 3 * stride * ox + 13
    o3 = (o & 3).astype(np.uint32)
    assert np.array_equal(o3, (3 * stride * (ox % 8) + 13) & 3)
    base = (o & ~3) // 4                                  # word of o & ~3
    a_slots = np.zeros((n, oh, ow, 32), np.int64)
    for oy in range(oh):
        r0 = stride * oy                                  # staged row of ky 0

        def word(ky, at):
            return words[:, r0 + ky, at]                  # (n, ow)
        for t in range(4):
            if t < 3:
                w0, w1, w2 = (word(t, base + j) for j in range(3))
                sel_a, sel_b = 0x3210 + 0x1111 * o3, np.uint32(0x3210)
            else:
                w0, w1, w2 = (word(j, base + 2) for j in range(3))
                sel_a = o3 | (4 + o3) << 4
                sel_b = 0x0010 | (4 + o3) << 8
            lo = _byte_perm(_byte_perm(w0, w1, sel_a), w2, sel_b)
            hi = _byte_perm(w1, w2, sel_a)
            for i in range(4):
                a_slots[:, oy, :, 4 * t + i] = (lo >> (8 * i)) & 0xFF
                a_slots[:, oy, :, 16 + 4 * t + i] = (hi >> (8 * i)) & 0xFF
    b_slots = np.zeros((wp.shape[0], 32), np.int64)       # slot -> code
    for t in range(3):
        b_slots[:, 4 * t:4 * t + 4] = wp[:, 9 * t:9 * t + 4]
        b_slots[:, 16 + 4 * t:20 + 4 * t] = wp[:, 9 * t + 4:9 * t + 8]
        b_slots[:, 12 + t] = wp[:, 9 * t + 8]
    return a_slots @ b_slots.T


@pytest.mark.parametrize("stride", [1, 2])
def test_u8_path_integer_identities(stride):
    """The u8 path's integers at border and interior pixels: S, the sum of
    its permuted K slots over the raw pixels (a numpy model of the stem
    instance's gather), equals the shifted codes' accumulators plus m128 (so
    S * eff + bias is the plain version's (acc + m128) * eff + bias), and
    its raw mode's S - 128 T (T the codes of the pixel's in-bounds taps,
    the (tap, F) table's total less the taps outside) equals those
    accumulators."""
    rng = np.random.RandomState(20 + stride)
    w = rng.normal(0, 0.05, (3, 3, 3, 16)).astype(np.float32)
    x = rng.randint(0, 256, (2, 13, 14, 3)).astype(np.uint8)
    x[0, :2] = 255            # saturated rows at a border
    cp = tci.prepare_conv0(torch.from_numpy(w), torch.ones(16),
                           torch.zeros(16), h=13, w=14, stride=stride,
                           pad=1, act=0)
    wp = cp.wp.numpy()
    s = _u8_stem_sums(x, wp, stride)
    acc = tci.conv_int8(torch.from_numpy(x), cp, raw=True).numpy()
    n, oh, ow, f = acc.shape
    m128 = cp.m128.double().numpy().reshape(oh, ow, f)
    assert np.array_equal(s, acc + m128)
    tsum = wp[:, :27].reshape(f, 9, 3).astype(np.int64).sum(-1).T  # (9, F)
    tot = np.broadcast_to(tsum.sum(0), (oh, ow, f)).copy()
    for oy in range(oh):
        for ox in range(ow):
            for ky in range(3):
                for kx in range(3):
                    iy, ix = stride * oy - 1 + ky, stride * ox - 1 + kx
                    if not (0 <= iy < 13 and 0 <= ix < 14):
                        tot[oy, ox] -= tsum[3 * ky + kx]
    assert (tot != tsum.sum(0)).any()          # border pixels were reached
    assert np.array_equal(s - 128 * tot, acc)


@pytest.mark.parametrize("args,kw", [
    ((3, 16, 3, 2, 1), {}), ((3, 32, 3, 1, 1), {}), ((3, 8, 3, 2, 1), {}),
    ((3, 8, 3, 1, 1), {}), ((1, 24, 5, 1, 1), {}), ((4, 40, 3, 2, 1), {}),
    ((48, 16, 1, 1, 1), {}), ((3, 16, 3, 2, 1), {"aligned": False})])
def test_uint8_calls_route_u8(args, kw):
    """Every uint8-mode call takes the u8 path (the stems' instances and the
    generic one alike, aligned or not); no int8-code call does."""
    assert tci.route(*args, x_u8=True, **kw) == "u8"
    assert tci.route(*args, **kw) != "u8"
    assert all(tci.route(c, f, k, s, g, aligned=al) != "u8"
               for c, f, g in ((3, 16, 1), (16, 16, 16), (48, 96, 1),
                               (40, 40, 40), (16, 8, 4))
               for k in (1, 3, 5) for s in (1, 2) for al in (True, False))
