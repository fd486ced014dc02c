"""The port's ops (ffcnn_tpu_torch/ops) against the JAX package's, on the
CPU.  Inputs come from numpy with a fixed seed and go through both."""

import os

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from ffcnn_tpu.darknet import parse_cfg
from ffcnn_tpu.darknet.ir import Activation
from ffcnn_tpu.darknet.weights import load_weights, synth_weights_bytes
from ffcnn_tpu.graph import build as jbuild
from ffcnn_tpu.ops import activations as jact
from ffcnn_tpu.ops import conv as jconv
from ffcnn_tpu.ops import pool as jpool
from ffcnn_tpu.ops import preprocess as jpre
from ffcnn_tpu_torch.darknet import parse_cfg as tparse_cfg
from ffcnn_tpu_torch.graph import build as tbuild
from ffcnn_tpu_torch.ops import activations as tact
from ffcnn_tpu_torch.ops import conv as tconv
from ffcnn_tpu_torch.ops import pool as tpool
from ffcnn_tpu_torch.ops import preprocess as tpre
from ffcnn_tpu_torch.testing import cap_threads

cap_threads()

MICRO = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "models", "ffcnn-micro.cfg")

# bf16 keeps 8 significant bits: results that round from f32 values an ulp
# apart (different exp/summation order) differ by up to 2^-8 relative.
BF16_RTOL = 2 ** -7


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


ACTS = [int(a) for a in Activation] + [-1]


@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_activations(act, dtype):
    rng = np.random.RandomState(act + 10)
    x = (rng.randn(4, 5, 7, 6) * 4).astype(np.float32)
    jx = jnp.asarray(x, dtype)
    tx = _t(x).to(getattr(torch, dtype))
    got, want = _np(tact.activate(tx, act)), _np(jact.activate(jx, act))
    # f32: exp/log1p/tanh come from different libms (a few ulp apart)
    rtol = 1e-5 if dtype == "float32" else BF16_RTOL
    np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-6)


CONV_CASES = [  # (C, fn, fs, stride, groups)
    (6, 8, 1, 1, 1), (6, 8, 3, 1, 1), (6, 8, 3, 2, 1), (6, 4, 5, 1, 1),
    (8, 8, 3, 1, 8), (8, 8, 5, 2, 8), (8, 12, 3, 1, 4), (8, 16, 1, 2, 2)]


@pytest.mark.parametrize("c,fn,fs,stride,groups", CONV_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_conv2d_fused(c, fn, fs, stride, groups, dtype):
    rng = np.random.RandomState(fs * 100 + c + fn + stride + groups)
    x = rng.randn(2, 11, 9, c).astype(np.float32)
    w = (rng.randn(fs, fs, c // groups, fn) * 0.3).astype(np.float32)
    scale = rng.rand(fn).astype(np.float32) + 0.5
    bias = rng.randn(fn).astype(np.float32) * 0.1
    pad = fs // 2
    want = jconv.conv2d_fused(jnp.asarray(x, dtype), jnp.asarray(w),
                              jnp.asarray(scale), jnp.asarray(bias),
                              stride=stride, pad=pad, groups=groups,
                              act=Activation.LEAKY)
    got = tconv.conv2d_fused(_t(x).to(getattr(torch, dtype)),
                             _t(w.transpose(3, 2, 0, 1)), _t(scale), _t(bias),
                             stride=stride, pad=pad, groups=groups,
                             act=Activation.LEAKY)
    assert got.dtype == getattr(torch, dtype)
    assert tuple(got.shape) == tuple(want.shape)
    # f32: the same sums in another order; bf16: one rounding of those
    rtol = 1e-5 if dtype == "float32" else BF16_RTOL
    np.testing.assert_allclose(_np(got), _np(want), rtol=rtol, atol=1e-5)


POOL_CASES = [  # (fs, stride, H, W)
    (2, 2, 8, 8), (2, 2, 9, 7), (3, 2, 9, 11), (3, 1, 6, 6), (5, 1, 7, 6),
    (9, 1, 10, 10), (2, 1, 5, 5)]


@pytest.mark.parametrize("fs,stride,h,w", POOL_CASES)
@pytest.mark.parametrize("kind", ["max", "avg"])
def test_pools(fs, stride, h, w, kind):
    rng = np.random.RandomState(fs * 10 + h)
    x = rng.randn(2, h, w, 5).astype(np.float32)
    jf = jpool.maxpool2d if kind == "max" else jpool.avgpool2d
    tf = tpool.maxpool2d if kind == "max" else tpool.avgpool2d
    want = jf(jnp.asarray(x), fs, stride)
    got = tf(_t(x), fs, stride)
    assert tuple(got.shape) == tuple(want.shape)
    # max is exact; avg sums fs*fs floats in another order
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("stride", [2, 3])
def test_upsample(stride):
    x = np.random.RandomState(stride).randn(2, 3, 4, 5).astype(np.float32)
    np.testing.assert_array_equal(
        _np(tpool.upsample_nearest(_t(x), stride)),
        _np(jpool.upsample_nearest(jnp.asarray(x), stride)))


@pytest.mark.parametrize("img_hw", [(64, 64), (48, 80), (90, 40), (33, 57)])
def test_letterbox_family(img_hw):
    h, w = img_hw
    rng = np.random.RandomState(h * w)
    bgr = rng.randint(0, 256, (2, h, w, 3), dtype=np.uint8)
    assert tpre.letterbox_params(w, h, 64, 64) == \
        jpre.letterbox_params(w, h, 64, 64)
    np.testing.assert_array_equal(
        tpre.letterbox_uint8(_t(bgr), 64, 64).numpy(),
        np.asarray(jpre.letterbox_uint8(jnp.asarray(bgr), 64, 64)))
    mean, norm = (0.1, 0.2, 0.3), (1 / 255.0, 1 / 200.0, 1 / 100.0)
    got = tpre.letterbox(_t(bgr), 64, 64, mean, norm)
    want = jpre.letterbox(jnp.asarray(bgr), 64, 64, jnp.asarray(mean),
                          jnp.asarray(norm))
    # the same two f32 ops per element on both sides
    np.testing.assert_array_equal(_np(got), _np(want))


@pytest.mark.parametrize("mean", [(0.0, 0.0, 0.0), (10.0, 20.0, 30.0)])
def test_fold_input_transform(mean):
    ir = parse_cfg(MICRO, 64, 64)
    params, _ = load_weights(ir, synth_weights_bytes(ir, seed=5))
    norm = (1 / 255.0, 1 / 128.0, 1 / 64.0)
    want = jbuild.fold_input_transform(ir, jbuild.params_to_pytree(params),
                                       mean, norm)[0]
    got = tbuild.fold_input_transform(tparse_cfg(MICRO, 64, 64),
                                      tbuild.params_from_numpy(params),
                                      mean, norm)[0]
    np.testing.assert_allclose(
        got["weights"].numpy(),
        np.asarray(want["weights"]).transpose(3, 2, 0, 1), rtol=1e-7)
    # the bias sum runs over 27 taps in another order
    np.testing.assert_allclose(got["bias"].numpy(), np.asarray(want["bias"]),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_head_and_arena_cap(dtype):
    from ffcnn_tpu.ops import yolo as jyolo
    from ffcnn_tpu_torch.ops import yolo as tyolo
    ir, tir = parse_cfg(MICRO, 64, 64), tparse_cfg(MICRO, 64, 64)
    layer, tlayer = ir.yolo_layers[0], tir.yolo_layers[0]
    h, w = ir.blobs[layer.index].h, ir.blobs[layer.index].w
    rng = np.random.RandomState(7)
    feat = (rng.randn(2, h, w, 3 * (5 + layer.class_num)) * 2
            ).astype(np.float32)
    feat[0, 0, 0, 5:7] = 3.0                  # an argmax tie: first max wins
    jf = jnp.asarray(feat, dtype)
    tf = _t(feat).to(getattr(torch, dtype))
    want = jyolo.decode_head(jf, layer, 64, 64)
    got = tyolo.decode_head(tf, tlayer, 64, 64)
    np.testing.assert_array_equal(got.classes.numpy(),
                                  np.asarray(want.classes))
    # exp comes from different libms: a few f32 ulp
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got.boxes.numpy(), np.asarray(want.boxes),
                               rtol=1e-5, atol=1e-4)
    cap = int((np.asarray(want.scores) > 0).sum(axis=1).min()) // 2
    jc = jyolo.apply_arena_cap(want, cap)
    tc = tyolo.apply_arena_cap(
        tyolo.DecodedBoxes(_t(np.asarray(want.boxes)),
                           _t(np.asarray(want.scores)),
                           _t(np.asarray(want.classes))), cap)
    np.testing.assert_array_equal(tc.scores.numpy(), np.asarray(jc.scores))
    assert tyolo.arena_capacity(64, 48, 3) == jyolo.arena_capacity(64, 48, 3)
