"""The JAX package's flags that a port ``Net`` once ignored, on the CPU:
``FFCNN_FUSED=0`` (the kill switch of every fused block run),
``FFCNN_CONV0_INT8=1`` (conv-1 in int8, fast mode) and
``FFCNN_PARITY_PRECISION=high`` (3-pass bf16 parity convs).  The first is
honoured as JAX honours it; the other two are refused until they are
ported; each at its default leaves the plans as they were."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ffcnn_tpu_torch as pt
from ffcnn_tpu.darknet import parse_cfg
from ffcnn_tpu.darknet.weights import load_weights, synth_weights_bytes
from ffcnn_tpu.graph import build as jbuild
from ffcnn_tpu.kernels import block_fused as jbf
from ffcnn_tpu.ops import preprocess as jpre
from ffcnn_tpu_torch.graph import build as tbuild
from ffcnn_tpu_torch.ops.preprocess import letterbox_uint8
from ffcnn_tpu_torch.testing import cap_threads

cap_threads()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
XL = os.path.join(REPO, "models", "yolo-fastest-xl.cfg")
MICRO = os.path.join(REPO, "models", "ffcnn-micro.cfg")
REGION = {"FFCNN_FUSED_DOWN": "1", "FFCNN_FUSED_MINC": "8",
          "FFCNN_CONV0_PALLAS": "1", "FFCNN_FUSED_HEADS": "1"}
FLAGS = ("FFCNN_FUSED", "FFCNN_CONV0_INT8", "FFCNN_PARITY_PRECISION",
         *REGION)


@pytest.fixture(autouse=True)
def _no_flags(monkeypatch):
    for k in FLAGS:
        monkeypatch.delenv(k, raising=False)


def _model(cfg, size):
    ir = parse_cfg(cfg, size, size)
    params, _ = load_weights(ir, synth_weights_bytes(ir, seed=42,
                                                     obj_bias=2.0))
    return ir, pt.parse_cfg(cfg, size, size), params


def _plans(net):
    return ([(r.start, r.end) for r in net._fused_runs],
            [(r.start, r.end) for r in net._head_runs],
            net._folded_params(pt.DEFAULT_MEAN, pt.DEFAULT_NORM)[1]
            is not None)


def test_fused_0_plans_no_run_and_matches_jax(monkeypatch):
    """With FFCNN_FUSED=0 a fast xl Net plans no fused block run, as JAX's
    runs_usable turns them off, and every blob of its forward agrees with
    JAX's fast forward under the same flag (the blob-hook differential)."""
    ir, tir, params = _model(XL, 64)
    assert jbf.runs_usable(jbf.BATCH_QUANTUM, backend="tpu")
    monkeypatch.setenv("FFCNN_FUSED", "0")
    assert not jbf.runs_usable(jbf.BATCH_QUANTUM, backend="tpu")
    net = pt.Net(tir, params, mode="fast", device="cpu")
    assert net._fused_runs == [] and net._fused_params == {}
    frames = np.random.RandomState(7).randint(0, 256, (2, 64, 64, 3),
                                              dtype=np.uint8)
    jp = jbuild.fold_input_transform(ir, jbuild.params_to_pytree(params),
                                     pt.DEFAULT_MEAN, pt.DEFAULT_NORM)
    jblobs, tblobs = {}, {}
    jbuild.forward_features(
        ir, jp, jpre.letterbox_uint8(jnp.asarray(frames), 64, 64),
        input_dtype=jnp.bfloat16, fused_runs=None,
        blob_hook=lambda i, v: jblobs.__setitem__(
            i, np.asarray(jnp.asarray(v, jnp.float32))))
    tp, _ = net._folded_params(pt.DEFAULT_MEAN, pt.DEFAULT_NORM)
    tbuild.forward_features(
        tir, tp, letterbox_uint8(torch.from_numpy(frames), 64, 64),
        input_dtype=torch.bfloat16, fused_runs=net._fused_runs,
        fused_params=net._fused_params, fused_groups=net._fused_groups,
        mega_runs=net._mega_runs, head_runs=net._head_runs,
        head_params=net._head_params,
        blob_hook=lambda i, v: tblobs.__setitem__(i, v.float().numpy()))
    assert sorted(tblobs) == sorted(jblobs)
    for i in sorted(jblobs):
        want, got = jblobs[i], tblobs[i]
        assert got.shape == want.shape, i
        # bf16 blobs: one-ulp rounding flips between two float32 sum
        # orders, carried on through the layers (as the fast-mode heads in
        # tests/test_torch_net.py)
        scale = max(np.abs(want).max(), 1e-6)
        err = np.abs(got - want)
        assert err.max() <= 2 ** -3 * scale, (i, err.max() / scale)
        assert err.mean() <= 2 ** -8 * scale, (i, err.mean() / scale)


def test_fused_0_keeps_the_head_runs_and_drops_the_stem(monkeypatch):
    """Under the region flags, FFCNN_FUSED=0 plans no block run; the stem
    kernel, which hands its output to the run at layer 1, then has no run
    to feed and conv-1 runs as a plain conv (JAX's use_c0p needs that
    run); the head chains keep their own flag, FFCNN_FUSED_HEADS."""
    _, tir, params = _model(XL, 64)
    for k, v in REGION.items():
        monkeypatch.setenv(k, v)
    runs, heads, stem = _plans(pt.Net(tir, params, mode="fast",
                                      device="cpu"))
    assert runs and heads and stem
    monkeypatch.setenv("FFCNN_FUSED", "0")
    net = pt.Net(tir, params, mode="fast", device="cpu")
    assert _plans(net) == ([], heads, False)
    frames = np.random.RandomState(8).randint(0, 256, (2, 64, 64, 3),
                                              dtype=np.uint8)
    assert all(torch.isfinite(h.float()).all()
               for h in net.forward_heads(torch.from_numpy(frames)))


@pytest.mark.parametrize("flags", [{}, REGION], ids=["default", "region"])
@pytest.mark.parametrize("cfg", [XL, MICRO], ids=["xl", "micro"])
def test_flags_at_their_defaults_leave_the_plans(monkeypatch, cfg, flags):
    """FFCNN_FUSED=1, FFCNN_CONV0_INT8=0 and FFCNN_PARITY_PRECISION=highest
    plan what no flag plans, in both modes."""
    _, tir, params = _model(cfg, 64)
    for k, v in flags.items():
        monkeypatch.setenv(k, v)
    want = _plans(pt.Net(tir, params, mode="fast", device="cpu"))
    # micro's blocks are narrower than the default MIN_CHANNELS gate
    assert bool(want[0]) != (cfg == MICRO and not flags)
    monkeypatch.setenv("FFCNN_FUSED", "1")
    monkeypatch.setenv("FFCNN_CONV0_INT8", "0")
    monkeypatch.setenv("FFCNN_PARITY_PRECISION", "highest")
    assert _plans(pt.Net(tir, params, mode="fast", device="cpu")) == want
    parity = pt.Net(tir, params, mode="parity", device="cpu")
    assert parity._fused_runs == [] and parity._head_runs == []


def test_conv0_int8_is_refused_in_fast_mode(monkeypatch):
    """JAX quantizes conv-1 to int8 under FFCNN_CONV0_INT8=1 (fast mode,
    folded input); the port, which refused the flag before it had the int8
    conv's uint8 mode, now takes it there too: the fast Net makes conv-1's
    int8 params once and its forward runs conv-1 off the uint8 pixels
    (tests/test_torch_conv0_int8.py holds it against JAX).  Parity mode,
    which JAX never folds, ignores it as JAX does."""
    _, tir, params = _model(MICRO, 64)
    monkeypatch.setenv("FFCNN_CONV0_INT8", "1")
    net = pt.Net(tir, params, mode="fast", device="cpu")
    assert net._folded_all(pt.DEFAULT_MEAN,
                           pt.DEFAULT_NORM)[2].m128 is not None
    seen, conv = [], tbuild.conv_int8
    monkeypatch.setattr(tbuild, "conv_int8", lambda x, *a: seen.append(
        x.dtype) or conv(x, *a))
    heads = net.forward_heads(torch.zeros((1, 64, 64, 3), dtype=torch.uint8))
    assert seen == [torch.uint8] and all(torch.isfinite(h.float()).all()
                                         for h in heads)
    parity = pt.Net(tir, params, mode="parity", device="cpu")
    assert not parity._conv0_int8


@pytest.mark.parametrize("value", ["high", "HIGH"])
def test_parity_precision_high_is_refused(monkeypatch, value):
    """JAX runs parity convs at Precision.HIGH under
    FFCNN_PARITY_PRECISION=high (any case); the port refuses it in parity
    mode, and fast mode, where JAX does not read it, ignores it."""
    _, tir, params = _model(MICRO, 64)
    monkeypatch.setenv("FFCNN_PARITY_PRECISION", value)
    with pytest.raises(NotImplementedError,
                       match="FFCNN_PARITY_PRECISION"):
        pt.Net(tir, params, mode="parity", device="cpu")
    pt.Net(tir, params, mode="fast", device="cpu")
