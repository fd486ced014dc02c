"""The port's int8 mode against the JAX package's on the CPU, on seeded
numpy inputs: the plan policy and its weights (``quant.py``) bit for bit,
the calibration, the npz format both ways, the int8 conv's plain version
(exact int32 accumulators), the int8 boundaries of K1/K3/K4's plain
versions against the Pallas bodies in interpret mode, the whole int8
forward by its codes, and ``Net`` in int8 mode.  The CUDA kernels
(``csrc/conv_int8.cu`` and the int8 boundaries of K1/K3/K4) are held to
these plain versions on the card by ``chip_smoke.py`` phase 12."""

import glob
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax import lax

import ffcnn_tpu as jt
import ffcnn_tpu_torch as pt
from ffcnn_tpu import quant as jq
from ffcnn_tpu import roofline as jroof
from ffcnn_tpu import yolov8 as jy
from ffcnn_tpu.darknet import parse_cfg
from ffcnn_tpu.darknet.weights import load_weights, synth_weights_bytes
from ffcnn_tpu.graph import build as jbuild
from ffcnn_tpu.kernels import block_fused as jbf
from ffcnn_tpu.ops import conv as jconv
from ffcnn_tpu.ops import preprocess as jpre
from ffcnn_tpu_torch import quant as tq
from ffcnn_tpu_torch import roofline as troof
from ffcnn_tpu_torch import yolov8 as ty
from ffcnn_tpu_torch.darknet import parse_cfg as tparse
from ffcnn_tpu_torch.darknet.ir import LayerType
from ffcnn_tpu_torch.graph import build as tbuild
from ffcnn_tpu_torch.kernels import block_fused as tbf
from ffcnn_tpu_torch.kernels import conv_int8 as tci
from ffcnn_tpu_torch.ops import conv as tconv
from ffcnn_tpu_torch.testing import cap_threads

cap_threads()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFGS = sorted(glob.glob(os.path.join(REPO, "models", "*.cfg")))
CFG_IDS = [os.path.splitext(os.path.basename(p))[0] for p in CFGS]
XL = os.path.join(REPO, "models", "yolo-fastest-xl.cfg")
MICRO = os.path.join(REPO, "models", "ffcnn-micro.cfg")
MEAN, NORM = (0.0, 0.0, 0.0), (1 / 255.0,) * 3


def _model(cfg, size, seed=42, obj_bias=2.0):
    """JAX's IR, the port's IR and the darknet-folded params."""
    ir = parse_cfg(cfg, size, size)
    params, _ = load_weights(ir, synth_weights_bytes(ir, seed=seed,
                                                     obj_bias=obj_bias))
    return ir, tparse(cfg, size, size), params


@pytest.fixture(scope="module")
def xl96():
    return _model(XL, 96)


@pytest.fixture(scope="module")
def xl96_plan(xl96):
    """xl's per-tensor plan from JAX's calibration on two seeded frames,
    in both packages (the port's from JAX's arrays)."""
    ir, _, params = xl96
    imgs = np.random.RandomState(0).randint(0, 256, (2, 96, 96, 3),
                                            dtype=np.uint8)
    plan = jq.calibrate(ir, jbuild.params_to_pytree(params), imgs)
    return plan, tq.plan_from_numpy(plan)


def _v8_ir():
    sd = jy.synthesize_state_dict(80, "n", seed=0)
    cfg, _ = ty.convert(sd, 80, "n", size=64, conf=0.05)
    return parse_cfg(cfg, is_path=False), tparse(cfg, is_path=False)


def _assert_plans_equal(got, want):
    """The port's plan equals JAX's bit for bit."""
    assert got.per_channel == want.per_channel
    assert got.min_channels == want.min_channels
    assert sorted(got.blob_scale) == sorted(want.blob_scale)
    for bi, s in want.blob_scale.items():
        if np.ndim(s):
            np.testing.assert_array_equal(got.blob_scale[bi], s)
            assert got.blob_scale[bi].dtype == np.float32
        else:
            assert type(got.blob_scale[bi]) is float
            assert got.blob_scale[bi] == s
    assert sorted(got.weights) == sorted(want.weights)
    for li, q in want.weights.items():
        g = got.weights[li]
        assert g.get("xs") == q.get("xs")
        for k, dt in (("wq", np.int8), ("wscale", np.float32),
                      ("bias", np.float32)):
            v = g[k].numpy()
            assert v.dtype == dt
            np.testing.assert_array_equal(v, np.asarray(q[k]))


# ------------------------------------------------------------ plan policy
@pytest.mark.parametrize("cfg", CFGS + ["v8n"], ids=CFG_IDS + ["v8n"])
def test_int8_blobs_and_head_protect_equal_jax(cfg):
    if cfg == "v8n":
        ir, tir = _v8_ir()
    else:
        ir, tir = parse_cfg(cfg, 96, 96), tparse(cfg, 96, 96)
    assert tq._head_protect(tir) == jq._head_protect(ir)
    for minc in (8, 16, 32):
        assert tq._int8_blobs(tir, minc) == jq._int8_blobs(ir, minc)
    excl = set(jq._int8_blobs(ir, 32)[::3])
    assert tq._int8_blobs(tir, 32, excl) == jq._int8_blobs(ir, 32, excl)


@pytest.mark.parametrize("per_channel", [False, True],
                         ids=["per_tensor", "per_channel"])
def test_build_plan_bit_equal(xl96, per_channel):
    """One absmax (seeded, a few blobs zero) -> the same plan: wq, wscale,
    bias and the blob scales bit for bit, from the port's own params
    (OIHW tensors) and from the darknet params."""
    ir, tir, params = xl96
    rng = np.random.RandomState(5)
    if per_channel:
        absmax = {bi: rng.uniform(0, 8, b.c).astype(np.float32)
                  for bi, b in enumerate(ir.blobs) if b.c}
        absmax[40][:3] = 0.0
    else:
        absmax = rng.uniform(0.5, 12, len(ir.blobs)).astype(np.float32)
        absmax[40] = 0.0
    want = jq.build_plan(ir, jbuild.params_to_pytree(params), absmax)
    _assert_plans_equal(tq.build_plan(tir, tbuild.params_from_numpy(params),
                                      absmax), want)
    _assert_plans_equal(tq.build_plan(tir, params, absmax), want)


@pytest.mark.parametrize("kind", ["absmax", "percentile", "per_channel"])
def test_collect_blob_absmax_matches_jax(xl96, kind):
    """The calibration pass (float32, TF32 off) on two seeded frames:
    every blob's statistic within 1e-5 relative of JAX's (the same float32
    forward in another sum order; the percentile interpolates between the
    same two order statistics).  Per channel, a small channel's sum may
    cancel: its noise is relative to its terms, so 1e-5 of the blob's
    largest channel."""
    ir, tir, params = xl96
    imgs = np.random.RandomState(1).randint(0, 256, (2, 96, 96, 3),
                                            dtype=np.uint8)
    kw = {"absmax": {}, "percentile": {"percentile": 99.9},
          "per_channel": {"per_channel": True}}[kind]
    want = jq.collect_blob_absmax(ir, jbuild.params_to_pytree(params), imgs,
                                  MEAN, NORM, **kw)
    got = tq.collect_blob_absmax(tir, tbuild.params_from_numpy(params), imgs,
                                 MEAN, NORM, **kw)
    if kind == "per_channel":
        assert sorted(got) == sorted(want)
        pairs = [(got[b], want[b]) for b in want]
    else:
        assert got.dtype == np.float32 and got.shape == want.shape
        pairs = [(got, want)]
    for g, w in pairs:
        atol = 1e-5 * np.abs(w).max() if kind == "per_channel" else 0.0
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=atol)


def test_calibrate_and_exclusion_knobs(xl96, monkeypatch):
    """``calibrate`` end to end gives JAX's blob set and scales within the
    calibration's 1e-5, and the attribution knobs exclude what JAX's
    do."""
    ir, tir, params = xl96
    imgs = np.random.RandomState(2).randint(0, 256, (1, 96, 96, 3),
                                            dtype=np.uint8)
    monkeypatch.setenv("FFCNN_INT8_EXCLUDE_BLOBS", "40,41")
    monkeypatch.setenv("FFCNN_INT8_ONLY_BLOBS", "40,41,42,43,60,61,62")
    want = jq.calibrate(ir, jbuild.params_to_pytree(params), imgs)
    got = tq.calibrate(tir, tbuild.params_from_numpy(params), imgs)
    assert sorted(got.blob_scale) == sorted(want.blob_scale) == \
        [42, 43, 60, 61, 62]
    for bi, s in want.blob_scale.items():
        assert got.blob_scale[bi] == pytest.approx(s, rel=1e-5)
    assert sorted(got.weights) == sorted(want.weights)


@pytest.mark.parametrize("per_channel", [False, True],
                         ids=["per_tensor", "per_channel"])
def test_save_load_both_ways(xl96, tmp_path, per_channel):
    """A plan JAX's ``save_plan`` wrote loads into the port as the same
    plan, and the port's file loads into JAX as the same plan."""
    ir, tir, params = xl96
    rng = np.random.RandomState(3)
    absmax = ({bi: rng.uniform(0, 8, b.c).astype(np.float32)
               for bi, b in enumerate(ir.blobs) if b.c} if per_channel
              else rng.uniform(0.5, 12, len(ir.blobs)).astype(np.float32))
    plan = jq.build_plan(ir, jbuild.params_to_pytree(params), absmax)
    jq.save_plan(str(tmp_path / "jax.npz"), plan)
    got = tq.load_plan(str(tmp_path / "jax.npz"))
    _assert_plans_equal(got, plan)
    tq.save_plan(str(tmp_path / "port.npz"), got)
    back = jq.load_plan(str(tmp_path / "port.npz"))
    _assert_plans_equal(tq.plan_from_numpy(back), plan)
    _assert_plans_equal(tq.plan_from_numpy(plan), plan)


# ------------------------------------------------------------ the int8 conv
CONV_CASES = {
    # name: (n, h, w, c, f, fs, stride, pad, groups, act)
    "dense3x3_s1": (2, 9, 7, 16, 24, 3, 1, 1, 1, 2),
    "dense3x3_s2": (2, 10, 9, 20, 8, 3, 2, 1, 1, 6),
    "dense1x1": (2, 6, 6, 48, 16, 1, 1, 0, 1, 0),
    "depthwise": (2, 8, 8, 12, 12, 3, 1, 1, 12, 2),
    "depthwise_s2": (2, 9, 8, 8, 8, 3, 2, 1, 8, 1),
    "grouped": (2, 7, 7, 16, 8, 3, 1, 1, 4, 3),
    # K = 3 * 3 * 256 = 2,304: float32 accumulation would round past 2^24
    "dense3x3_k2304": (1, 5, 5, 256, 8, 3, 1, 1, 1, 0),
    # the dw path's 5x5 at an odd size, the gemm path's F 16 at an odd
    # pixel count
    "depthwise5x5_odd": (2, 9, 7, 16, 16, 5, 1, 2, 16, 2),
    "dense1x1_f16_odd": (1, 7, 5, 48, 16, 1, 1, 0, 1, 0),
}


def _conv_inputs(case, out):
    n, h, w, c, f, fs, stride, pad, groups, act = CONV_CASES[case]
    rng = np.random.RandomState(sum(map(ord, case)))
    xq = rng.randint(-127, 128, (n, h, w, c)).astype(np.int8)
    if case == "dense3x3_k2304":
        xq[:] = 127                                # saturate the sums
    wq = rng.randint(-127, 128, (fs, fs, c // groups, f)).astype(np.int8)
    if case == "dense3x3_k2304":
        wq[:] = 127
    ws = rng.uniform(1e-3, 2e-2, f).astype(np.float32)
    bias = rng.uniform(-1, 1, f).astype(np.float32)
    out_scale = {"float": None, "int8": 0.037,
                 "int8_perch": rng.uniform(0.01, 0.2, f).astype(np.float32)
                 }[out]
    if case == "dense3x3_k2304" and out != "float":
        out_scale = 0.37 * (1 if out == "int8" else
                            np.ones(f, np.float32))
    kw = dict(stride=stride, pad=pad, groups=groups, act=act)
    return xq, wq, 0.0413, ws, bias, out_scale, kw


@pytest.mark.parametrize("out", ["float", "int8", "int8_perch"])
@pytest.mark.parametrize("case", list(CONV_CASES))
def test_conv2d_int8_plain_matches_jax(case, out):
    """The int32 accumulators exactly (against XLA's int8 conv); float
    outputs bit for bit or one ulp of float32 (XLA may contract the
    epilogue's product and sum), four where the activation takes an exp
    (logistic, SiLU: two libraries' exp); int8 codes equal."""
    xq, wq, xs, ws, bias, out_scale, kw = _conv_inputs(case, out)
    acc = lax.conv_general_dilated(
        jnp.asarray(xq), jnp.asarray(wq), (kw["stride"],) * 2,
        ((kw["pad"],) * 2,) * 2, dimension_numbers=("NHWC", "HWIO", "NHWC"),
        feature_group_count=kw["groups"], preferred_element_type=jnp.int32)
    cp = tci.prepare(torch.from_numpy(wq), xs, ws, bias, out_scale=out_scale,
                     **kw)
    got_acc = tci.conv_int8(torch.from_numpy(xq), cp, raw=True)
    assert got_acc.dtype == torch.int32
    np.testing.assert_array_equal(got_acc.numpy(), np.asarray(acc))
    want = np.asarray(jconv.conv2d_int8(
        jnp.asarray(xq), jnp.asarray(wq), xs, jnp.asarray(ws),
        jnp.asarray(bias), out_scale=out_scale, float_dtype=jnp.float32,
        **kw))
    got = tconv.conv2d_int8(torch.from_numpy(xq), torch.from_numpy(wq), xs,
                            ws, bias, out_scale=out_scale,
                            float_dtype=torch.float32, **kw).numpy()
    plain = tconv.conv2d_int8_plain(torch.from_numpy(xq), wq, xs, ws, bias,
                                    out_scale=out_scale,
                                    float_dtype=torch.float32, **kw).numpy()
    np.testing.assert_array_equal(got, plain)
    assert got.dtype == want.dtype
    if out == "float":
        ulps = np.abs(got.view(np.int32).astype(np.int64)
                      - want.view(np.int32).astype(np.int64))
        assert ulps.max() <= (4 if kw["act"] in (3, 5, 6) else 1)
    else:
        np.testing.assert_array_equal(got, want)


def _near_ties(inv):
    """float32 values y whose y * inv lies within a few float32 ulps of a
    rounding tie k + 1/2, k in [-127, 126]."""
    y0 = (np.arange(-127, 127) + 0.5) / np.float64(inv)
    ys = [y0.astype(np.float32)]
    for steps in range(1, 4):
        for d in (np.inf, -np.inf):
            y = ys[0]
            for _ in range(steps):
                y = np.nextafter(y, np.float32(d))
            ys.append(y)
    return np.concatenate(ys)


def _codes(y, inv):
    return np.clip(np.round(y * np.float32(inv)), -127, 127).astype(np.int8)


def _pin(got, want, y, inv):
    """The codes agree, and a multiplier one float32 ulp away would not
    give them."""
    np.testing.assert_array_equal(got, want)
    for d in (np.inf, -np.inf):
        off = np.nextafter(np.float32(inv), np.float32(d))
        assert not np.array_equal(_codes(y, off), want)


@pytest.mark.parametrize("scale", [0.0371, 0.0587, 0.1173, 2.71])
def test_requantize_multipliers_pinned(scale):
    """Each requantize site takes JAX's own reciprocal of its scale:
    conv2d_int8 a float32 division of float32(1) by float32(scale)
    (``np.asarray(out_scale, np.float32)``), the fused kernels'
    ``_quantize(out, 1.0 / out_scale)`` and the graph's ``store`` a
    float64 reciprocal rounded to float32.  Held on values at rounding
    ties, where a multiplier one ulp away changes codes."""
    # conv2d_int8: a 1x1 conv of one pixel of code 1 into one filter a
    # value, w_scale = y, so that y = 1 * eff + 0 exactly
    inv32 = np.float32(1) / np.float32(scale)
    y = _near_ties(inv32)
    y = y[np.abs(y * inv32) < 127]
    xq = np.ones((1, 1, 1, 1), np.int8)
    wq = np.ones((1, 1, 1, len(y)), np.int8)
    kw = dict(stride=1, pad=0, groups=1, act=0, out_scale=scale)
    zeros = np.zeros(len(y), np.float32)
    want = np.asarray(jconv.conv2d_int8(
        jnp.asarray(xq), jnp.asarray(wq), 1.0, jnp.asarray(y),
        jnp.asarray(zeros), **kw)).reshape(-1)
    got = tconv.conv2d_int8(torch.from_numpy(xq), torch.from_numpy(wq), 1.0,
                            y, zeros, **kw).numpy().reshape(-1)
    _pin(got, want, y, inv32)
    # the fused kernels' and the graph's: float64 reciprocal, to float32
    inv64 = np.float32(1.0 / scale)
    y = _near_ties(inv64)
    y = y[np.abs(y * inv64) < 127]
    jwant = np.asarray(jbf._quantize(jnp.asarray(y), 1.0 / scale)
                       ).astype(np.int8)
    got = tbf._finish(torch.from_numpy(y), torch.float32, scale).numpy()
    _pin(got, jwant, y, inv64)
    store = np.asarray(jnp.clip(jnp.round(
        jnp.asarray(y).astype(jnp.float32) * (1.0 / scale)), -127,
        127).astype(jnp.int8))
    got = tq.quantize(torch.from_numpy(y), 1.0 / scale).numpy()
    _pin(got, store, y, inv64)
    # at 0.0371 and 0.0587 the two reciprocals are one ulp apart, so each
    # site's pin also tells the two arithmetics apart
    assert (inv32 != inv64) == (scale in (0.0371, 0.0587))


# ------------------------------------------- K1/K3/K4's int8 boundaries
def _cs(x):
    n, h, w, c = x.shape
    return jnp.transpose(jnp.asarray(x), (1, 3, 2, 0)).reshape(h, c, w * n)


def _nhwc(y, w, n):
    h, p, _ = y.shape
    return np.asarray(jnp.transpose(y.reshape(h, p, w, n), (3, 0, 2, 1)))


def _codes_close(got, want):
    """int8 codes: at least 99% equal and none more than one apart (a
    float32 value at a rounding tie in another sum order)."""
    d = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert d.max() <= 1 and (d == 0).mean() >= 0.99, (d.max(), d.mean())


@pytest.mark.parametrize("kind", ["K1", "K3", "K4"])
@pytest.mark.parametrize("bounds", ["in", "out", "both"])
def test_block_int8_boundaries_match_pallas(xl96, kind, bounds):
    """K1/K3/K4's plain versions with int8 in and/or out against
    ``_cs_block``/``_cs_down_block``/``_cs_cascade`` with ``in_scale``/
    ``out_scale`` in interpret mode, on xl's run 84-108 (K1, K4 with its
    first three blocks) and its stride-2 block 81 (the region plan's
    81-108, K3), at 96x96."""
    ir, tir, params = xl96
    jp = jbuild.params_to_pytree(params)
    tp = tbuild.params_from_numpy(params)
    if kind == "K3":
        jrun = jbf.plan_runs(ir, min_channels=8, allow_down=True)
        jblocks = [next(b for r in jrun for b in r.blocks if b.start == 81)]
    else:
        jblocks = list(next(r for r in jbf.plan_runs(ir)
                            if r.start == 84).blocks[:3 if kind == "K4"
                                                     else 1])
    tblocks = [tbf.FusedBlock(b.start, b.end, b.residual, b.res_act, b.down)
               for b in jblocks]
    b0 = ir.blobs[jblocks[0].start]
    n = 2
    rng = np.random.RandomState({"K1": 1, "K3": 3, "K4": 4}[kind])
    in_scale = 0.0413 if bounds in ("in", "both") else None
    out_scale = 0.0587 if bounds in ("out", "both") else None
    if in_scale is not None:
        x = rng.randint(-127, 128, (n, b0.h, b0.w, b0.c)).astype(np.int8)
        xj = jnp.asarray(x)
    else:
        x = rng.randn(n, b0.h, b0.w, b0.c).astype(np.float32)
        xj = jnp.asarray(x, jnp.bfloat16)
        x = np.array(xj.astype(jnp.float32))
    od = jnp.int8 if out_scale is not None else jnp.bfloat16
    acts = lambda b: tuple(ir.layers[b.start + i].activation
                           for i in range(3))
    pj = [jbf._block_params(jp, b) for b in jblocks]
    if kind == "K1":
        y = jbf._cs_block(_cs(xj), pj[0], acts(jblocks[0]),
                          jblocks[0].residual, jblocks[0].res_act, b0.w, n,
                          interpret=True, out_dtype=od, in_scale=in_scale,
                          out_scale=out_scale)
        wo = b0.w
    elif kind == "K3":
        y = jbf._cs_down_block(_cs(xj), pj[0], acts(jblocks[0]), b0.w, n,
                               interpret=True, out_dtype=od,
                               in_scale=in_scale, out_scale=out_scale)
        wo = b0.w // 2
    else:
        y = jbf._cs_cascade(_cs(xj), pj, [(acts(b), b.residual, b.res_act)
                                          for b in jblocks], b0.w, n,
                            interpret=True, out_dtype=od, in_scale=in_scale,
                            out_scale=out_scale)
        wo = b0.w
    want = _nhwc(y, wo, n)
    bps = [tbf.block_params(tir, tp, b) for b in tblocks]
    xt = torch.from_numpy(x) if in_scale is not None else \
        torch.from_numpy(x).to(torch.bfloat16)
    if kind == "K1":
        got = tbf.fused_block(xt, bps[0], torch.bfloat16, in_scale,
                              out_scale)
    elif kind == "K3":
        got = tbf.fused_down_block(xt, bps[0], torch.bfloat16, in_scale,
                                   out_scale)
    else:
        got = tbf.fused_cascade(xt, bps, torch.bfloat16, in_scale,
                                out_scale)
    if out_scale is not None:
        assert got.dtype == torch.int8
        _codes_close(got.numpy(), want.astype(np.int8))
    else:
        g, w = got.float().numpy(), np.asarray(want, np.float32)
        # bf16 out: one rounding of float32 sums in another order
        np.testing.assert_allclose(g, w, rtol=2 ** -7,
                                   atol=2 ** -7 * np.abs(w).max())


def test_run_blocks_int8_boundaries(xl96, xl96_plan):
    """``run_blocks`` with a plan stores each int8 boundary between its
    groups as codes at the plan's scale, as ``run_blocks_cs`` does, and a
    per-channel plan keeps them float: the launches' kinds recorded."""
    ir, tir, params = xl96
    _, plan = xl96_plan
    tp = tbuild.params_from_numpy(params)
    run = next(r for r in tbf.plan_runs(tir) if r.start == 84)
    bps = [tbf.block_params(tir, tp, b) for b in run.blocks]
    seen = []
    real = tbf.fused_block

    def spy(x, bp, od, in_scale=None, out_scale=None):
        seen.append((x.dtype, in_scale, out_scale))
        return real(x, bp, od, in_scale, out_scale)

    x = torch.randn((1, 3, 3, 96), generator=torch.Generator().manual_seed(0)
                    ).to(torch.bfloat16)
    try:
        tbf.fused_block = spy
        y = tbf.run_blocks(x, run, bps, quant=plan)
    finally:
        tbf.fused_block = real
    ends = [b.end + 1 for b in run.blocks]
    assert y.dtype == torch.bfloat16
    assert seen[0] == (torch.bfloat16, None, plan.scalar_scale(ends[0]))
    for i in range(1, len(seen)):
        want_out = (plan.scalar_scale(ends[i]) if i + 1 < len(seen)
                    else None)
        assert seen[i] == (torch.int8, plan.scalar_scale(ends[i - 1]),
                           want_out)


# ---------------------------------------------------------- whole forward
def _fold(ir, params):
    return jbuild.fold_input_transform(ir, jbuild.params_to_pytree(params),
                                       MEAN, NORM)


def test_forward_int8_fused_xl_matches_jax(xl96, xl96_plan):
    """xl at 96x96, default runs (JAX's in interpret mode), under one plan:
    every materialised int8 blob by its codes (>= 99% equal, none more
    than one apart), every float blob and the heads by fast mode's
    bounds."""
    ir, tir, params = xl96
    jplan, tplan = xl96_plan
    frames = np.random.RandomState(9).randint(0, 256, (1, 96, 96, 3),
                                              dtype=np.uint8)
    runs = jbf.plan_runs(ir)
    interior = {li for r in runs for li in range(r.start + 1, r.end + 1)}
    keep = [bi for bi in range(1, len(ir.blobs))
            if bi not in interior and ir.blobs[bi].c
            and ir.layers[bi - 1].type not in (LayerType.YOLO,)]
    jh, jb = jbuild.forward_features(
        ir, _fold(ir, params), jpre.letterbox_uint8(jnp.asarray(frames),
                                                    96, 96),
        input_dtype=jnp.bfloat16, quant=jplan, fused_runs=runs,
        fused_interpret=True, keep_blobs=keep)
    net = pt.Net(tir, params, mode="int8", device="cpu")
    net.set_quant_plan(tplan)
    assert [(r.start, r.end) for r in net._fused_runs] == \
        [(r.start, r.end) for r in runs]
    fp, _ = net._folded_params(pt.DEFAULT_MEAN, pt.DEFAULT_NORM)
    th, tb = tbuild.forward_features(
        tir, fp, torch.from_numpy(frames), input_dtype=torch.bfloat16,
        quant=net.quant, fused_runs=net._fused_runs,
        fused_params=net._fused_params, keep_blobs=keep)
    n_int8 = 0
    for bi in keep:
        g, w = tb[bi], np.asarray(jb[bi])
        if jplan.blob_is_int8(bi):
            assert g.dtype == torch.int8 and w.dtype == np.int8, bi
            _codes_close(g.numpy(), w)
            n_int8 += 1
        else:
            w = w.astype(np.float32)
            err = np.abs(g.float().numpy() - w)
            scale = max(np.abs(w).max(), 1e-6)
            assert err.max() <= 2 ** -3 * scale, bi
    assert n_int8 >= 40
    for g, w in zip(th, jh):
        w = np.asarray(w.astype(jnp.float32))
        err = np.abs(g.float().numpy() - w)
        assert err.max() <= 2 ** -3 * np.abs(w).max()
        assert err.mean() <= 2 ** -8 * np.abs(w).max()


def _micro(per_channel, exclude=None, minc=8):
    ir, tir, params = _model(MICRO, 64, seed=3, obj_bias=0.0)
    jp = jbuild.params_to_pytree(params)
    img = np.random.RandomState(7).randint(0, 256, (2, 64, 64, 3),
                                           np.uint8)
    absmax = jq.collect_blob_absmax(ir, jp, img, MEAN, NORM,
                                    per_channel=per_channel)
    plan = jq.build_plan(ir, jp, absmax, min_channels=minc,
                         exclude_blobs=exclude)
    return ir, tir, params, jp, plan


@pytest.mark.parametrize("case", ["per_tensor", "per_channel", "mixed_pool"])
def test_forward_int8_micro_matches_jax(case):
    """ffcnn-micro (dense and depthwise convs, SPP pools, route groups, a
    shortcut) in float32 under a per-tensor plan, a per-channel plan, and
    a plan whose maxpool output is excluded while its input is int8 (the
    mixed-storage pool of tests/test_int8.py): every blob by its codes or
    within float32 noise, the heads too."""
    exclude = None
    if case == "mixed_pool":
        ir0 = parse_cfg(MICRO, 64, 64)
        pool = next(li for li, l in enumerate(ir0.layers)
                    if l.type == LayerType.MAXPOOL and ir0.blobs[li].c >= 16)
        exclude = {pool + 1}
    ir, tir, params, jp, plan = _micro(case == "per_channel", exclude,
                                       16 if exclude else 8)
    if exclude:
        assert plan.blob_is_int8(pool) and not plan.blob_is_int8(pool + 1)
    x = np.random.RandomState(11).rand(2, 64, 64, 3).astype(np.float32)
    keep = [bi for bi in range(1, len(ir.blobs)) if ir.blobs[bi].c
            and ir.layers[bi - 1].type != LayerType.YOLO]
    jh, jb = jbuild.forward_features(ir, jp, jnp.asarray(x), quant=plan,
                                     keep_blobs=keep)
    th, tb = tbuild.forward_features(
        tir, tbuild.params_from_numpy(params), torch.from_numpy(x),
        quant=tq.plan_from_numpy(plan), keep_blobs=keep)
    for bi in keep:
        g, w = tb[bi], np.asarray(jb[bi])
        if plan.blob_is_int8(bi):
            _codes_close(g.numpy(), w)
        else:
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-4,
                                       atol=1e-4 * max(np.abs(w).max(), 1))
    for g, w in zip(th, jh):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4,
                                   atol=1e-4 * np.abs(w).max())


# ------------------------------------------------------------------- Net
def _match_fraction(dets, cands):
    """Fast mode's detection bound (chip_smoke.py phase 4): the share of
    ``dets`` with a same-class candidate (decoded, before NMS) within 4 px
    and 0.02 in score."""
    boxes, scores, classes = (t.float().numpy() if t.is_floating_point()
                              else t.numpy() for t in cands)
    live = scores > 0
    boxes, scores, classes = boxes[live], scores[live], classes[live]
    if not dets:
        return 1.0
    return sum(bool(np.any((classes == d.class_id)
                           & (np.abs(boxes - np.asarray(d[2:])).max(1) <= 4)
                           & (np.abs(scores - d.score) <= 0.02)))
               for d in dets) / len(dets)


def test_net_int8_detect_matches_jax(xl96, monkeypatch):
    """Net(mode="int8") on the CPU against JAX's (no fused runs in either,
    FFCNN_FUSED=0): a first detect self-calibrates on the first 8 frames
    to JAX's plan (scales within 1e-5), the detections under one plan
    (``set_quant_plan``) by fast mode's bounds; ``warmup`` refuses without
    a plan; the mega flag and the head chains plan nothing."""
    monkeypatch.setenv("FFCNN_FUSED", "0")
    ir, tir, params = xl96
    frames = np.random.RandomState(4).randint(0, 256, (10, 96, 96, 3),
                                              dtype=np.uint8)
    jnet = jt.Net(ir, params, mode="int8")
    net = pt.Net(tir, params, mode="int8", device="cpu")
    with pytest.raises(RuntimeError, match="calibrate"):
        net.warmup()
    assert net.quant is None
    want = jnet.detect(frames)
    got = net.detect(frames)
    assert sorted(net.quant.blob_scale) == sorted(jnet.quant.blob_scale)
    for bi, s in jnet.quant.blob_scale.items():
        assert net.quant.blob_scale[bi] == pytest.approx(s, rel=1e-5)
    net.set_quant_plan(tq.plan_from_numpy(jnet.quant))
    got = net.detect(frames)
    assert sum(map(len, want)) > 0
    # each side's detections among the other side's candidates
    from ffcnn_tpu.ops.yolo import concat_heads, decode_head
    from ffcnn_tpu_torch.ops.yolo import decode_heads as tdecode
    jh = jbuild.forward_features(
        ir, _fold(ir, params), jpre.letterbox_uint8(jnp.asarray(frames), 96,
                                                    96),
        input_dtype=jnp.bfloat16, quant=jnet.quant)
    jc = concat_heads([decode_head(f, l, 96, 96) for f, l in zip(
        jh, [l for l in ir.layers if l.type == LayerType.YOLO])])
    jc = [torch.from_numpy(np.array(jnp.asarray(t, jnp.float32)
                                      if t.dtype == jnp.bfloat16 else t))
          for t in (jc.boxes, jc.scores, jc.classes)]
    tc = tdecode(tir, net.forward_heads(torch.from_numpy(frames)), 96, 96)
    for i in range(len(frames)):
        assert _match_fraction(got[i], [t[i] for t in jc]) >= 0.9
        assert _match_fraction(want[i], [t[i] for t in (
            tc.boxes, tc.scores, tc.classes)]) >= 0.9
    net.warmup()                      # with a plan: builds the bucket
    monkeypatch.setenv("FFCNN_FUSED", "1")
    monkeypatch.setenv("FFCNN_FUSED_MEGA", "1")
    monkeypatch.setenv("FFCNN_FUSED_HEADS", "1")
    n8 = pt.Net(tir, params, mode="int8", device="cpu")
    assert n8._fused_runs and not n8._mega_runs and not n8._head_runs
    fast = pt.Net(tir, params, mode="fast", device="cpu")
    assert fast._mega_runs and fast._head_runs


def test_net_int8_calibration_knobs(xl96, monkeypatch):
    """FFCNN_INT8_MINC, FFCNN_INT8_PERCH and FFCNN_INT8_PCT reach the plan
    as in JAX's Net; an explicit percentile with PERCH raises; calibrate
    refuses outside int8 mode."""
    ir, tir, params = xl96
    frames = np.random.RandomState(6).randint(0, 256, (2, 96, 96, 3),
                                              dtype=np.uint8)
    net = pt.Net(tir, params, mode="int8", device="cpu")
    monkeypatch.setenv("FFCNN_INT8_MINC", "48")
    net.calibrate(frames)
    assert net.quant.min_channels == 48
    assert all(ir.blobs[b].c >= 48 for b in net.quant.blob_scale)
    monkeypatch.delenv("FFCNN_INT8_MINC")
    monkeypatch.setenv("FFCNN_INT8_PCT", "99.0")
    base = jq.calibrate(ir, jbuild.params_to_pytree(params), frames,
                        percentile=99.0)
    net.calibrate(frames)
    for bi, s in base.blob_scale.items():
        assert net.quant.blob_scale[bi] == pytest.approx(s, rel=1e-5)
    monkeypatch.setenv("FFCNN_INT8_PERCH", "1")
    net.calibrate(frames)
    assert net.quant.per_channel
    with pytest.raises(ValueError, match="per-tensor"):
        net.calibrate(frames, percentile=99.0)
    with pytest.raises(ValueError, match="int8"):
        pt.Net(tir, params, mode="fast", device="cpu").calibrate(frames)


def test_roofline_int8_plan_matches_jax(xl96_plan):
    """``layer_costs(quant=)`` on xl at 96x96 with the default runs: JAX's
    bytes (int8 blobs and weights at one byte) plus the blobs JAX's XLA
    model fuses away, and JAX's operations, the int8 convs' moved to the
    int8 fields; ``Net.roofline_costs`` passes the plan."""
    from test_torch_roofline import _xla_fused_away
    jplan, tplan = xl96_plan
    ir, tir = parse_cfg(XL, 96, 96), tparse(XL, 96, 96)
    runs = tbf.plan_runs(tir)
    want = jroof.layer_costs(ir, 4, "bf16", fused_runs=runs, quant=jplan)
    got = troof.layer_costs(tir, 4, "bf16", fused_runs=runs, quant=tplan)
    interior = {li for r in runs for li in range(r.start, r.end + 1)}
    n_int8 = 0
    extra = {}
    for b in _xla_fused_away(tir, runs):
        blob = tir.blobs[b]
        n = troof.stored_bytes(blob.w, blob.h, blob.c, 4,
                               "int8" if tplan.blob_is_int8(b) else "bf16")
        extra[b - 1] = extra.get(b - 1, 0) + n
        extra[b] = extra.get(b, 0) + n
    for g, w in zip(got, want):
        assert g.bytes_w == w.bytes_w
        assert g.bytes_act == w.bytes_act + extra.get(g.index, 0), g.index
        assert g.flops + g.int8_ops == w.flops
        assert g.vpu_flops + g.int8_vpu_ops == w.vpu_flops
        if g.index in tplan.weights and g.index not in interior:
            assert g.flops == g.vpu_flops == 0
            assert g.int8_ops + g.int8_vpu_ops > 0
            n_int8 += 1
    assert n_int8 == 29
    dw = next(c for c in got if c.int8_vpu_ops)
    assert dw.floor_us() >= dw.int8_vpu_ops / troof.INT32_OP_S * 1e6
    assert troof.INT32_OP_S == 132 * 64 * 2 * 1.98e9
    net = pt.Net(tir, pt.darknet.weights.zero_weights(tir), mode="int8",
                 device="cpu")
    net.set_quant_plan(tplan)
    assert net.roofline_costs(4) == troof.layer_costs(
        tir, 4, "bf16", fused_runs=net._fused_runs, quant=net.quant)


def test_serve_int8_plan_saved_and_reloaded(tmp_path):
    """``serve --mode int8``: with ``--calib`` and a new ``--quant-plan``
    it calibrates and saves the plan, then loads it back (the same plan);
    with neither it is refused; the service answers under the plan."""
    from ffcnn_tpu_torch import serve
    from ffcnn_tpu_torch.imageio.bmp import bmp_save
    wpath, bmp = str(tmp_path / "micro.weights"), str(tmp_path / "f.bmp")
    with open(wpath, "wb") as f:
        f.write(synth_weights_bytes(parse_cfg(MICRO), seed=7, obj_bias=2.0))
    img = np.random.RandomState(1).randint(0, 256, (64, 64, 3), np.uint8)
    bmp_save(bmp, img)
    plan = str(tmp_path / "plan.npz")
    ap = serve.parser()
    base = ["--cfg", MICRO, "--weights", wpath, "--mode", "int8",
            "--device", "cpu"]
    with pytest.raises(SystemExit):
        serve.load_net(ap.parse_args(base), ap.error)
    args = ap.parse_args(base + ["--calib", bmp, "--quant-plan", plan])
    net = serve.load_net(args, ap.error)
    assert os.path.exists(plan) and net.quant is not None
    again = serve.load_net(ap.parse_args(base + ["--quant-plan", plan]),
                           ap.error)
    assert again.quant.blob_scale == net.quant.blob_scale
    for li, q in net.quant.weights.items():
        assert torch.equal(again.quant.weights[li]["wq"], q["wq"])
    svc = serve.DetectorService(again, max_batch=2)
    try:
        svc.warmup()
        assert svc.ready
        with open(bmp, "rb") as f:
            got = svc.detect_bmp_bytes(f.read())
    finally:
        svc._batcher.close()
    want = again.detect(img)
    assert [d["box"] for d in got] == \
        [[round(v, 2) for v in (d.x1, d.y1, d.x2, d.y2)] for d in want]


def test_conv0_int8_flag_refused_in_int8_mode(xl96, xl96_plan, monkeypatch):
    """``FFCNN_CONV0_INT8=1`` (conv-1 off the uint8 pixels in int8, an XLA
    conv in the JAX package), which an int8 Net refused before the int8
    conv had its uint8 mode, runs in int8 mode too: xl at 96x96 under one
    plan, conv-1 through the uint8 mode (its output requantized where the
    plan makes blob 1 int8) and the default runs, against JAX's forward
    with ``conv0_int8`` and its runs in interpret mode: the heads by fast
    mode's bounds."""
    ir, tir, params = xl96
    jplan, tplan = xl96_plan
    frames = np.random.RandomState(12).randint(0, 256, (1, 96, 96, 3),
                                               dtype=np.uint8)
    monkeypatch.setenv("FFCNN_CONV0_INT8", "1")
    net = pt.Net(tir, params, mode="int8", device="cpu")
    net.set_quant_plan(tplan)
    seen, conv = [], tbuild.conv_int8
    monkeypatch.setattr(tbuild, "conv_int8", lambda x, *a: seen.append(
        x.dtype) or conv(x, *a))
    got = net.forward_heads(torch.from_numpy(frames))
    assert seen[0] == torch.uint8 and seen.count(torch.uint8) == 1
    want = jbuild.forward_features(
        ir, _fold(ir, params), jpre.letterbox_uint8(jnp.asarray(frames),
                                                    96, 96),
        input_dtype=jnp.bfloat16, quant=jplan, fused_runs=jbf.plan_runs(ir),
        fused_interpret=True, conv0_int8=True)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = g.float().numpy(), np.asarray(w).astype(np.float32)
        scale = np.abs(w).max()
        err = np.abs(g - w)
        assert err.max() <= 2 ** -3 * scale, err.max() / scale
        assert err.mean() <= 2 ** -8 * scale, err.mean() / scale


# ------------------------------------------- the int8 conv's paths and plans
CU = os.path.join(REPO, "ffcnn_tpu_torch", "csrc", "conv_int8.cu")


@pytest.mark.parametrize("case", list(CONV_CASES))
def test_pack_weights_unpacks_to_wq(case):
    """Each packing (dense (F, Kp) with zero padding; depthwise (k, k, F);
    grouped (F, k, k, C/groups)) gives back ``wq``."""
    _, _, _, c, f, fs, _, _, groups, _ = CONV_CASES[case]
    wq = torch.from_numpy(np.random.RandomState(3).randint(
        -127, 128, (fs, fs, c // groups, f)).astype(np.int8))
    wp, kp = tci.pack_weights(wq, groups)
    if groups == 1:
        k = fs * fs * c
        assert kp % 32 == 0 and kp - k < 32 and not wp[:, k:].any()
        back = wp[:, :k].reshape(f, fs, fs, c).permute(1, 2, 3, 0)
    elif c == groups == f and f % 4 == 0:
        assert kp == 0 and tuple(wp.shape) == (fs, fs, f)
        back = wp.reshape(fs, fs, 1, f)
    else:
        back = wp.permute(1, 2, 3, 0)
    assert torch.equal(back, wq)


def test_plan_mirror_pinned_to_the_source():
    """The wrapper's ``ROUTES`` are the source's ``Route`` in order, and
    ``route``'s depthwise slice of 16 channels is the source's
    ``kDwSlice``."""
    import re
    src = open(CU).read()
    enum = re.search(r"enum Route \{([^}]*)\}", src).group(1)
    names = [e.split("=")[0].strip() for e in enum.split(",")]
    assert names == ["k" + r.capitalize() for r in tci.ROUTES]
    assert tci.ROUTES == ("dense", "gemm", "dw", "dw4", "grouped", "u8")
    assert re.search(r"constexpr int kDwSlice = 16;", src)


@pytest.mark.parametrize("args,kw,want", [
    ((48, 16, 1, 1, 1), {}, "gemm"),
    ((16, 272, 3, 2, 1), {}, "gemm"),
    ((48, 16, 1, 1, 1), {"x_u8": True}, "u8"),
    ((40, 16, 1, 1, 1), {}, "dense"),
    ((48, 16, 1, 1, 1), {"aligned": False}, "dense"),
    ((48, 48, 3, 2, 48), {}, "dw"),
    ((240, 240, 5, 1, 240), {}, "dw"),
    ((40, 40, 3, 1, 40), {}, "dw4"),
    ((32, 32, 7, 1, 32), {}, "dw4"),
    ((32, 32, 3, 3, 32), {}, "dw4"),
    ((32, 32, 3, 1, 32), {"aligned": False}, "dw4"),
    ((16, 8, 3, 1, 4), {}, "grouped"),
    ((6, 6, 3, 1, 6), {}, "grouped")])
def test_routes_by_shape(args, kw, want):
    """The routing (c, f, k, stride, groups): dense int8 codes with C a
    multiple of 16 take gemm, other C the first dense kernel, the uint8
    mode its u8 path; depthwise 3x3 and 5x5 at stride 1 and 2 with C a multiple of
    16 take dw, other depthwise convs with C a multiple of 4 dw4; the rest
    grouped; an unaligned tensor leaves the 16-byte paths."""
    assert tci.route(*args, **kw) == want


@pytest.fixture(scope="module")
def int8_shapes():
    """xl's unfused int8 convs and v8n's distinct ones
    (``quant.conv_shapes``), from int8 Nets calibrated on the CPU at 96x96
    and 64x64 (which convs run unfused, and their routes, do not depend on
    the size)."""
    from ffcnn_tpu_torch.darknet.weights import load_weights as tload
    rng = np.random.RandomState(0)
    wbytes = pt.synth_weights_bytes(pt.parse_cfg(XL), seed=42, obj_bias=2.0)
    xl = pt.load(XL, wbytes, input_w=96, input_h=96, mode="int8",
                 device="cpu")
    xl.calibrate(rng.randint(0, 256, (2, 96, 96, 3), np.uint8))
    cfg, w = ty.convert(ty.synthesize_state_dict(80, "n", seed=0), 80, "n",
                        size=64, conf=0.05)
    ir = tparse(cfg, is_path=False)
    v8 = pt.Net(ir, tload(ir, w)[0], mode="int8", device="cpu")
    v8.calibrate(rng.randint(0, 256, (1, 64, 64, 3), np.uint8))
    return {"xl": tq.conv_shapes(xl), "v8n": tq.conv_shapes(v8, True)}


def test_every_xl_and_v8n_shape_gets_a_plan(int8_shapes):
    """xl's 29 unfused int8 convs are 13 depthwise convs at stride 1 and 2,
    all on the dw path, and 16 1x1 convs on the gemm path; v8n's 34
    distinct dense convs all take gemm.  Each path's tile and shared memory
    are the kernel's own: the card checks that every one of these shapes
    fits (``chip_smoke.py`` phase 12 launches each; the kernel refuses a
    CTA past 227 KB)."""
    xl, v8 = int8_shapes["xl"], int8_shapes["v8n"]
    assert len(xl) == 29 and len(v8) == 34
    routes = [tci.route(geo[2], geo[3], geo[4], geo[5], geo[7])
              for _, geo in xl]
    assert routes.count("dw") == 13 and routes.count("gemm") == 16
    assert {geo[5] for (_, geo), r in zip(xl, routes) if r == "dw"} == {1, 2}
    assert {tci.route(geo[2], geo[3], geo[4], geo[5], geo[7])
            for _, geo in v8} == {"gemm"}
