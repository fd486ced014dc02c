"""The port's region configuration (ffcnn_tpu_torch with FFCNN_FUSED_DOWN=1,
FFCNN_FUSED_MINC=8, FFCNN_CONV0_PALLAS=1 and FFCNN_FUSED_HEADS=1) against
the JAX package's on the CPU: the planners must plan the same runs, and the
plain versions of the stride-2 block (K3), the uint8 stem (K6) and the head
chain (K7) must compute what the Pallas kernels compute in interpret mode,
alone and in the whole forward."""

import glob
import os
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import ffcnn_tpu_torch as pt
from ffcnn_tpu.darknet import parse_cfg
from ffcnn_tpu.darknet.weights import load_weights, synth_weights_bytes
from ffcnn_tpu.graph import build as jbuild
from ffcnn_tpu.kernels import block_fused as jbf
from ffcnn_tpu.kernels import conv0_fused as jc0
from ffcnn_tpu.kernels import head_fused as jhf
from ffcnn_tpu.ops import preprocess as jpre
from ffcnn_tpu_torch.darknet import parse_cfg as tparse_cfg
from ffcnn_tpu_torch.graph import build as tbuild
from ffcnn_tpu_torch.kernels import block_fused as tbf
from ffcnn_tpu_torch.kernels import conv0_fused as tc0
from ffcnn_tpu_torch.kernels import head_fused as thf
from ffcnn_tpu_torch.testing import cap_threads

cap_threads()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFGS = sorted(glob.glob(os.path.join(REPO, "models", "*.cfg")))
CFG_IDS = [os.path.splitext(os.path.basename(p))[0] for p in CFGS]
XL = os.path.join(REPO, "models", "yolo-fastest-xl.cfg")
REGION_FLAGS = {"FFCNN_FUSED_DOWN": "1", "FFCNN_FUSED_MINC": "8",
                "FFCNN_CONV0_PALLAS": "1", "FFCNN_FUSED_HEADS": "1"}


def _plan(runs):
    return [(r.start, r.end, [(b.start, b.end, b.residual, b.res_act, b.down)
                              for b in r.blocks]) for r in runs]


def _model(size, seed=42):
    """JAX's IR, the port's IR (each package's own parser) and the folded
    params of xl at ``size``."""
    ir = parse_cfg(XL, size, size)
    params, _ = load_weights(ir, synth_weights_bytes(ir, seed=seed,
                                                     obj_bias=2.0))
    return ir, tparse_cfg(XL, size, size), params


@pytest.fixture(scope="module")
def xl96():
    return _model(96)


# ------------------------------------------------------------------ planners
@pytest.mark.parametrize("min_channels", [1, 8, 16, 24])
@pytest.mark.parametrize("allow_down", [False, True])
@pytest.mark.parametrize("cfg_path", CFGS, ids=CFG_IDS)
def test_plan_runs_equal_jax(cfg_path, min_channels, allow_down):
    ir, tir = parse_cfg(cfg_path), tparse_cfg(cfg_path)
    assert _plan(tbf.plan_runs(tir, min_channels, allow_down)) == \
        _plan(jbf.plan_runs(ir, min_channels, allow_down))


@pytest.mark.parametrize("cfg_path", CFGS, ids=CFG_IDS)
def test_plan_runs_read_the_flags_as_jax(cfg_path, monkeypatch):
    """With FFCNN_FUSED_DOWN and FFCNN_FUSED_MINC set, both packages plan
    the same region runs from the environment."""
    monkeypatch.setenv("FFCNN_FUSED_DOWN", "1")
    monkeypatch.setenv("FFCNN_FUSED_MINC", "8")
    ir, tir = parse_cfg(cfg_path), tparse_cfg(cfg_path)
    assert _plan(tbf.plan_runs(tir)) == _plan(jbf.plan_runs(ir))
    # explicit arguments win over the environment, in both
    assert _plan(tbf.plan_runs(tir, 24, False)) == \
        _plan(jbf.plan_runs(ir, 24, False))


def test_xl_region_plan_at_320(monkeypatch):
    """The region plan of yolo-fastest-xl: two runs, 20 stride-1 and 4
    stride-2 blocks, and one head chain (the 20x20 chain fails the TPU's
    VMEM test)."""
    for k, v in REGION_FLAGS.items():
        monkeypatch.setenv(k, v)
    ir = tparse_cfg(XL, 320, 320)
    runs = tbf.plan_runs(ir)
    assert [(r.start, r.end, len(r.blocks)) for r in runs] == \
        [(1, 80, 18), (81, 108, 6)]
    downs = [b.start for r in runs for b in r.blocks if b.down]
    assert downs == [9, 22, 58, 81]
    assert sum(not b.down for r in runs for b in r.blocks) == 20
    assert [(r.start, r.end) for r in thf.plan_head_runs(ir)] == [(116, 120)]


@pytest.mark.parametrize("size", [96, 320, 416])
@pytest.mark.parametrize("cfg_path", CFGS, ids=CFG_IDS)
def test_plan_head_runs_equal_jax(cfg_path, size):
    ir, tir = parse_cfg(cfg_path, size, size), tparse_cfg(cfg_path, size,
                                                          size)
    assert [(r.start, r.end) for r in thf.plan_head_runs(tir)] == \
        [(r.start, r.end) for r in jhf.plan_head_runs(ir)]


def test_net_plans_by_the_flags(monkeypatch):
    """No flag: the default plan (13 stride-1 blocks, no head chain, no
    stem kernel).  The four flags: the region plan, resolved once at
    construction."""
    _, ir, params = _model(320)
    net = pt.Net(ir, params, mode="fast", device="cpu")
    assert [(r.start, r.end) for r in net._fused_runs] == \
        [(38, 57), (61, 80), (84, 108)]
    assert net._head_runs == [] and not net._conv0_pallas
    for k, v in REGION_FLAGS.items():
        monkeypatch.setenv(k, v)
    net = pt.Net(ir, params, mode="fast", device="cpu")
    for k in REGION_FLAGS:
        monkeypatch.delenv(k)
    assert [(r.start, r.end) for r in net._fused_runs] == [(1, 80),
                                                           (81, 108)]
    assert [(r.start, r.end) for r in net._head_runs] == [(116, 120)]
    assert net._folded_params(pt.DEFAULT_MEAN, pt.DEFAULT_NORM)[1] \
        is not None
    assert pt.Net(ir, params, mode="parity",
                  device="cpu")._fused_runs == []


# ----------------------------------------------- plain versions against JAX
@pytest.mark.parametrize("start,dtype", [(9, "float32"), (22, "float32"),
                                         (58, "float32"), (81, "float32"),
                                         (58, "bfloat16")])
def test_block_down_plain_matches_jax_interpret(xl96, start, dtype):
    """K3's plain version against ``_make_down_kernel`` (interpret mode) at
    xl's four stride-2 blocks."""
    ir, tir, params = xl96
    b = jbf.find_fused_blocks(ir)[start]
    assert b.down
    bi = ir.blobs[b.start]
    x = np.random.RandomState(start).randn(2, bi.h, bi.w, bi.c) \
        .astype(np.float32)
    want = jbf.apply_run(jnp.asarray(x, dtype), ir,
                         jbuild.params_to_pytree(params),
                         jbf.FusedRun(b.start, b.end, (b,)), interpret=True)
    bp = tbf.block_params(tir, tbuild.params_from_numpy(params),
                          tbf.find_fused_blocks(tir)[start])
    got = tbf.block_down_plain(torch.from_numpy(x).to(getattr(torch, dtype)),
                               bp)
    assert got.dtype == getattr(torch, dtype)
    got = got.float().numpy()
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert got.shape == want.shape == (2, bi.h // 2, bi.w // 2,
                                       ir.blobs[b.end + 1].c)
    scale = np.abs(want).max()
    if dtype == "float32":
        # float32 sums of <= 272 terms in another order
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5 * scale)
    else:
        # one bf16 rounding of the output: a value an f32 ulp from a
        # rounding edge lands one bf16 ulp (2^-8 relative) away
        assert np.abs(got - want).max() <= 2 ** -7 * scale


def test_block_down_plain_matches_unfused_convs(xl96):
    """The stride-2 plain block equals the graph's three convs."""
    from ffcnn_tpu_torch.ops.conv import conv2d_fused
    _, ir, params = xl96
    tp = tbuild.params_from_numpy(params)
    blk = tbf.find_fused_blocks(ir)[22]
    b = ir.blobs[blk.start]
    x = torch.from_numpy(np.random.RandomState(5).randn(
        2, b.h, b.w, b.c).astype(np.float32))
    y = x
    for li in range(blk.start, blk.end + 1):
        l, p = ir.layers[li], tp[li]
        y = conv2d_fused(y, p["weights"], p["scale"], p["bias"],
                         stride=l.stride, pad=l.pad, groups=l.groups,
                         act=l.activation)
    got = tbf.block_down_plain(x, tbf.block_params(ir, tp, blk))
    np.testing.assert_allclose(got.numpy(), y.numpy(), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
def test_conv0_plain_matches_jax_interpret(out_dtype):
    """K6's plain version against ``conv0_cs`` (interpret mode) on the
    folded xl stem, its (H/2, F, W/2*N) output transposed back to NHWC."""
    ir, tir, params = _model(64)
    jp = jbuild.fold_input_transform(ir, jbuild.params_to_pytree(params),
                                     pt.DEFAULT_MEAN, pt.DEFAULT_NORM)
    x = np.random.RandomState(7).randint(0, 256, (2, 64, 64, 3),
                                         dtype=np.uint8)
    p = jp[0]
    cs = jc0.conv0_cs(jnp.asarray(x), p["weights"], p["scale"], p["bias"],
                      ir.layers[0].activation,
                      out_dtype=getattr(jnp, out_dtype), interpret=True)
    f = ir.blobs[1].c
    want = np.asarray(jnp.asarray(jnp.transpose(
        cs.reshape(32, f, 32, 2), (3, 0, 2, 1)), jnp.float32))
    tp = tbuild.fold_input_transform(tir, tbuild.params_from_numpy(params),
                                     pt.DEFAULT_MEAN, pt.DEFAULT_NORM)
    cp = tc0.conv0_params(tir, tp)
    got = tc0.conv0_cs(torch.from_numpy(x), cp, getattr(torch, out_dtype))
    assert got.dtype == getattr(torch, out_dtype)
    got = got.float().numpy()
    assert got.shape == want.shape == (2, 32, 32, f)
    scale = np.abs(want).max()
    if out_dtype == "float32":
        # 27-term float32 sums in another order, on pixel values <= 255
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6 * scale)
    else:
        assert np.abs(got - want).max() <= 2 ** -7 * scale


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_head_plain_matches_jax_interpret(xl96, dtype):
    """K7's plain version against ``apply_head_run`` (interpret mode) on
    every head chain of xl at 96x96."""
    ir, tir, params = xl96
    jp = jbuild.params_to_pytree(params)
    tp = tbuild.params_from_numpy(params)
    jruns = jhf.plan_head_runs(ir)
    truns = thf.plan_head_runs(tir)
    assert len(truns) == 2
    for jr, tr in zip(jruns, truns):
        b = ir.blobs[tr.start]
        x = (np.random.RandomState(tr.start).randn(2, b.h, b.w, b.c)
             .astype(np.float32))
        want = jhf.apply_head_run(jnp.asarray(x, dtype), ir, jp, jr,
                                  interpret=True)
        got = thf.apply_head_run(torch.from_numpy(x).to(getattr(torch,
                                                                dtype)),
                                 tr, thf.head_params(tir, tp, tr))
        assert got.dtype == getattr(torch, dtype)
        got = got.float().numpy()
        want = np.asarray(jnp.asarray(want, jnp.float32))
        assert got.shape == want.shape == (2, b.h, b.w, 255)
        scale = np.abs(want).max()
        if dtype == "float32":
            # float32 sums of <= 192 terms in another order, 5 stages
            np.testing.assert_allclose(got, want, rtol=1e-4,
                                       atol=1e-5 * scale)
        else:
            # float32 inside, one bf16 rounding at the end
            assert np.abs(got - want).max() <= 2 ** -7 * scale


def test_head_params_fit_check():
    """The 10x10 chain of xl at 320 fits a CTA's shared memory at either
    cluster size; at 416 (13x13) it fits with a cluster of two CTAs an
    image (7 rows a CTA) but not with one, where its stage buffers go to
    device memory (two 13x13 maps of 196-float rows an image) and
    ``check_fits`` accepts the chain all the same.  Two float32 buffers
    of the CTA's rows (row stride 192 + 4) and two weight chunks of 32
    rows by 255 outputs (row stride 264)."""
    for size, fits_alone in ((320, True), (416, False)):
        _, ir, params = _model(size)
        run = thf.plan_head_runs(ir)[0]
        hp = thf.head_params(ir, tbuild.params_from_numpy(params), run)
        for n, cluster in ((64, 2), (67, 1)):
            p = thf.plan(hp, n, 132)
            assert (p.cluster, p.rows) == (cluster, -(-hp.h // cluster))
            need = 4 * (2 * p.rows * hp.w * 196 + 2 * 32 * 264)
            if cluster == 2 or fits_alone:
                assert (p.smem, p.scratch) == (need, 0)
                assert need <= thf.MAX_SMEM
            else:
                assert need > thf.MAX_SMEM
                assert (p.smem, p.scratch) == (4 * 2 * 32 * 264,
                                               2 * 13 * 13 * 196)
        thf.check_fits(hp)


# ------------------------------------------------------- the whole forward
def test_region_forward_matches_jax_f32():
    """The whole region forward in float32 (stem off uint8, both region
    runs with their stride-2 blocks, the head chains) against JAX's with
    its Pallas kernels in interpret mode.  At 32x32 (maps 16x16 down to
    1x1), so that the Pallas interpreter stays under 20 s."""
    ir, tir, params = _model(32)
    x = np.random.RandomState(8).randint(0, 256, (2, 32, 32, 3),
                                         dtype=np.uint8)
    runs = tbf.plan_runs(tir, 8, True)
    hruns = thf.plan_head_runs(tir)
    tp = tbuild.params_from_numpy(params)
    got = tbuild.forward_features(
        tir, tp, torch.from_numpy(x), input_dtype=torch.float32,
        fused_runs=runs,
        fused_params={r.start: [tbf.block_params(tir, tp, b)
                                for b in r.blocks] for r in runs},
        head_runs=hruns,
        head_params={r.start: thf.head_params(tir, tp, r) for r in hruns},
        conv0_pallas=True, conv0_params=tc0.conv0_params(tir, tp))
    want = jax.jit(lambda v: jbuild.forward_features(
        ir, jbuild.params_to_pytree(params), v, input_dtype=jnp.float32,
        fused_runs=jbf.plan_runs(ir, 8, True),
        head_runs=jhf.plan_head_runs(ir), conv0_pallas=True,
        fused_interpret=True))(jnp.asarray(x))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        w = np.asarray(w)
        # float32 sums in another order, compounded over the depth
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4,
                                   atol=1e-4 * np.abs(w).max())


def test_region_forward_matches_jax_bf16(monkeypatch):
    """Fast mode with the four flags (Net.forward_heads: folded stem off
    uint8, bf16 blobs, region runs, head chains) against JAX's forward with
    its Pallas kernels in interpret mode, at 32x32 as above."""
    ir, tir, params = _model(32)
    frames = np.random.RandomState(9).randint(0, 256, (2, 32, 32, 3),
                                              dtype=np.uint8)
    for k, v in REGION_FLAGS.items():
        monkeypatch.setenv(k, v)
    net = pt.Net(tir, params, mode="fast", device="cpu")
    for k in REGION_FLAGS:
        monkeypatch.delenv(k)
    got = net.forward_heads(torch.from_numpy(frames))
    jp = jbuild.fold_input_transform(ir, jbuild.params_to_pytree(params),
                                     pt.DEFAULT_MEAN, pt.DEFAULT_NORM)
    want = jax.jit(lambda v: jbuild.forward_features(
        ir, jp, jpre.letterbox_uint8(v, 32, 32), input_dtype=jnp.bfloat16,
        fused_runs=jbf.plan_runs(ir, 8, True),
        head_runs=jhf.plan_head_runs(ir), conv0_pallas=True,
        fused_interpret=True))(jnp.asarray(frames))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        g, w = g.float().numpy(), np.asarray(jnp.asarray(w, jnp.float32))
        scale = np.abs(w).max()
        # bf16 blobs: one-ulp (2^-8) rounding flips between two float32
        # sum orders, carried through ~100 layers (the bounds of the
        # default fast path's test in test_torch_net.py)
        err = np.abs(g - w)
        assert err.max() <= 2 ** -3 * scale, err.max() / scale
        assert err.mean() <= 2 ** -8 * scale, err.mean() / scale


def test_conv0_guard_without_region(monkeypatch):
    """``conv0_pallas`` takes the stem kernel only when a run starts at
    layer 1: with the default runs the normal stem runs, as in JAX."""
    _, ir, params = _model(64)
    tp = tbuild.params_from_numpy(params)
    runs = tbf.plan_runs(ir, 24, False)
    assert all(r.start != 1 for r in runs)
    fp = {r.start: [tbf.block_params(ir, tp, b) for b in r.blocks]
          for r in runs}
    x = torch.from_numpy(np.random.RandomState(10).randint(
        0, 256, (2, 64, 64, 3), dtype=np.uint8))
    want = tbuild.forward_features(ir, tp, x, fused_runs=runs,
                                   fused_params=fp)

    def refuse(*args, **kw):
        raise AssertionError("the stem kernel ran without a run at 1")
    monkeypatch.setattr(tbuild, "conv0_cs", refuse)
    got = tbuild.forward_features(ir, tp, x, fused_runs=runs,
                                  fused_params=fp, conv0_pallas=True,
                                  conv0_params=tc0.conv0_params(ir, tp))
    assert all(torch.equal(g, w) for g, w in zip(got, want))


# ------------------------------------------------------------- no fallback
def test_wrappers_refuse_other_devices(xl96):
    """No fallback: a tensor off the CPU that a kernel cannot take raises
    instead of reaching the plain version."""
    _, ir, params = xl96
    tp = tbuild.params_from_numpy(params)
    blk = tbf.find_fused_blocks(ir)[22]
    b = ir.blobs[blk.start]
    with pytest.raises(ValueError):
        tbf.fused_down_block(torch.empty((1, b.h, b.w, b.c), device="meta"),
                             tbf.block_params(ir, tp, blk))
    with pytest.raises(ValueError):
        tc0.conv0_cs(torch.empty((1, 96, 96, 3), dtype=torch.uint8,
                                 device="meta"), tc0.conv0_params(ir, tp))
    run = thf.plan_head_runs(ir)[0]
    hb = ir.blobs[run.start]
    with pytest.raises(ValueError):
        thf.apply_head_run(torch.empty((1, hb.h, hb.w, hb.c), device="meta"),
                           run, thf.head_params(ir, tp, run))
    assert tbf.fused_down_block.launches == tc0.conv0_cs.launches == \
        thf.apply_head_run.launches == 0


def test_region_net_runs_without_jax(tmp_path):
    """A region Net builds and detects on the CPU with jax and the JAX
    package unimportable."""
    code = (
        "import os, sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['ffcnn_tpu'] = None\n"
        f"os.environ.update({REGION_FLAGS!r})\n"
        "import numpy as np\n"
        "import ffcnn_tpu_torch as pt\n"
        f"cfg = {XL!r}\n"
        "ir = pt.parse_cfg(cfg, 64, 64)\n"
        "w = pt.synth_weights_bytes(ir, seed=42, obj_bias=2.0)\n"
        "net = pt.load(cfg, w, input_w=64, input_h=64, device='cpu')\n"
        "assert [r.start for r in net._fused_runs] == [1, 81]\n"
        "assert [r.start for r in net._head_runs] == [116, 125]\n"
        "img = np.random.RandomState(0).randint(0, 256, (64, 64, 3),\n"
        "                                       dtype=np.uint8)\n"
        "dets = net.detect(img)\n"
        "assert dets and all(d.score > 0 for d in dets)\n"
        "assert not any(m.split('.')[0] in ('jax', 'ffcnn_tpu')\n"
        "               for m, v in sys.modules.items() if v is not None)\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"
