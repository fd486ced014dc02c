"""The port's chained fused blocks against the JAX package on the CPU: the
halo cascade (K4, ``FFCNN_FUSED_CASCADE=k``) and the whole-run kernel (K5,
``FFCNN_FUSED_MEGA``).  Both packages must group and route the same blocks,
and the plain version both kernels share (``chain_plain``) must compute
what ``_make_cascade_kernel`` and ``_make_mega_kernel`` compute in
interpret mode, alone and in the whole forward.  Also the flags the port
takes from the JAX package with them: ``FFCNN_FUSED_STORE=f32`` (ported),
``FFCNN_HEAD_F32`` and ``FFCNN_F32_STAGES`` (taken; ``test_torch_graph.py``
holds what they compute), and the head chain
(K7) at 416x416, whose stage buffers no longer need to fit shared
memory."""

import glob
import os

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
# the cascade configuration's groups on xl at 320x320 (the region plan
# with FFCNN_FUSED_CASCADE=3), by their blocks' expand layers
XL_CASCADE_GROUPS = [[1, 4], [9], [12, 17], [22], [25, 30, 35],
                     [38, 43, 48], [53], [58], [61, 66, 71], [76], [81],
                     [84, 89, 94], [99, 104]]


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


def _nhwc_to_cs(x):
    n, h, w, c = x.shape
    return jnp.transpose(x, (1, 3, 2, 0)).reshape(h, c, w * n)


def _cs_to_nhwc(y, w, n):
    h, p, _ = y.shape
    return jnp.transpose(y.reshape(h, p, w, n), (3, 0, 2, 1))


def _acts(ir, b):
    return tuple(ir.layers[b.start + i].activation for i in range(3))


def _assert_close(got, want, dtype, f32_rtol=1e-4, f32_atol=1e-5):
    """float32: sums of a few hundred terms in another order.  bfloat16:
    float32 inside and one rounding at the end, so a value an f32 ulp from
    a rounding edge lands one bf16 ulp (2^-8 relative) away; allow two."""
    assert got.shape == want.shape
    scale = np.abs(want).max()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=f32_rtol,
                                   atol=f32_atol * scale)
    else:
        assert np.abs(got - want).max() <= 2 ** -7 * scale


# ---------------------------------------------------------------- routing
def _jax_groups(ir, run, monkeypatch):
    """The launch groups ``run_blocks_cs`` makes of ``run``, observed by
    recorders over its three launchers while it is traced under
    ``jax.eval_shape`` (nothing is computed)."""
    seen = []

    def rec_cascade(x, params_list, metas, width, n, **kw):
        seen.append(len(metas))
        return jnp.zeros((x.shape[0], params_list[-1][6].shape[0],
                          x.shape[2]), kw.get("out_dtype") or x.dtype)

    def rec_block(x, params9, *args, **kw):
        seen.append(1)
        return jnp.zeros((x.shape[0], params9[6].shape[0], x.shape[2]),
                         kw.get("out_dtype") or x.dtype)

    def rec_down(x, params9, acts, width, n, **kw):
        seen.append(-1)
        return jnp.zeros((x.shape[0] // 2, params9[6].shape[0],
                          (width // 2) * n), kw.get("out_dtype") or x.dtype)

    monkeypatch.setattr(jbf, "_cs_cascade", rec_cascade)
    monkeypatch.setattr(jbf, "_cs_block", rec_block)
    monkeypatch.setattr(jbf, "_cs_down_block", rec_down)
    shapes = {}
    for b in run.blocks:
        for li in range(b.start, b.start + 3):
            l, c = ir.layers[li], ir.blobs[li].c
            shapes[li] = {
                "weights": jax.ShapeDtypeStruct(
                    (l.fs, l.fs, c // l.groups, l.fn), jnp.float32),
                "scale": jax.ShapeDtypeStruct((l.fn,), jnp.float32),
                "bias": jax.ShapeDtypeStruct((l.fn,), jnp.float32)}
    bi = ir.blobs[run.start]
    jax.eval_shape(
        lambda xc, p: jbf.run_blocks_cs(xc, ir, p, run, bi.h, bi.w, 1,
                                        final_dtype=jnp.float32)[0],
        jax.ShapeDtypeStruct((bi.h, bi.c, bi.w), jnp.float32), shapes)
    blocks = iter(b.start for b in run.blocks)
    return [[next(blocks) for _ in range(abs(k))] for k in seen]


@pytest.mark.parametrize("region", [False, True], ids=["default", "region"])
@pytest.mark.parametrize("k", [2, 3, 4, 5])
@pytest.mark.parametrize("cfg_path", CFGS, ids=CFG_IDS)
def test_cascade_groups_equal_jax(cfg_path, k, region, monkeypatch):
    """``cascade_groups`` makes the launch groups JAX's ``run_blocks_cs``
    makes for ``FFCNN_FUSED_CASCADE=k``, on every run of every config."""
    ir, tir = parse_cfg(cfg_path), tparse_cfg(cfg_path)
    minc, down = (8, True) if region else (24, False)
    monkeypatch.setenv("FFCNN_FUSED_CASCADE", str(k))
    for jr, tr in zip(jbf.plan_runs(ir, minc, down),
                      tbf.plan_runs(tir, minc, down), strict=True):
        want = _jax_groups(ir, jr, monkeypatch)
        got = [[b.start for b in g] for g in tbf.cascade_groups(tr, k)]
        assert got == want, (tr.start, got, want)


def test_xl_cascade_plan_at_320(monkeypatch):
    """The cascade configuration of xl: 7 K4 groups, 2 single stride-1
    blocks (K1) and 4 stride-2 blocks (K3), as a Net plans it."""
    for key, v in {**REGION_FLAGS, "FFCNN_FUSED_CASCADE": "3"}.items():
        monkeypatch.setenv(key, v)
    _, ir, params = _model(320)
    net = pt.Net(ir, params, mode="fast", device="cpu")
    groups = [[b.start for b in g] for r in net._fused_runs
              for g in net._fused_groups[r.start]]
    assert groups == XL_CASCADE_GROUPS
    assert net._mega_runs == frozenset() and net._mid_dtype is None


@pytest.mark.parametrize("size", [320, 416])
@pytest.mark.parametrize("cfg_path", CFGS, ids=CFG_IDS)
def test_mega_fits_equals_jax(cfg_path, size):
    """``mega_fits`` gives JAX's ``_mega_fits`` on every run of the default
    and the region plans."""
    ir, tir = parse_cfg(cfg_path, size, size), tparse_cfg(cfg_path, size,
                                                          size)
    truns = tbf.plan_runs(tir, 24, False) + tbf.plan_runs(tir, 8, True)
    jruns = jbf.plan_runs(ir, 24, False) + jbf.plan_runs(ir, 8, True)
    for tr, jr in zip(truns, jruns, strict=True):
        bi = ir.blobs[jr.start]
        assert tbf.mega_fits(tir, tr) == jbf._mega_fits(ir, None, jr, bi.h,
                                                        bi.w), tr


def test_xl_mega_plan_at_320(monkeypatch):
    """The mega configuration of xl: run 84-108 launches whole (K5); runs
    38-57 and 61-80 fail the JAX mega gate and launch per block."""
    monkeypatch.setenv("FFCNN_FUSED_MEGA", "1")
    _, ir, params = _model(320)
    net = pt.Net(ir, params, mode="fast", device="cpu")
    assert [(r.start, r.end) for r in net._fused_runs] == \
        [(38, 57), (61, 80), (84, 108)]
    assert net._mega_runs == frozenset({84})
    monkeypatch.delenv("FFCNN_FUSED_MEGA")
    assert pt.Net(ir, params, mode="fast",
                  device="cpu")._mega_runs == frozenset()


def test_chain_tiles_fit_the_card():
    """Every K4 group and the K5 run of xl at 320 has a tile within a CTA's
    shared memory, at batch 1 and 64; a chain too wide for the card raises
    when it is checked."""
    _, ir, params = _model(320)
    tp = tbuild.params_from_numpy(params)
    blocks = {b.start: b for b in tbf.find_fused_blocks(ir).values()}
    for g in XL_CASCADE_GROUPS:
        if len(g) < 2:
            continue
        bps = [tbf.block_params(ir, tp, blocks[s]) for s in g]
        bi = ir.blobs[g[0]]
        th, tw = tbf.check_chain_fits(bi.h, bi.w, bps)
        assert 1 <= th <= bi.h and 1 <= tw <= bi.w
        assert tbf.cascade_smem(tbf._widths(bps), th, tw) <= tbf.MAX_SMEM
    run = [r for r in tbf.plan_runs(ir, 24, False) if r.start == 84][0]
    bps = [tbf.block_params(ir, tp, b) for b in run.blocks]
    th, tw = tbf.check_chain_fits(10, 10, bps, mega=True)
    assert tbf.mega_smem(tbf._widths(bps), 10, 10, th, tw) <= tbf.MAX_SMEM
    with pytest.raises(ValueError):
        tbf.check_chain_fits(80, 80, bps, mega=True)   # two maps > 227 KB
    with pytest.raises(ValueError):
        tbf.check_chain_fits(10, 10, bps * 4)          # 20 blocks


# ------------------------------------------------ plain version against JAX
def _chain_inputs(size, starts, seed):
    ir, tir, params = _model(size)
    blocks = tbf.find_fused_blocks(tir)
    jblocks = jbf.find_fused_blocks(ir)
    tp = tbuild.params_from_numpy(params)
    bi = ir.blobs[starts[0]]
    x = np.random.RandomState(seed).randn(2, bi.h, bi.w, bi.c) \
        .astype(np.float32)
    bps = [tbf.block_params(tir, tp, blocks[s]) for s in starts]
    return ir, params, [jblocks[s] for s in starts], bps, x


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("size,starts", [
    (96, [25, 30, 35]),      # 12x12, plain blocks, widths 16 -> 16 -> 32
    (96, [84, 89, 94]),      # 3x3, residual, C96 E448
    (160, [61, 66, 71]),     # 10x10: the height is no multiple of 3
    (160, [99, 104])],       # 5x5, a pair
    ids=["25-35@96", "84-94@96", "61-71@160", "99-104@160"])
def test_chain_plain_matches_jax_cascade(size, starts, dtype):
    """``chain_plain`` (K4's plain version, through ``fused_cascade`` on
    the CPU) against ``_cs_cascade`` in interpret mode, which keeps the
    group's interior boundaries in float32 and rounds once at the end."""
    ir, params, jblocks, bps, x = _chain_inputs(size, starts, starts[0])
    jp = jbuild.params_to_pytree(params)
    bi = ir.blobs[starts[0]]
    jdt = getattr(jnp, dtype)
    y = jbf._cs_cascade(_nhwc_to_cs(jnp.asarray(x, jdt)),
                        [jbf._block_params(jp, b) for b in jblocks],
                        [(_acts(ir, b), b.residual, b.res_act)
                         for b in jblocks], bi.w, 2, interpret=True)
    assert y is not None and y.dtype == jdt
    want = np.asarray(jnp.asarray(_cs_to_nhwc(y, bi.w, 2), jnp.float32))
    got = tbf.fused_cascade(torch.from_numpy(x).to(getattr(torch, dtype)),
                            bps)
    assert got.dtype == getattr(torch, dtype)
    _assert_close(got.float().numpy(), want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chain_plain_matches_jax_mega(dtype):
    """``chain_plain`` (K5's plain version, through ``apply_run``'s mega
    route on the CPU) against ``_apply_run_mega`` in interpret mode: run
    84-108 of xl at 160x160 (5x5 maps, five residual blocks C96 E448), on
    one 128-image chunk."""
    ir, tir, params = _model(160)
    run = [r for r in jbf.plan_runs(ir) if r.start == 84][0]
    bi = ir.blobs[run.start]
    assert (bi.h, bi.w, bi.c, len(run.blocks)) == (5, 5, 96, 5)
    x = np.random.RandomState(84).randn(128, 5, 5, 96).astype(np.float32)
    want = jbf._apply_run_mega(jnp.asarray(x, getattr(jnp, dtype)), ir,
                               jbuild.params_to_pytree(params), run,
                               interpret=True)
    want = np.asarray(jnp.asarray(want, jnp.float32))
    tp = tbuild.params_from_numpy(params)
    trun = [r for r in tbf.plan_runs(tir) if r.start == 84][0]
    got = tbf.apply_run(torch.from_numpy(x).to(getattr(torch, dtype)), trun,
                        [tbf.block_params(tir, tp, b) for b in trun.blocks],
                        mega=True)
    assert got.dtype == getattr(torch, dtype)
    _assert_close(got.float().numpy(), want, dtype)


def test_chain_plain_is_blocks_unrounded():
    """``chain_plain`` equals the blocks one after another in float32,
    whatever the input's dtype, with one cast at the end."""
    ir, params, _, bps, x = _chain_inputs(96, [84, 89, 94], 3)
    xt = torch.from_numpy(x)
    want = xt
    for bp in bps:
        want = tbf.block_plain(want, bp)
    np.testing.assert_array_equal(tbf.chain_plain(xt, bps).numpy(),
                                  want.numpy())
    got = tbf.chain_plain(xt.bfloat16(), bps, torch.float32)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(
        got.numpy(), tbf.chain_plain(xt.bfloat16().float(), bps).numpy())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_store_f32_matches_jax(xl96, dtype, monkeypatch):
    """``FFCNN_FUSED_STORE=f32``: the boundaries between a run's launches
    in float32, the run's output in the input dtype, as JAX's
    ``apply_run`` stores them (per block, and per cascade group)."""
    ir, tir, params = xl96
    monkeypatch.setenv("FFCNN_FUSED_STORE", "f32")
    run = [r for r in jbf.plan_runs(ir) if r.start == 61][0]      # 6x6
    bi = ir.blobs[run.start]
    x = np.random.RandomState(61).randn(2, bi.h, bi.w, bi.c) \
        .astype(np.float32)
    tp = tbuild.params_from_numpy(params)
    net = pt.Net(tir, params, mode="fast", device="cpu")
    assert net._mid_dtype == torch.float32
    trun = [r for r in net._fused_runs if r.start == 61][0]
    bps = net._fused_params[61]
    assert [tbf.block_params(tir, tp, b).w1.shape for b in trun.blocks] == \
        [bp.w1.shape for bp in bps]
    got = {}
    for k in (0, 2):
        monkeypatch.setenv("FFCNN_FUSED_CASCADE", str(k))
        want = jbf.apply_run(jnp.asarray(x, getattr(jnp, dtype)), ir,
                             jbuild.params_to_pytree(params), run,
                             interpret=True)
        want = np.asarray(jnp.asarray(want, jnp.float32))
        got[k] = tbf.apply_run(
            torch.from_numpy(x).to(getattr(torch, dtype)), trun, bps,
            groups=tbf.cascade_groups(trun, k), mid_dtype=net._mid_dtype)
        assert got[k].dtype == getattr(torch, dtype)
        _assert_close(got[k].float().numpy(), want, dtype)
    if dtype == "bfloat16":
        # the flag matters: bf16 boundaries give another result
        rounded = tbf.apply_run(torch.from_numpy(x).bfloat16(), trun, bps)
        assert not torch.equal(rounded, got[0])


# ------------------------------------------------------- the whole forward
def _cascade_groups_of(runs, k):
    return {r.start: tbf.cascade_groups(r, k) for r in runs}


def test_cascade_forward_matches_jax_f32(monkeypatch):
    """The cascade configuration's whole forward in float32 (stem off
    uint8, region runs in groups of up to 3, head chains) against JAX's
    with its Pallas kernels in interpret mode, at 32x32 (maps 16x16 down
    to 1x1; JAX's cascade takes the groups on maps of at least 3 rows and
    launches the rest per block, which float32 does not tell apart)."""
    monkeypatch.setenv("FFCNN_FUSED_CASCADE", "3")
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
        fused_groups=_cascade_groups_of(runs, 3),
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


def test_cascade_forward_matches_jax_bf16(monkeypatch):
    """Fast mode in the cascade configuration (Net.forward_heads: bf16
    blobs, K4 groups, float32 inside each group) against JAX's forward in
    interpret mode, at 32x32 as above.  Where JAX's cascade has no legal
    row count (maps of 1-2 rows) it rounds the boundaries inside a group
    to bf16 and the port does not: one-ulp differences, within the fast
    path's bounds."""
    flags = {**REGION_FLAGS, "FFCNN_FUSED_CASCADE": "3"}
    for k, v in flags.items():
        monkeypatch.setenv(k, v)
    ir, tir, params = _model(32)
    frames = np.random.RandomState(9).randint(0, 256, (2, 32, 32, 3),
                                              dtype=np.uint8)
    net = pt.Net(tir, params, mode="fast", device="cpu")
    assert any(len(g) > 1 for gs in net._fused_groups.values() for g in gs)
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
        # region path's test in test_torch_regions.py)
        err = np.abs(g - w)
        assert err.max() <= 2 ** -3 * scale, err.max() / scale
        assert err.mean() <= 2 ** -8 * scale, err.mean() / scale


def test_mega_forward_matches_jax_f32(monkeypatch):
    """The mega configuration's forward in float32 at batch 2, at 64x64
    (all three default runs pass the mega gate there and launch whole).
    JAX takes its per-block route at a batch that is no multiple of 128;
    the two agree to float32 noise."""
    monkeypatch.setenv("FFCNN_FUSED_MEGA", "1")
    ir, tir, params = _model(64)
    net = pt.Net(tir, params, mode="fast", device="cpu")
    assert net._mega_runs == frozenset({38, 61, 84})
    calls = []
    real = tbf.fused_mega

    def spy(x, bps):
        calls.append(x.shape)
        return real(x, bps)
    monkeypatch.setattr(tbf, "fused_mega", spy)
    x = np.random.RandomState(11).randint(0, 256, (2, 64, 64, 3),
                                          dtype=np.uint8)
    tp = tbuild.params_from_numpy(params)
    got = tbuild.forward_features(
        tir, tp, torch.from_numpy(x), input_dtype=torch.float32,
        fused_runs=net._fused_runs,
        fused_params={r.start: [tbf.block_params(tir, tp, b)
                                for b in r.blocks] for r in net._fused_runs},
        mega_runs=net._mega_runs)
    assert len(calls) == 3
    want = jax.jit(lambda v: jbuild.forward_features(
        ir, jbuild.params_to_pytree(params), v, input_dtype=jnp.float32,
        fused_runs=jbf.plan_runs(ir), fused_interpret=True))(jnp.asarray(x))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4,
                                   atol=1e-4 * np.abs(w).max())


def test_stem_enters_run_blocks_never_mega(monkeypatch):
    """The stem kernel's output goes into the run at layer 1 group by
    group (as JAX's stem enters ``run_blocks_cs``), even where that run is
    listed for the mega route."""
    _, ir, params = _model(64)
    tp = tbuild.params_from_numpy(params)
    runs = tbf.plan_runs(ir, 8, False)
    assert runs[0].start == 1 and not any(b.down for b in runs[0].blocks)
    fp = {r.start: [tbf.block_params(ir, tp, b) for b in r.blocks]
          for r in runs}
    x = torch.from_numpy(np.random.RandomState(12).randint(
        0, 256, (2, 64, 64, 3), dtype=np.uint8))
    kw = dict(input_dtype=torch.float32, fused_runs=runs, fused_params=fp,
              conv0_pallas=True, conv0_params=tc0.conv0_params(ir, tp))
    want = tbuild.forward_features(ir, tp, x, **kw)

    def refuse(*args, **kwargs):
        raise AssertionError("the stem's run took the mega route")
    monkeypatch.setattr(tbf, "fused_mega", refuse)
    got = tbuild.forward_features(ir, tp, x, mega_runs=frozenset({1}), **kw)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


# ------------------------------------------------------------ K7 at 13x13
def test_head_chain_at_416_fits():
    """xl's 13x13 head chain at 416x416, which the region configuration
    plans as JAX does: with one CTA an image its stage buffers exceed a
    CTA's shared memory, so they go to device memory; a cluster of two
    holds them on chip; ``check_fits`` accepts the chain."""
    ir, tir, params = _model(416)
    runs = thf.plan_head_runs(tir)
    assert [(r.start, r.end) for r in runs] == \
        [(r.start, r.end) for r in jhf.plan_head_runs(ir)]
    hp = thf.head_params(tir, tbuild.params_from_numpy(params), runs[0])
    assert (hp.h, hp.w) == (13, 13)
    alone = thf.plan(hp, 67, 132)
    assert alone.cluster == 1 and alone.scratch == 2 * 13 * 13 * 196
    assert 4 * (2 * 13 * 13 * 196 + 2 * 32 * 264) > thf.MAX_SMEM
    pair = thf.plan(hp, 64, 132)
    assert (pair.cluster, pair.rows, pair.scratch) == (2, 7, 0)
    assert pair.smem <= thf.MAX_SMEM
    thf.check_fits(hp)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_head_plain_matches_jax_at_416(dtype):
    """K7's plain version against ``apply_head_run`` (interpret mode) on
    the 13x13 chain of xl at 416x416, batch 2."""
    ir, tir, params = _model(416)
    jr = jhf.plan_head_runs(ir)[0]
    tr = thf.plan_head_runs(tir)[0]
    b = ir.blobs[tr.start]
    x = np.random.RandomState(13).randn(2, b.h, b.w, b.c).astype(np.float32)
    want = jhf.apply_head_run(jnp.asarray(x, getattr(jnp, dtype)), ir,
                              jbuild.params_to_pytree(params), jr,
                              interpret=True)
    want = np.asarray(jnp.asarray(want, jnp.float32))
    got = thf.apply_head_run(
        torch.from_numpy(x).to(getattr(torch, dtype)), tr,
        thf.head_params(tir, tbuild.params_from_numpy(params), tr))
    assert got.dtype == getattr(torch, dtype)
    assert got.shape == (2, 13, 13, 255)
    _assert_close(got.float().numpy(), want, dtype)


def test_region_net_at_416(monkeypatch):
    """A region Net at 416x416 builds (the head chain no longer refused)
    and its heads on the CPU are finite."""
    for k, v in REGION_FLAGS.items():
        monkeypatch.setenv(k, v)
    ir, tir, params = _model(416)
    net = pt.Net(tir, params, mode="fast", device="cpu")
    assert [(r.start, r.end) for r in net._head_runs] == \
        [(r.start, r.end) for r in jhf.plan_head_runs(ir)]
    assert net._head_runs[0].start == 116
    frames = np.random.RandomState(14).randint(0, 256, (1, 416, 416, 3),
                                               dtype=np.uint8)
    heads = net.forward_heads(torch.from_numpy(frames))
    assert [tuple(h.shape) for h in heads] == [(1, 13, 13, 255),
                                               (1, 26, 26, 255)]
    assert all(bool(torch.isfinite(h.float()).all()) for h in heads)


# ------------------------------------------- float32 knobs, once refused
@pytest.mark.parametrize("flag,value", [("FFCNN_HEAD_F32", "1"),
                                        ("FFCNN_F32_STAGES", "160"),
                                        ("FFCNN_F32_STAGES", "160,80")])
def test_unported_f32_flags_refused(flag, value, monkeypatch):
    """The JAX package's float32 accuracy knobs, which a fast Net refused
    before they were ported, are taken now: a fast Net reads them when it
    is built and forces the layers JAX's pipeline forces (the head chains,
    or the stages' convs and shortcuts); parity mode takes no knob, and
    with the flag unset no layer is forced."""
    jir, ir, params = _model(320)
    monkeypatch.setenv(flag, value)
    want = (jbuild.head_chain_layers(jir) if flag == "FFCNN_HEAD_F32"
            else jbuild.stage_layer_set(jir, value))
    assert want
    assert pt.Net(ir, params, mode="fast", device="cpu")._f32_layers == want
    assert pt.Net(ir, params, mode="parity", device="cpu")._f32_layers is None
    monkeypatch.setenv(flag, "0" if flag == "FFCNN_HEAD_F32" else "")
    assert pt.Net(ir, params, mode="fast", device="cpu")._f32_layers is None


# ------------------------------------------------------------- no fallback
def test_chain_wrappers_refuse_other_devices(xl96):
    """No fallback: a tensor off the CPU that K4 or K5 cannot take raises
    instead of reaching ``chain_plain``, and nothing counts a launch."""
    _, ir, params = xl96
    tp = tbuild.params_from_numpy(params)
    blocks = tbf.find_fused_blocks(ir)
    bps = [tbf.block_params(ir, tp, blocks[s]) for s in (84, 89, 94)]
    x = torch.empty((1, 3, 3, 96), device="meta")
    with pytest.raises(ValueError):
        tbf.fused_cascade(x, bps)
    with pytest.raises(ValueError):
        tbf.fused_mega(x, bps)
    assert tbf.fused_cascade.launches == tbf.fused_mega.launches == 0
