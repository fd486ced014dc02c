"""The port's fused-block planner and block (ffcnn_tpu_torch/kernels/
block_fused.py) against the JAX package's, on the CPU: plans must be equal,
and the plain block must compute what the Pallas kernel computes (run in
interpret mode)."""

import glob
import os

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from ffcnn_tpu.darknet import parse_cfg
from ffcnn_tpu.darknet.weights import load_weights, synth_weights_bytes
from ffcnn_tpu.graph.build import params_to_pytree
from ffcnn_tpu.kernels import block_fused as jbf
from ffcnn_tpu_torch.darknet import parse_cfg as tparse_cfg
from ffcnn_tpu_torch.graph.build import params_from_numpy
from ffcnn_tpu_torch.kernels import block_fused as tbf
from ffcnn_tpu_torch.testing import cap_threads

cap_threads()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFGS = sorted(glob.glob(os.path.join(REPO, "models", "*.cfg")))
XL = os.path.join(REPO, "models", "yolo-fastest-xl.cfg")


def _plan(runs):
    return [(r.start, r.end, [(b.start, b.end, b.residual, b.res_act, b.down)
                              for b in r.blocks]) for r in runs]


@pytest.mark.parametrize("cfg_path", CFGS, ids=[
    os.path.splitext(os.path.basename(p))[0] for p in CFGS])
def test_plan_runs_equal_jax(cfg_path):
    ir, tir = parse_cfg(cfg_path), tparse_cfg(cfg_path)
    assert _plan(tbf.plan_runs(tir)) == _plan(jbf.plan_runs(ir))
    assert _plan(tbf.plan_runs(tir, min_channels=1)) == \
        _plan(jbf.plan_runs(ir, min_channels=1, allow_down=False))


def test_xl_plan_at_320():
    """yolo-fastest-xl at 320: three runs, 13 stride-1 residual blocks."""
    ir = tparse_cfg(XL, 320, 320)
    runs = tbf.plan_runs(ir)
    assert [(r.start, r.end, len(r.blocks)) for r in runs] == \
        [(38, 57, 4), (61, 80, 4), (84, 108, 5)]
    assert all(b.residual for r in runs for b in r.blocks)
    assert [(ir.blobs[r.start].h, ir.blobs[r.start].c,
             ir.layers[r.start].fn) for r in runs] == \
        [(40, 32, 192), (20, 48, 272), (10, 96, 448)]


@pytest.mark.parametrize("h,w", [(40, 40), (20, 20), (10, 10), (3, 3),
                                 (7, 13), (1, 1)])
def test_pick_tile_limits(h, w):
    th, tw = tbf.pick_tile(h, w)
    assert th * tw <= 64 and (th + 2) * (tw + 2) <= 104
    assert th <= h and tw <= w


@pytest.mark.parametrize("h,w", [(80, 80), (40, 40), (20, 20), (10, 10),
                                 (5, 7), (1, 1)])
def test_pick_tile_limits_stride2(h, w):
    """Stride-2 tiles of an (h, w) output map: a (2TH+1) x (2TW+1) input
    halo of at most 160 pixels (csrc/block_fused.cuh max_halo<2>)."""
    th, tw = tbf.pick_tile(h, w, 2)
    assert th * tw <= 64 and (2 * th + 1) * (2 * tw + 1) <= 160
    assert th <= h and tw <= w


@pytest.fixture(scope="module")
def xl96():
    """JAX's IR, the port's IR and the folded params of xl at 96x96."""
    ir = parse_cfg(XL, 96, 96)
    params, _ = load_weights(ir, synth_weights_bytes(ir, seed=42,
                                                     obj_bias=2.0))
    return ir, tparse_cfg(XL, 96, 96), params


# run 1: 6x6 C48 E272, 4 blocks; run 2: 3x3 C96 E448, 5 blocks (the
# Pallas interpreter is slow on the CPU, so run 0 at 12x12 is left out)
@pytest.mark.parametrize("run_index,dtype", [(1, "float32"),
                                             (1, "bfloat16"),
                                             (2, "bfloat16")])
def test_apply_run_matches_jax_interpret(xl96, run_index, dtype):
    ir, tir, params = xl96
    run = tbf.plan_runs(tir)[run_index]
    jrun = jbf.plan_runs(ir)[run_index]
    b = ir.blobs[run.start]
    rng = np.random.RandomState(run_index)
    x = rng.randn(2, b.h, b.w, b.c).astype(np.float32)
    want = jbf.apply_run(jnp.asarray(x, dtype), ir, params_to_pytree(params),
                         jrun, interpret=True)
    tp = params_from_numpy(params)
    got = tbf.apply_run(torch.from_numpy(x).to(getattr(torch, dtype)), run,
                        [tbf.block_params(tir, tp, b) for b in run.blocks])
    assert got.dtype == getattr(torch, dtype)
    got = got.float().numpy()
    want = np.asarray(jnp.asarray(want, jnp.float32))
    scale = np.abs(want).max()
    if dtype == "float32":
        # float32 sums of <= 448 terms in another order, over 4-5 blocks
        np.testing.assert_allclose(got, want, rtol=1e-4,
                                   atol=1e-5 * scale)
    else:
        # each block boundary rounds to bf16; a value an f32 ulp from a
        # rounding edge lands one bf16 ulp (2^-8 relative) away and the
        # next blocks carry it on
        err = np.abs(got - want)
        assert err.max() <= 2 ** -5 * scale, err.max() / scale
        assert err.mean() <= 2 ** -10 * scale, err.mean() / scale


def test_block_plain_matches_unfused_convs(xl96):
    """The plain block equals the three convs + shortcut of the graph."""
    from ffcnn_tpu_torch.ops.activations import activate
    from ffcnn_tpu_torch.ops.conv import conv2d_fused
    _, ir, params = xl96
    tp = params_from_numpy(params)
    blk = tbf.plan_runs(ir)[0].blocks[0]
    b = ir.blobs[blk.start]
    x = torch.from_numpy(np.random.RandomState(3).randn(
        2, b.h, b.w, b.c).astype(np.float32))
    y = x
    for li in range(blk.start, blk.start + 3):
        l, p = ir.layers[li], tp[li]
        y = conv2d_fused(y, p["weights"], p["scale"], p["bias"],
                         stride=l.stride, pad=l.pad, groups=l.groups,
                         act=l.activation)
    y = activate(y + x, blk.res_act)
    got = tbf.block_plain(x, tbf.block_params(ir, tp, blk))
    np.testing.assert_allclose(got.numpy(), y.numpy(), rtol=1e-4, atol=1e-5)


def test_wrapper_refuses_other_devices(xl96):
    """No fallback: a tensor off the CPU that the kernel cannot take raises
    instead of reaching the plain version."""
    _, ir, params = xl96
    blk = tbf.plan_runs(ir)[0].blocks[0]
    bp = tbf.block_params(ir, params_from_numpy(params), blk)
    b = ir.blobs[blk.start]
    with pytest.raises(ValueError):
        tbf.fused_block(torch.empty((1, b.h, b.w, b.c), device="meta"), bp)


def test_apply_run_dispatches_down_blocks(xl96):
    """A region run (stride-2 block first) goes block by block through the
    stride-2 and stride-1 versions."""
    _, ir, params = xl96
    run = tbf.plan_runs(ir, 8, True)[1]
    assert run.start == 81 and run.blocks[0].down
    tp = params_from_numpy(params)
    bps = [tbf.block_params(ir, tp, b) for b in run.blocks]
    b = ir.blobs[run.start]
    x = torch.from_numpy(np.random.RandomState(6).randn(
        2, b.h, b.w, b.c).astype(np.float32))
    want = tbf.block_down_plain(x, bps[0])
    for bp in bps[1:]:
        want = tbf.block_plain(want, bp)
    got = tbf.apply_run(x, run, bps)
    assert got.shape == (2, b.h // 2, b.w // 2, ir.blobs[run.end + 1].c)
    assert torch.equal(got, want)


def test_apply_run_needs_params_for_every_block(xl96):
    _, ir, params = xl96
    run = tbf.plan_runs(ir)[0]
    tp = params_from_numpy(params)
    b = ir.blobs[run.start]
    x = torch.zeros((1, b.h, b.w, b.c))
    with pytest.raises(ValueError):
        tbf.apply_run(x, run, [tbf.block_params(ir, tp, run.blocks[0])])
