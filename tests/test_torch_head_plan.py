"""The launch plan of K7, the fused yolo-head chain (``kernels/head_fused.py``
``plan``), on the CPU: for every head chain of every ``models/*.cfg`` at
the sizes users run, each image row is owned by exactly one CTA of its
cluster, the cluster is two exactly while the batch leaves SMs idle, the
shared memory fits an H100's CTA, the stage buffers leave shared memory
only where they do not fit at that cluster size, and the plan mirrors
``layout`` in ``csrc/head_fused.cu``."""

import functools
import glob
import os
import re

import pytest
import torch

from ffcnn_tpu_torch.darknet import parse_cfg
from ffcnn_tpu_torch.kernels import head_fused as hf
from ffcnn_tpu_torch.testing import cap_threads

cap_threads()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "ffcnn_tpu_torch", "csrc", "head_fused.cu")
MMA = os.path.join(REPO, "ffcnn_tpu_torch", "csrc", "tf32_mma.cuh")
CFGS = sorted(glob.glob(os.path.join(REPO, "models", "*.cfg")))
SIZES = (64, 96, 320, 416, 608)
# the chains models/*.cfg plan at each size: xl's 116-120, and at 64 and
# 96 px also its 125-129 (240 channels)
CHAINS = {64: 2, 96: 2, 320: 1, 416: 1, 608: 1}


def _params(ir):
    """Weights of the right shapes and no storage (``device="meta"``):
    the plan reads only shapes."""
    out = {}
    for li, l in enumerate(ir.layers):
        if l.fn:
            cin = ir.blobs[li].c // max(l.groups, 1)
            out[li] = {"weights": torch.empty((l.fn, cin, l.fs, l.fs),
                                              device="meta"),
                       "scale": torch.empty(l.fn, device="meta"),
                       "bias": torch.empty(l.fn, device="meta")}
    return out


@functools.lru_cache(maxsize=None)
def chains(size):
    """HeadParams of every head chain of every cfg at ``size``."""
    out = []
    for cfg in CFGS:
        ir = parse_cfg(cfg, size, size)
        runs = hf.plan_head_runs(ir)
        if runs:
            params = _params(ir)
            out += [hf.head_params(ir, params, r) for r in runs]
    return tuple(out)


@pytest.mark.parametrize("sms", [114, 132])
@pytest.mark.parametrize("n", [1, 8, 64, 66, 67, 256])
@pytest.mark.parametrize("size", SIZES)
def test_plan_of_every_chain(size, n, sms):
    hps = chains(size)
    assert len(hps) == CHAINS[size]
    for hp in hps:
        p = hf.plan(hp, n, sms)
        assert p.cluster == (2 if 2 * n <= sms and hp.h >= 2 else 1)
        # CTA r owns rows [r * rows, min((r + 1) * rows, h)), none empty
        owners = [0] * hp.h
        for r in range(p.cluster):
            own = range(r * p.rows, min((r + 1) * p.rows, hp.h))
            assert len(own) >= 1
            for y in own:
                owners[y] += 1
        assert owners == [1] * hp.h
        assert p.smem <= hf.MAX_SMEM
        ld, wfl = hf._layout(hp)
        on_chip = 4 * (2 * p.rows * hp.w * ld + wfl)
        if on_chip <= hf.MAX_SMEM:
            assert (p.smem, p.scratch) == (on_chip, 0)
        else:
            assert (p.smem, p.scratch) == (4 * wfl, 2 * hp.h * hp.w * ld)
        hf.check_fits(hp)


@pytest.mark.parametrize("n,cluster,scratch", [(64, 2, 0), (66, 2, 0),
                                               (67, 1, 2 * 169 * 196),
                                               (256, 1, 2 * 169 * 196)])
def test_scratch_only_at_13x13_with_one_cta(n, cluster, scratch):
    """xl's 13x13 chain keeps a CTA's 7 rows on chip in a cluster of two;
    with one CTA an image its buffers go to device memory.  The 10x10
    chain stays on chip at both sizes, the 19x19 one at neither."""
    p13 = hf.plan(chains(416)[0], n, 132)
    assert (p13.cluster, p13.scratch) == (cluster, scratch)
    assert hf.plan(chains(320)[0], n, 132).scratch == 0
    assert hf.plan(chains(608)[0], n, 132).scratch == 2 * 19 * 19 * 196


def test_the_main_chain_at_batch_64():
    """xl at 320, batch 64 on 132 SMs: 128 CTAs of 5 rows each, two
    buffers of 50 pixels by 196 floats and two weight chunks of 32 by
    264 floats."""
    p = hf.plan(chains(320)[0], 64, 132)
    assert p == hf.HeadPlan(2, 5, 4 * (2 * 50 * 196 + 2 * 32 * 264), 0)


def _meta_stage(kind, fs, cin, cout):
    shape = (cin, cout) if kind == "pw" else (cin, fs * fs)
    e = torch.empty(cout, device="meta")
    return hf.HeadStage(kind, fs, 0, torch.empty(shape, device="meta"), e, e)


@pytest.mark.parametrize("stages", [
    [("pw", 1, 8, 8)] * 9,                       # more than 8 stages
    [("dw", 3, 8, 8), ("pw", 1, 8, 257)],        # 257 pointwise outputs
    [("dw", 7, 8, 8), ("pw", 1, 8, 8)],          # a 7x7 depthwise
    [("dw", 5, 2400, 2400), ("pw", 1, 2400, 8)],  # taps over shared memory
])
def test_check_fits_refuses_what_the_kernel_cannot_take(stages):
    hp = hf.HeadParams(tuple(_meta_stage(*s) for s in stages), 4, 4)
    with pytest.raises(ValueError, match="more than the kernel takes"):
        hf.check_fits(hp)


def test_plan_mirrors_the_source():
    """The plan's constants and formulas are the kernel's own."""
    src = open(SRC).read()
    for name, value in (("kMaxStages", hf.MAX_STAGES), ("kKC", hf.KC),
                        ("kRing", hf.RING), ("kMaxPwOut", hf.MAX_PW_OUT)):
        assert re.search(rf"constexpr int {name} = {value};", src), name
    assert re.search(rf"constexpr size_t kMaxSmem = {hf.MAX_SMEM};", src)
    assert hf.DW_SIZES == (3, 5) and "(fs != 3 && fs != 5)" in src
    # the weight region, the stage buffers and the scratch
    for line in ("wfl = std::max(wfl, kRing * kKC * w_ld(cout));",
                 "wfl = std::max(wfl, cin * fs * fs);",
                 "if (s < ns - 1) cbuf = std::max(cbuf, cout);",
                 "l.ld = buf_ld(cbuf);",
                 "const int rows = (h + cluster - 1) / cluster;",
                 "sizeof(float) * (2 * (size_t)rows * w * l.ld + wfl);",
                 "l.smem = l.scratch ? sizeof(float) * wfl : on_chip;",
                 "a.buf = (size_t)(l.scratch ? h : a.rows) * w * l.ld;",
                 "a.scratch + (size_t)img * 2 * a.buf;",
                 "cluster > 2 || h < cluster)"):
        assert line in src, line
    assert "buf_ld(int c) { return mma::ld_a(pad8(c)); }" in src
    assert "w_ld(int n) { return mma::ld_b(pad8(n)); }" in src
    mma = open(MMA).read()
    assert "ld_a(int k) { return (k + 3) / 8 * 8 + 4; }" in mma
    assert "ld_b(int n) { return (n + 7) / 16 * 16 + 8; }" in mma
    assert [hf._ld_a(hf._pad8(c)) for c in (192, 240, 255)] == [196, 244,
                                                                 260]
    assert [hf._ld_b(hf._pad8(n)) for n in (192, 240, 255)] == [200, 248,
                                                                264]
