"""The numeric scheme and the shared-memory layout of the chained kernels
K4 and K5 (``csrc/block_chain.cuh``), on the CPU.  Both run K1's product
code (``csrc/tf32_mma.cuh``): the expand and the project of every block in
3xTF32 on the tensor cores, the boundaries between the blocks in float32,
never rounded.  Emulated in plain torch through each of
yolo-fastest-xl's seven cascade groups at 320x320 and its mega run 84-108,
the chain stays within a quarter of the float32 tolerance that
``chip_smoke.py`` holds the kernels to, though the errors add up over 2-5
blocks; one TF32 pass misses that tolerance.  Also pinned: every chained
block of ``models/*.cfg`` has a compile-time activation instance, and the
Python mirror of the layout (which the tile searches read) equals the
layout of the .cuh."""

import glob
import os
import re

import numpy as np
import pytest
import torch

import chip_smoke
from ffcnn_tpu_torch.darknet import parse_cfg
from ffcnn_tpu_torch.darknet.weights import load_weights, synth_weights_bytes
from ffcnn_tpu_torch.graph.build import params_from_numpy
from ffcnn_tpu_torch.kernels import block_fused as bf
from test_torch_block_mma import act_instance, mm_1xtf32, mm_3xtf32, tf32
from ffcnn_tpu_torch.testing import cap_threads

cap_threads()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(REPO, "ffcnn_tpu_torch", "csrc")
CFGS = sorted(glob.glob(os.path.join(REPO, "models", "*.cfg")))
XL = os.path.join(REPO, "models", "yolo-fastest-xl.cfg")
F32_TOL = chip_smoke.KERNEL_TOL["float32"]
# K4's groups on the cascade path (chip_smoke.CASCADE_GROUPS, two or more
# blocks) and K5's run on the mega path, by their blocks' expand layers
XL_CHAINS = [g for g in chip_smoke.CASCADE_GROUPS if len(g) > 1] + [
    [84, 89, 94, 99, 104]]
CHAIN_IDS = [f"K4-{g[0]}" for g in XL_CHAINS[:-1]] + ["K5-84"]


@pytest.fixture(scope="module")
def xl_chains():
    """[(NetIR blob of the chain's input, [BlockParams])] of XL_CHAINS at
    320x320, synthesized weights (seed 42)."""
    ir = parse_cfg(XL, 320, 320)
    params = params_from_numpy(load_weights(ir, synth_weights_bytes(
        ir, seed=42, obj_bias=2.0))[0])
    blocks = bf.find_fused_blocks(ir)
    return [(ir.blobs[g[0]], [bf.block_params(ir, params, blocks[s])
                              for s in g]) for g in XL_CHAINS]


def _errors(chain, dtype, seed):
    """max |emulated - plain| / range of the chain's float32 output, for
    3xTF32 and for one TF32 pass, on a batch-2 input in ``dtype``."""
    blob, bps = chain
    x = torch.from_numpy(np.random.RandomState(seed).randn(
        2, blob.h, blob.w, blob.c).astype(np.float32)).to(dtype)
    want = bf.chain_plain(x, bps, torch.float32)
    scale = want.abs().max().item()
    return tuple((bf.chain_plain(x, bps, torch.float32, mm) - want).abs()
                 .max().item() / scale for mm in (mm_3xtf32, mm_1xtf32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("index", range(len(XL_CHAINS)), ids=CHAIN_IDS)
def test_3xtf32_chain_meets_the_float32_tolerance(xl_chains, index, dtype):
    err3, _ = _errors(xl_chains[index], dtype, seed=200 + index)
    assert err3 <= F32_TOL / 4, err3


def test_one_tf32_pass_misses_the_tolerance_on_a_chain(xl_chains):
    """One TF32 pass per product misses KERNEL_TOL float32 on at least one
    of xl's chains: the reason for the split."""
    errs = [_errors(c, torch.float32, seed=200 + i)[1]
            for i, c in enumerate(xl_chains)]
    assert max(errs) > F32_TOL, errs


@pytest.mark.parametrize("cfg_path", CFGS, ids=[
    os.path.splitext(os.path.basename(p))[0] for p in CFGS])
def test_every_chained_block_has_an_instance(cfg_path):
    """Every block of a K4 group (FFCNN_FUSED_CASCADE=2 and 3, default and
    region plans) and of a K5 run (the runs mega_fits routes) of the cfg,
    at its own size and at 416, launches with its activations fixed at
    compile time."""
    chained = 0
    for size in (0, 416):
        ir = parse_cfg(cfg_path, size, size)
        for minc, down in ((24, False), (8, True)):
            for r in bf.plan_runs(ir, minc, down):
                groups = [g for k in (2, 3) for g in bf.cascade_groups(r, k)
                          if len(g) > 1]
                if not any(b.down for b in r.blocks) and bf.mega_fits(ir, r):
                    groups.append(list(r.blocks))
                for b in (b for g in groups for b in g):
                    acts = tuple(ir.layers[b.start + i].activation
                                 for i in range(3))
                    assert act_instance(acts, b.residual, b.res_act) \
                        is not None, (cfg_path, b, acts)
                    chained += 1
    assert chained or cfg_path != XL


# ------------------------------------------------------------- the layout
def _cuh(name):
    with open(os.path.join(CSRC, name)) as f:
        return f.read()


def test_the_layout_constants_are_the_cuh_ones():
    """The terms the mirror below copies, as the headers state them."""
    mma, chain = _cuh("tf32_mma.cuh"), _cuh("block_chain.cuh")
    for line in ("constexpr int kChunk = 32;",
                 "constexpr int kLdH = kChunk + 8;",
                 "constexpr int kVec = 13 * kChunk;",
                 "return (k + 3) / 8 * 8 + 4;",
                 "return (n + 7) / 16 * 16 + 8;",
                 "constexpr int kLdA2 = ld_a(kChunk);",
                 "constexpr int kLdW1 = ld_b(kChunk);"):
        assert line in mma, line
    flat = re.sub(r"\s+", " ", chain)
    for line in ("inline int map_ld(int c) { return mma::ld_a(pad8(c)); }",
                 "return pad8(c) * mma::kLdW1 + mma::kChunk * "
                 "mma::ld_b(pad8(p)) + mma::kVec;",
                 "s.h1 = (oh + 2) * (ow + 2) * mma::kLdH;",
                 "s.h2 = npix16 * mma::kLdA2;", "s.tab = npix16;",
                 "((size_t)map0 + map1 + h1 + h2 + tab + 2 * buf)",
                 "window_smem(s, th + 2 * a.nb - 2, tw + 2 * a.nb - 2);",
                 "m = std::max(m, pix * map_ld(c));",
                 "s.map0 = s.map1 = (rows + 2) * (a.w + 2) * ld;",
                 "window_smem(s, th, tw);"):
        assert line in flat, line


def _ld_a(k):
    return (k + 3) // 8 * 8 + 4


def _ld_b(n):
    return (n + 7) // 16 * 16 + 8


def _pad8(c):
    return -(-c // 8) * 8


def _rest(widths, oh, ow):
    """Bytes besides the maps: the halo [nq][40], the dw output
    [npix16][ld_a(32)], an int table [npix16], two chunk buffers."""
    npix16 = -(-oh * ow // 16) * 16
    buf = max(_pad8(c) * _ld_b(32) + 32 * _ld_b(_pad8(p)) + 13 * 32
              for c, _, p in widths)
    return 4 * ((oh + 2) * (ow + 2) * 40 + npix16 * _ld_a(32) + npix16
                + 2 * buf)


def cascade_bytes(widths, th, tw):
    k, maps = len(widths), [0, 0]
    chans = [widths[0][0]] + [p for _, _, p in widths]
    for j in range(k + 1):
        r = k - j
        maps[j % 2] = max(maps[j % 2], (th + 2 * r) * (tw + 2 * r)
                          * _ld_a(_pad8(chans[j])))
    return 4 * sum(maps) + _rest(widths, th + 2 * k - 2, tw + 2 * k - 2)


def mega_bytes(widths, h, w, th, tw, cluster):
    ld = max(_ld_a(_pad8(c)) for c in
             [c for c, _, _ in widths] + [widths[-1][2]])
    rows = -(-h // cluster)
    return 4 * 2 * (rows + 2) * (w + 2) * ld + _rest(widths, th, tw)


def test_layout_mirror_equals_the_cuh(xl_chains):
    """``cascade_smem`` and ``mega_smem`` equal the layout above at every
    tile of every xl chain (up to 12 x 12), and every chain fits at the
    wrappers' tiles (K5 at both cluster sizes, which covers every batch)."""
    for (blob, bps), name in zip(xl_chains, CHAIN_IDS):
        widths = bf._widths(bps)
        for th in range(1, min(blob.h, 12) + 1):
            for tw in range(1, min(blob.w, 12) + 1):
                if name.startswith("K4"):
                    assert bf.cascade_smem(widths, th, tw) == \
                        cascade_bytes(widths, th, tw), (name, th, tw)
                else:
                    for cl in (1, 2):
                        if th <= -(-blob.h // cl):
                            assert bf.mega_smem(
                                widths, blob.h, blob.w, th, tw, cl) == \
                                mega_bytes(widths, blob.h, blob.w, th, tw,
                                           cl), (name, th, tw, cl)
        if name.startswith("K4"):
            th, tw = bf.check_chain_fits(blob.h, blob.w, bps)
            assert cascade_bytes(widths, th, tw) <= bf.MAX_SMEM
            continue
        for cl in (1, 2):
            th, tw = bf.check_chain_fits(blob.h, blob.w, bps, True, cl)
            assert mega_bytes(widths, blob.h, blob.w, th, tw, cl) <= \
                bf.MAX_SMEM


def test_xl_chain_layouts(xl_chains):
    """The tiles and bytes the wrappers take: the 10x10 three-block group
    (5, 10) at 228,576 bytes, near the 232,448 a CTA has; K5 at a cluster
    of two (5, 10) rows of 150,784 bytes a CTA (an H100's 132 SMs take it
    at batch 64), at one CTA an image the whole 10x10 map in 215,488."""
    (_, g84), (_, run) = xl_chains[5], xl_chains[-1]
    assert bf.check_chain_fits(10, 10, g84) == (5, 10)
    assert bf.cascade_smem(bf._widths(g84), 5, 10) == 228576
    w = bf._widths(run)
    assert bf.mega_cluster(10, 64, 132) == 2
    assert bf.check_chain_fits(10, 10, run, True, 2) == (5, 10)
    assert bf.mega_smem(w, 10, 10, 5, 10, 2) == 150784
    assert bf.check_chain_fits(10, 10, run, True, 1) == (10, 10)
    assert bf.mega_smem(w, 10, 10, 10, 10, 1) == 215488


@pytest.mark.parametrize("sms", [132, 114], ids=["sxm", "pcie"])
def test_mega_cluster_follows_the_batch(sms):
    """Two CTAs an image while all of them fit one wave of the card's SMs
    (an H100 SXM's 132, a PCIe card's 114), else one; never more CTAs
    than rows."""
    half = sms // 2
    assert bf.mega_cluster(10, 1, sms) == bf.mega_cluster(10, half, sms) == 2
    assert bf.mega_cluster(10, half + 1, sms) == \
        bf.mega_cluster(10, 256, sms) == 1
    assert bf.mega_cluster(1, 1, sms) == 1


def test_bench_chain_inputs_are_xl_chains():
    """The A/B tool times the chains that the paths launch."""
    from ffcnn_tpu_torch import bench_chain
    cs = bench_chain.chains("cpu")
    assert [name for name, _, _ in cs] == \
        [f"K4 {g}" for g in XL_CHAINS[:-1]] + ["K5 84-108"]


def test_halo_work_of_the_xl_groups(xl_chains):
    """The halo work that phase 6 prints beside each K4 group: above 1 at
    every group's tile, and 1 where one tile spans a one-block chain's
    whole map, with no halo to recompute."""
    for (blob, bps), name in zip(xl_chains[:-1], CHAIN_IDS):
        tile = bf.check_chain_fits(blob.h, blob.w, bps)
        assert 1.0 < chip_smoke.halo_work(bf, blob.h, blob.w, bps,
                                          tile) < 3.0, name
    blob, bps = xl_chains[-1]
    assert chip_smoke.halo_work(bf, blob.h, blob.w, bps[:1],
                                (blob.h, blob.w)) == 1.0


def test_integer_tf32_rounding_equals_the_emulated_one():
    """K4 and K5 round the TF32 parts with (bits + 0x1000) & 0xFFFFE000;
    on finite values of either sign, normal, subnormal, at ties and at the
    top of a binade, that is the rounding the emulation (and cvt.rna)
    gives."""
    assert "return (__float_as_uint(v) + 0x1000u) & 0xFFFFE000u;" in \
        _cuh("tf32_mma.cuh")
    rng = np.random.RandomState(7)
    one, ulp = 1.0, 2.0 ** -10
    v = np.concatenate([
        rng.randn(20000) * 10.0 ** rng.randint(-30, 30, 20000),
        [one + ulp / 2, -(one + ulp / 2), one + ulp / 4, 2 - ulp / 4, 0.0,
         -0.0, 1e-40, -3e-39, 3.4e38]]).astype(np.float32)
    t = torch.from_numpy(v)
    bits = t.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    got = (((bits + 0x1000) & 0xFFFFE000) - ((bits + 0x1000) & 0x80000000) * 2)
    got = got.to(torch.int32).view(torch.float32)
    assert torch.equal(got.view(torch.int32), tf32(t).view(torch.int32))
