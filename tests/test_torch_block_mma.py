"""The numeric scheme of K1 and K3 (``csrc/block_mma.cuh``), on the CPU: both
pointwise products in 3xTF32 on the tensor cores.  Each float32 operand a
is split into big = tf32(a) and small = tf32(a - big) (TF32: the float32
mantissa rounded to 10 bits, nearest, ties away from zero, as
``cvt.rna.tf32.f32`` rounds), and the products sum small*big + big*small +
big*big in float32.  Emulated in plain torch at every block geometry of
yolo-fastest-xl's region plan (the 8 geometries K1 is checked at on the
card, and K3's 4) and of ffcnn-micro's, it stays within a quarter of the
float32 tolerance that ``chip_smoke.py`` holds the kernels to; one TF32
pass does not meet that tolerance, which is why the split is there.  Also
pinned: the activation instances and the shared memory of the kernel's
layout for every block the planner yields on ``models/*.cfg``."""

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
from ffcnn_tpu_torch.testing import cap_threads

cap_threads()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFGS = sorted(glob.glob(os.path.join(REPO, "models", "*.cfg")))
XL = os.path.join(REPO, "models", "yolo-fastest-xl.cfg")
MICRO = os.path.join(REPO, "models", "ffcnn-micro.cfg")
# the product code K1, K3, K4 and K5 share: the activation instances and
# the chunk constants
MMA_CUH = os.path.join(REPO, "ffcnn_tpu_torch", "csrc", "tf32_mma.cuh")
F32_TOL = chip_smoke.KERNEL_TOL["float32"]
# xl's blocks as chip_smoke.py phase 3 checks them: K1 at the default
# path's three geometries and the region path's five others, K3 at its four
XL_K1 = (38, 61, 84, 1, 4, 12, 25, 35)
XL_K3 = (9, 22, 58, 81)


def tf32(t: torch.Tensor) -> torch.Tensor:
    """Float32 rounded to TF32 (10 mantissa bits), nearest, ties away."""
    bits = t.contiguous().view(torch.int32)
    mag = ((bits & 0x7FFFFFFF) + 0x1000) & ~0x1FFF
    return (mag | (bits & -0x80000000)).view(torch.float32)


def mm_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    ab, bb = tf32(a), tf32(b)
    asm, bsm = tf32(a - ab), tf32(b - bb)
    return asm @ bb + ab @ bsm + ab @ bb


def mm_1xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return tf32(a) @ tf32(b)


def test_tf32_rounding():
    """Nearest on the 10-bit mantissa, ties away from zero, both signs."""
    one = 1.0
    ulp = 2.0 ** -10
    x = torch.tensor([one + ulp / 4, one + ulp / 2, one + 3 * ulp / 4,
                      -(one + ulp / 2), 3.0, 0.0], dtype=torch.float32)
    want = torch.tensor([one, one + ulp, one + ulp, -(one + ulp), 3.0, 0.0])
    assert torch.equal(tf32(x), want)
    # the split keeps about 2^-21 of a float32 value
    v = torch.from_numpy(np.random.RandomState(0).randn(10000).astype(
        np.float32))
    big = tf32(v)
    rest = (v.double() - big.double() - tf32(v - big).double()).abs()
    assert (rest <= 2.0 ** -21 * v.double().abs()).all()


def _blocks(cfg, size, starts=None):
    """[(start, down, NetIR blob, BlockParams)] of the cfg's region plan
    (every block of min_channels 1 with the stride-2 blocks), synthesized
    weights (seed 42), in plan order or in the order of ``starts``."""
    ir = parse_cfg(cfg, size, size)
    params = params_from_numpy(load_weights(ir, synth_weights_bytes(
        ir, seed=42, obj_bias=2.0))[0])
    found = {b.start: (b.start, b.down, ir.blobs[b.start],
                       bf.block_params(ir, params, b))
             for r in bf.plan_runs(ir, min_channels=1, allow_down=True)
             for b in r.blocks}
    return [found[s] for s in (starts or sorted(found))]


@pytest.fixture(scope="module")
def xl_blocks():
    return _blocks(XL, 320, XL_K1 + XL_K3)


@pytest.fixture(scope="module")
def micro_blocks():
    return _blocks(MICRO, 0)


def _errors(block, dtype, seed):
    """max |emulated - plain| / range of the block's float32 output, for
    3xTF32 and for one TF32 pass, on a batch-2 input in ``dtype``."""
    _, down, blob, bp = block
    x = torch.from_numpy(np.random.RandomState(seed).randn(
        2, blob.h, blob.w, blob.c).astype(np.float32)).to(dtype)
    stride = 2 if down else 1
    want = (bf.block_down_plain if down else bf.block_plain)(
        x, bp, torch.float32)
    scale = want.abs().max().item()
    return tuple((bf._block_f32(x, bp, stride, mm) - want).abs().max().item()
                 / scale for mm in (mm_3xtf32, mm_1xtf32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("index", range(len(XL_K1 + XL_K3)),
                         ids=[f"{'K3' if s in XL_K3 else 'K1'}-{s}"
                              for s in XL_K1 + XL_K3])
def test_3xtf32_meets_the_float32_tolerance_xl(xl_blocks, index, dtype):
    err3, _ = _errors(xl_blocks[index], dtype, seed=index)
    assert err3 <= F32_TOL / 4, err3


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
def test_3xtf32_meets_the_float32_tolerance_micro(micro_blocks, dtype):
    assert micro_blocks
    for i, block in enumerate(micro_blocks):
        err3, _ = _errors(block, dtype, seed=100 + i)
        assert err3 <= F32_TOL / 4, (block[0], err3)


def test_one_tf32_pass_misses_the_tolerance(xl_blocks):
    """One TF32 pass per product misses KERNEL_TOL float32 on xl's blocks:
    the reason for the split."""
    errs = [_errors(b, torch.float32, seed=i)[1]
            for i, b in enumerate(xl_blocks)]
    assert min(errs) > F32_TOL, errs


def _cuh_instances():
    """The kernels' compile-time activation instances, (act1, act2, act3,
    res_act), read from FFCNN_BLOCK_ACT_INSTANCES."""
    text = open(MMA_CUH).read()
    body = text[text.index("#define FFCNN_BLOCK_ACT_INSTANCES"):]
    body = body[:body.index("namespace mma")]
    return tuple(tuple(int(v) for v in m) for m in re.findall(
        r"X\((-?\d+), (-?\d+), (-?\d+), (-?\d+)\)", body))


INSTANCES = _cuh_instances()


def act_instance(acts, residual, res_act):
    """The compile-time instance a block launches (None: the runtime-switch
    instance), as ``launch_acts`` in block_mma.cuh and ``read_chain`` in
    block_chain.cuh pick it; res_act is not read without a residual."""
    for inst in INSTANCES:
        if tuple(acts) == inst[:3] and (not residual or res_act == inst[3]):
            return inst
    return None


def block_smem(c, p, th, tw, stride=1):
    """Bytes of shared memory K1 (stride 1) or K3 (stride 2) takes, as
    ``smem_floats`` in block_mma.cuh lays it out: the halo (16-row slabs, C
    padded to 8), one 32-channel chunk's expand output and split depthwise
    output, the output pixels' tap offsets and two chunk buffers."""
    def ld_a(k):
        return (k + 3) // 8 * 8 + 4

    def ld_b(n):
        return (n + 7) // 16 * 16 + 8
    chunk, hw = 32, stride * tw + 3 - stride
    nq = (stride * th + 3 - stride) * hw
    cp8, pn = -(-c // 8) * 8, -(-min(p, 128) // 8) * 8
    return 4 * (-(-nq // 16) * 16 * ld_a(cp8) + nq * (chunk + 8)
                + 2 * 64 * ld_a(chunk) + 64
                + 2 * (cp8 * ld_b(chunk) + chunk * ld_b(pn) + 13 * chunk))


def test_the_kernel_fixes_xl_and_micro_activations():
    assert INSTANCES == ((2, 2, 0, 0), (1, 2, 0, 2))
    assert "constexpr int kChunk = 32;" in open(MMA_CUH).read()


@pytest.mark.parametrize("cfg_path", CFGS, ids=[
    os.path.splitext(os.path.basename(p))[0] for p in CFGS])
def test_every_planned_block_has_an_instance_and_fits(cfg_path):
    """Every block that plan_runs yields on the cfg (any min_channels, with
    and without stride-2 blocks, at its own size and at 416) launches an
    instance with its activations fixed at compile time, and its tile's
    layout fits a CTA's shared memory."""
    for size in (0, 416):
        ir = parse_cfg(cfg_path, size, size)
        for minc in (1, 8, 16, 24):
            for down in (False, True):
                for r in bf.plan_runs(ir, minc, down):
                    for b in r.blocks:
                        acts = tuple(ir.layers[b.start + i].activation
                                     for i in range(3))
                        assert act_instance(acts, b.residual,
                                               b.res_act) is not None, \
                            (cfg_path, b, acts)
                        blob, s = ir.blobs[b.start], 2 if b.down else 1
                        th, tw = bf.pick_tile(blob.h // s, blob.w // s, s)
                        p = ir.layers[b.start + 2].fn
                        assert block_smem(blob.c, p, th, tw, s) <= \
                            bf.MAX_SMEM, (cfg_path, b)


def test_act_instance_falls_back_to_the_runtime_switch():
    assert act_instance((2, 2, 0), False, 7) == (2, 2, 0, 0)
    assert act_instance((2, 2, 0), True, 0) == (2, 2, 0, 0)
    assert act_instance((2, 2, 0), True, 2) is None
    assert act_instance((1, 2, 0), True, 2) == (1, 2, 0, 2)
    assert act_instance((6, 2, 0), False, 0) is None


def test_block_smem_of_xl_region_blocks(xl_blocks):
    """The widest of xl's blocks (10x10 C96 P96, tile 5x10, an 84-pixel
    halo) takes 131,200 bytes; the 160x160 ones leave room for four CTAs
    on an SM (228 KB, 1 KB more a CTA)."""
    sizes = {}
    for start, down, blob, bp in xl_blocks:
        s = 2 if down else 1
        th, tw = bf.pick_tile(blob.h // s, blob.w // s, s)
        sizes[start] = block_smem(blob.c, bp.w2.shape[1], th, tw, s)
    assert sizes[84] == 131200
    assert max(sizes.values()) <= bf.MAX_SMEM
    assert 4 * (max(sizes[1], sizes[4]) + 1024) <= 233472
