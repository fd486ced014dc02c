"""The tensor-core block body with rounding points
(``csrc/block_round_mma.cuh``) on the CPU: K8 (``csrc/mbconv.cu``), K9
(``csrc/mbconv_cs.cu``) and P3's pwonly and fullbf16
(``csrc/block_variants.cu``) run their pointwise products on the tensor
cores, float32 weights split into TF32 big = tf32(w) (nearest, ties away
from zero, as ``cvt.rna.tf32.f32``) and small = tf32(w - big), an operand
that is a bf16 value taken whole (it is exact in TF32), and fullbf16 with
bf16 storage as one bf16 m16n8k16 pass (bf16 operands, exact products,
float32 sums), as K9 in bf16 storage runs both its products.  The products are emulated in plain torch at the policy's
rounding points (the plain versions' own code, ``_mbconv_f32``,
``_mbconv_cs_f32`` and ``_block_f32``, with the emulated product in place
of ``torch.matmul``),
and the emulation holds the plain versions within a quarter of the
tolerance ``chip_smoke.py`` holds the kernels to (before the final
rounding to the storage type, which both do alike; after it, within the
whole tolerance): K8 at the block bench's
seven configs (H and W divided by 5, batch 2) and at every geometry of
xl's 24 region blocks (batch 2), K9 at the five stride-1 configs (the
same cut), every geometry of xl's 20 stride-1 blocks and one linear
depthwise, P3 at the bisection's four geometries (batch 2; the 160x160 map
cut to 40x40).  Also pinned: the instance tables and the shared memory of
the body's layout for every K8 and K9 case of the bench and every P3
geometry, and the tap modes' band contract."""

import dataclasses
import functools
import os
import re

import numpy as np
import pytest
import torch

import chip_smoke
from ffcnn_tpu_torch import bench_block as bb
from ffcnn_tpu_torch import bisect_smallc as bs
from ffcnn_tpu_torch.darknet import parse_cfg
from ffcnn_tpu_torch.kernels import block_fused as bf
from ffcnn_tpu_torch.kernels import block_variants as bv
from ffcnn_tpu_torch.kernels import mbconv as k8
from ffcnn_tpu_torch.kernels import mbconv_cs as k9
from ffcnn_tpu_torch.testing import cap_threads

cap_threads()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(REPO, "ffcnn_tpu_torch", "csrc")
CUH = os.path.join(CSRC, "block_round_mma.cuh")
TOL = chip_smoke.MBCONV_TOL
LEAKY, LINEAR = bb.LEAKY, bb.LINEAR


def tf32(t: torch.Tensor) -> torch.Tensor:
    """Float32 rounded to TF32 (10 mantissa bits), nearest, ties away."""
    bits = t.contiguous().view(torch.int32)
    mag = ((bits & 0x7FFFFFFF) + 0x1000) & ~0x1FFF
    return (mag | (bits & -0x80000000)).view(torch.float32)


def is_bf16(t: torch.Tensor) -> bool:
    return torch.equal(t, t.to(torch.bfloat16).float())


def mm_tf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The body's TF32 product: every pair of parts but small * small
    (a part that is 0, as a bf16 value's small part is, adds nothing)."""
    ab, bb_ = tf32(a), tf32(b)
    asm, bsm = tf32(a - ab), tf32(b - bb_)
    return asm @ bb_ + ab @ bsm + ab @ bb_


def mm_bf16(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One bf16 m16n8k16 pass: both operands bf16 values, so every
    product is exact in float32 and only the float32 sums round."""
    assert is_bf16(a) and is_bf16(b)
    return a @ b


def mm_1xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return tf32(a) @ tf32(b)


def rel(got: torch.Tensor, want: torch.Tensor) -> float:
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max()).item()


def test_tf32_split_of_a_bf16_value_is_whole():
    """A bf16 value is exact in TF32: its small part is 0, so against
    split weights it takes two passes, and against bf16 weights one."""
    v = torch.from_numpy(np.random.RandomState(0).randn(4096).astype(
        np.float32)).to(torch.bfloat16).float()
    assert torch.equal(tf32(v), v)
    assert torch.equal(tf32(v - tf32(v)), torch.zeros_like(v))


# ------------------------------------------------------------------- K8
@functools.cache
def _xl_geometries():
    """One bench case for each distinct (H, W, C, E, P, stride) of xl's
    region blocks, batch 2 (the bench's part (b) draws and weights)."""
    seen, out = set(), []
    for c in bb.cases_xl(torch.device("cpu"), batch=2):
        key = (*c.x.shape[1:], c.k8[0].shape[1], c.k8[6].shape[1], c.stride)
        if key not in seen:
            seen.add(key)
            out.append(c)
    return out


@pytest.fixture(scope="module")
def k8_cases():
    return bb.cases_configs(torch.device("cpu"), 2, 5) + _xl_geometries()


K8_IDS = ([f"config{i}" for i in range(len(bb.CONFIGS))]
          + [f"xl{i}" for i in range(12)])


def _k8_emulated(c, dtype, matmul):
    """(emulated, plain) before the final rounding to ``dtype`` (both
    round there alike; see ``test_k8_emulation_...``), and the plain
    version's output."""
    x = c.x.to(dtype)
    res = None if c.res is None else c.res.to(dtype)
    args = (x, *c.k8, res, c.stride, c.residual, c.act_mid, c.act_out)
    plain = k8.fused_mbconv_plain(x, *c.k8, res, stride=c.stride,
                                  residual=c.residual, act_mid=c.act_mid,
                                  act_out=c.act_out)
    return k8._mbconv_f32(*args, matmul), k8._mbconv_f32(*args), plain


def test_k8_cases_cover_the_bench(k8_cases):
    """The seven configs and the twelve geometries of xl's 24 blocks (both
    strides)."""
    assert len(k8_cases) == len(K8_IDS)
    assert {c.stride for c in k8_cases[len(bb.CONFIGS):]} == {1, 2}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("index", range(len(K8_IDS)), ids=K8_IDS)
def test_k8_emulation_meets_a_quarter_of_the_tolerance(k8_cases, index,
                                                       dtype):
    """Held before the final rounding to x's dtype, which the kernel and
    the plain version do alike: a value that the two sum orders put on
    either side of a bf16 rounding edge lands one ulp (up to 2^-7 of the
    range) apart there, what the rest of the tolerance allows.  The
    rounded output then stays within the whole tolerance."""
    got, want, plain = _k8_emulated(k8_cases[index], dtype, mm_tf32)
    tol = TOL[str(dtype)[6:]]
    assert got.dtype == want.dtype == torch.float32
    assert torch.equal(want.to(dtype), plain)
    assert rel(got, want) <= tol / 4
    assert rel(got.to(dtype), plain) <= tol


def test_k8_one_tf32_pass_misses_the_float32_tolerance(k8_cases):
    """One TF32 pass a product misses MBCONV_TOL float32 on the bench's
    blocks: the reason for the split."""
    errs = [rel(*_k8_emulated(c, torch.float32, mm_1xtf32)[:2])
            for c in k8_cases]
    assert min(errs) > TOL["float32"], errs


# ------------------------------------------------------------------- K9
@pytest.fixture(scope="module")
def k9_cases():
    """The five stride-1 configs (H and W divided by 5, batch 2), one case
    for each geometry of xl's 20 stride-1 blocks (batch 2), and the 40x40
    config again with a linear depthwise."""
    cases = [c for c in bb.cases_configs(torch.device("cpu"), 2, 5)
             if c.k9 is not None]
    cases += [c for c in _xl_geometries() if c.k9 is not None]
    weights, kw = cases[2].k9
    cases.append(dataclasses.replace(
        cases[2], k9=(weights, {**kw, "act_dw": k9.LINEAR})))
    return cases


K9_IDS = ([f"config{i}" for i in range(5)] + [f"xl{i}" for i in range(8)]
          + ["config2_linear_dw"])


def _k9_emulated(c, dtype, matmul):
    """(emulated, plain before its final rounding, plain), as
    ``_k8_emulated``."""
    weights, kw = c.k9
    x = c.x_cs.to(dtype)
    res = None if c.res_cs is None else c.res_cs.to(dtype)
    args = (x, *weights, res, kw["H"], kw["W"], kw["act_mid"], kw["act_dw"],
            kw["act_out"])
    return (k9._mbconv_cs_f32(*args, matmul), k9._mbconv_cs_f32(*args),
            k9.fused_mbconv_cs_plain(x, *weights, res, **kw))


def test_k9_cases_cover_the_bench(k9_cases):
    """The five stride-1 configs, the eight geometries of xl's 20 stride-1
    blocks, and a linear depthwise."""
    assert len(k9_cases) == len(K9_IDS)
    assert all(c.stride == 1 for c in k9_cases)
    assert {c.k9[1]["act_dw"] for c in k9_cases} == {k9.LEAKY, k9.LINEAR}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("index", range(len(K9_IDS)), ids=K9_IDS)
def test_k9_emulation_meets_a_quarter_of_the_tolerance(k9_cases, index,
                                                       dtype):
    """bf16 storage: one m16n8k16 pass a product (``mm_bf16`` asserts that
    every operand, x, the weights and the rounded depthwise output, is a
    bf16 value, so the products are exact); float32: 3xTF32.  Held before
    the final rounding to x's dtype, then the rounded output within the
    whole tolerance, as K8."""
    mm = mm_bf16 if dtype == torch.bfloat16 else mm_tf32
    got, want, plain = _k9_emulated(k9_cases[index], dtype, mm)
    tol = TOL[str(dtype)[6:]]
    assert got.dtype == want.dtype == torch.float32
    assert torch.equal(want.to(dtype), plain)
    assert rel(got, want) <= tol / 4
    assert rel(got.to(dtype), plain) <= tol


def test_k9_one_tf32_pass_misses_the_float32_tolerance(k9_cases):
    """As for K8: one TF32 pass a product is not enough in float32."""
    errs = [rel(*_k9_emulated(c, torch.float32, mm_1xtf32)[:2])
            for c in k9_cases]
    assert min(errs) > TOL["float32"], errs


# ------------------------------------------------------------------- P3
P3_GEOMS = [(label, min(h, 40), min(w, 40), c, e)
            for label, h, w, c, e in bs.GEOMS]


@pytest.fixture(scope="module")
def p3_geoms():
    rng = np.random.RandomState(0)
    return [bs.make_geom(g, 2, torch.float32, rng, torch.device("cpu"))
            for g in P3_GEOMS]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["pwonly", "fullbf16"])
@pytest.mark.parametrize("index", range(len(bs.GEOMS)),
                         ids=[g[0] for g in bs.GEOMS])
def test_p3_emulation_meets_a_quarter_of_the_tolerance(p3_geoms, index,
                                                       mode, dtype):
    """pwonly: split TF32 (its expand feeds the projection unrounded);
    fullbf16: TF32 with bf16 weights in float32 storage, one bf16 pass in
    bf16 storage.  Held before the final rounding to the storage type, as
    K8 is, then the rounded output within the whole tolerance."""
    g = p3_geoms[index]
    x = g.x0.to(dtype)
    mm = mm_bf16 if mode == "fullbf16" and dtype == torch.bfloat16 \
        else mm_tf32
    plain = bv.variant_plain(mode, x, g.vp)
    want = bv._block_f32(mode, x, g.vp)
    got = bv._block_f32(mode, x, g.vp, mm)
    tol = chip_smoke.p3_tols(mode)[str(dtype)[6:]]
    assert torch.equal(want.to(dtype), plain)
    assert rel(got, want) <= tol / 4
    assert rel(got.to(dtype), plain) <= tol


# ------------------------------------------- instances and shared memory
def _cuh_table(name):
    m = re.search(rf"constexpr int {name}\[\d*\] = \{{([^}}]*)\}};",
                  open(CUH).read())
    return tuple(int(v) for v in m.group(1).split(","))


K8_NJ, K9_NJ, P3_NJ, K8_ACTS, K9_ACTS = (
    _cuh_table(n) for n in ("kK8Nj", "kK9Nj", "kP3Nj", "kK8Acts",
                            "kK9Acts"))


def _ld_a(k):
    return (k + 3) // 8 * 8 + 4


def _ld_b(n):
    return (n + 7) // 16 * 16 + 8


def round_smem(c, p, th, tw, stride=1, dw=True, m16=False, cs=False):
    """Bytes of shared memory the body takes, as ``smem_floats`` in
    block_round_mma.cuh lays it out: the halo (16-row slabs; C padded to
    the K step, 8, or 16 in the bf16 form; without the depthwise stage the
    tile's own pixels), the expand output (with the depthwise stage), the
    projection's A operand big and small, the output pixels' tap offsets
    and two chunk buffers (w1, w2 and 13 x 32 vectors; under ``cs`` K9's
    weight rows, bf16 in the bf16 form), and under ``cs`` at least the
    channel-major output tile."""
    chunk = 32
    cpk = -(-c // (16 if m16 else 8)) * (16 if m16 else 8)
    pn = -(-min(p, 128) // 8) * 8
    if dw:
        hw = stride * tw + 3 - stride
        nq = (stride * th + 3 - stride) * hw
    else:
        nq = th * tw
    ld_x = _ld_b(cpk) if m16 else _ld_a(cpk)
    ld_d = _ld_b(chunk) if m16 else _ld_a(chunk)
    ld_w1 = _ld_a(chunk) if m16 else _ld_b(chunk)
    ld_w2 = _ld_a(pn) if m16 else _ld_b(pn)
    if cs:   # [32][ld(cpk)] and [pn][ld(32)], half a float an element in bf16
        ld = _ld_b if m16 else _ld_a
        weights = (chunk * ld(cpk) + pn * ld(chunk)) // (2 if m16 else 1)
    else:
        weights = cpk * ld_w1 + chunk * ld_w2
    body = (-(-nq // 16) * 16 * ld_x + (nq * (chunk + 8) if dw else 0)
            + 2 * 64 * ld_d + 64 + 2 * (weights + 13 * chunk))
    return 4 * max(body, pn * _ld_a(th * tw) if cs else 0)


def instance(table, p):
    """The n8 tiles a warp holds in the instance a launch takes: the
    smallest of ``table`` that holds half the widest CTA's tiles (None:
    none does)."""
    need = (-(-min(p, 128) // 8) + 1) // 2
    return next((nj for nj in table if nj >= need), None)


def _k8_shapes():
    """(H, W, C, E, P, stride, acts) of every K8 case of the block bench:
    the tool's configs and every block of xl's region plan at 320x320."""
    out = [(h, w, c, e, p, s, (LEAKY, LINEAR))
           for _, h, w, c, e, p, s, _ in bb.CONFIGS]
    ir = parse_cfg(bb.XL, 320, 320)
    for run in bf.plan_runs(ir, min_channels=8, allow_down=True):
        for b in run.blocks:
            blob = ir.blobs[b.start]
            acts = (ir.layers[b.start].activation,
                    ir.layers[b.start + 2].activation)
            out.append((blob.h, blob.w, blob.c, ir.layers[b.start].fn,
                        ir.layers[b.start + 2].fn, 2 if b.down else 1, acts))
    return out


def _k9_shapes():
    """(H, W, C, E, P, acts) of every K9 case of the block bench: the
    tool's five stride-1 configs and xl's 20 stride-1 region blocks at
    320x320, acts as (expand, depthwise, project)."""
    out = [(h, w, c, e, p, (LEAKY, LEAKY, LINEAR))
           for _, h, w, c, e, p, s, _ in bb.CONFIGS if s == 1]
    ir = parse_cfg(bb.XL, 320, 320)
    for run in bf.plan_runs(ir, min_channels=8, allow_down=True):
        for b in run.blocks:
            if b.down:
                continue
            blob = ir.blobs[b.start]
            acts = tuple(ir.layers[b.start + k].activation for k in range(3))
            out.append((blob.h, blob.w, blob.c, ir.layers[b.start].fn,
                        ir.layers[b.start + 2].fn, acts))
    return out


def test_the_instance_tables():
    assert K8_NJ == (1, 2, 4, 8) and P3_NJ == (1, 2, 8)
    assert K9_NJ == (1, 2, 3, 6)
    assert K8_ACTS == (LEAKY, LINEAR)
    assert K9_ACTS == (LEAKY, LEAKY, LINEAR)
    assert "constexpr int kNjMax = (kOG / 8 + 1) / 2;" in open(CUH).read()
    assert "constexpr int kChunk = 32;" in open(
        os.path.join(CSRC, "tf32_mma.cuh")).read()
    assert instance(K8_NJ, 48) == 4 and instance(P3_NJ, 48) == 8
    assert instance(K8_NJ, 8) == instance(P3_NJ, 16) == 1


def test_every_k8_case_has_an_instance_and_fits():
    """The bench's 31 K8 cases: activations fixed at compile time, an n8
    instance, and pick_tile's tile within a CTA's shared memory."""
    shapes = _k8_shapes()
    assert len(shapes) == 31
    for h, w, c, e, p, s, acts in shapes:
        assert tuple(acts) == K8_ACTS, (h, w, c, e, p, s, acts)
        assert instance(K8_NJ, p) is not None
        th, tw = bf.pick_tile(h // s, w // s, s)
        assert round_smem(c, p, th, tw, s) <= bv.MAX_SMEM, (h, w, c, p, s)


@pytest.mark.parametrize("m16", [False, True], ids=["tf32", "bf16"])
def test_every_k9_case_has_an_instance_and_fits(m16):
    """The bench's 25 K9 cases in either storage: the activations of the
    compiled instances, an n8 instance of kK9Nj (the tiles need 1, 2, 3 or
    6), and pick_tile's tile within a CTA's shared memory in K9's layout."""
    shapes = _k9_shapes()
    assert len(shapes) == 25
    needs = set()
    for h, w, c, e, p, acts in shapes:
        assert tuple(acts) == K9_ACTS, (h, w, c, e, p, acts)
        needs.add((-(-min(p, 128) // 8) + 1) // 2)
        assert instance(K9_NJ, p) is not None, p
        th, tw = bf.pick_tile(h, w)
        assert round_smem(c, p, th, tw, m16=m16, cs=True) <= bv.MAX_SMEM
    assert needs == set(K9_NJ)


def test_round_smem_of_k9():
    """xl's widest K9 block takes less than K8's layout of it (bf16 weight
    rows); the 160x160 C8 P4 config is held up by its output tile."""
    th, tw = bf.pick_tile(10, 10)
    assert round_smem(96, 96, th, tw, m16=True, cs=True) < round_smem(
        96, 96, th, tw, m16=True)
    th, tw = bf.pick_tile(160, 160)
    assert round_smem(8, 4, th, tw, cs=True) >= 4 * 8 * _ld_a(th * tw)


@pytest.mark.parametrize("m16", [False, True], ids=["tf32", "bf16"])
def test_every_p3_geometry_has_an_instance_and_fits(m16):
    """pwonly (no halo) and fullbf16 (in either form) at the bisection's
    geometries, on pick_tile's tiles."""
    for _, h, w, c, _ in bs.GEOMS:
        th, tw = bf.pick_tile(h, w)
        assert instance(P3_NJ, c) is not None
        assert round_smem(c, c, th, tw, dw=False) <= bv.MAX_SMEM
        assert round_smem(c, c, th, tw, m16=m16) <= bv.MAX_SMEM


def test_round_smem_of_xl_widest_block():
    """xl's 10x10 C96 E448 P96 block (tile 5x10, an 84-pixel halo) takes
    the same 131,200 bytes as in K1, whose layout the K8 policy keeps."""
    th, tw = bf.pick_tile(10, 10)
    assert (th, tw) == (5, 10)
    assert round_smem(96, 96, th, tw) == 131200
    # the bf16 form pads C to 16 and its strides to its fragment reads
    assert round_smem(8, 8, 8, 8, m16=True) > round_smem(8, 8, 8, 8)


# ------------------------------------------------ the tap modes' bands
def test_tap_smem_mirrors_the_kernel():
    src = open(os.path.join(CSRC, "block_variants.cu")).read()
    assert "const int halo = mode == kCopy ? 0 : 2;" in src
    assert "(isz + (mode == kDwOnly && isz == 2 ? 4 : 0))" in src
    assert bv.tap_smem(10, 160, 8, 2, "copy") == 10 * 160 * 8 * 2
    assert bv.tap_smem(10, 160, 8, 2, "dwonly") == 12 * 160 * 8 * 6
    assert bv.tap_smem(10, 160, 8, 4, "dwonly") == 12 * 160 * 8 * 4


@pytest.mark.parametrize("itemsize", [2, 4], ids=["bf16", "f32"])
@pytest.mark.parametrize("mode", bv.TAP_MODES)
def test_tap_bands_fit_and_cover_the_map(mode, itemsize):
    """At every bisection geometry the band is whole rows of the width,
    fits TAP_BAND_BYTES (or is one row), and the bands cover the map
    with at most one short band."""
    for _, h, w, c, e in bs.GEOMS:
        th, tw = bv.tile_of(mode, h, w, c, e, itemsize)
        assert tw == w and 1 <= th <= h
        smem = bv.tap_smem(th, w, c, itemsize, mode)
        assert smem <= bv.MAX_SMEM
        assert smem <= bv.TAP_BAND_BYTES or th == 1
        bands = -(-h // th)
        assert (bands - 1) * th < h <= bands * th
        # the even spread: no two bands differ by more than a row's worth
        assert bands * th - h < bands


def test_tap_contract_refuses_what_the_kernel_cannot_take():
    with pytest.raises(ValueError, match="multiple of 8"):
        bv.tile_of("dwonly", 16, 16, 12, 32, 2)
    with pytest.raises(ValueError, match="C <= E"):
        bv.tile_of("copy", 16, 16, 16, 8, 2)
    with pytest.raises(ValueError):
        bv.tile_of("full", 16, 16, 136, 256, 2)
    with pytest.raises(ValueError, match="does not fit"):
        bv.tile_of("dwonly", 4, 8192, 8, 8, 2)
    # the block modes keep pick_tile's tile and take any C up to 128
    assert bv.tile_of("pwonly", 20, 20, 12, 32, 2) == bf.pick_tile(20, 20)


def test_dwbf16_skipping_the_padding_columns_is_exact():
    """The tap kernel skips the taps of the columns outside the image and
    sums the zero-filled halo rows; in bf16 that gives the plain version's
    sums bit for bit (adding a zero product leaves a bf16 sum as it is)."""
    rng = np.random.RandomState(3)
    x = torch.from_numpy(rng.randn(1, 5, 6, 8).astype(np.float32)).to(
        torch.bfloat16)
    k = torch.from_numpy(rng.randn(3, 3, 8).astype(np.float32)).to(
        torch.bfloat16)
    xp = torch.nn.functional.pad(x, (0, 0, 0, 0, 1, 1))  # rows only
    acc = torch.zeros((1, 5, 6, 8), dtype=torch.bfloat16)
    for dy in range(3):
        for dx in range(3):
            lo, hi = max(0, 1 - dx), min(6, 7 - dx)   # columns in the image
            prod = xp[:, dy:dy + 5, lo + dx - 1:hi + dx - 1] * k[dy, dx]
            acc[:, :, lo:hi] = acc[:, :, lo:hi] + prod
    want = bv._taps(bv._pad(x), k, 5, 6, torch.bfloat16)
    assert torch.equal(acc, want)


def test_bench_round_needs_a_card():
    """``bench_round`` times the card's kernels and nothing else: without
    a card it exits before building anything."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from ffcnn_tpu_torch import bench_round
    with pytest.raises(SystemExit, match="needs a CUDA card"):
        bench_round.main([])
