"""The probe kernels of ``tools/`` (P1-P5) in the port: their plain
versions against the JAX side on the same seeded numpy inputs, and the
three probe CLIs end to end on the CPU at a small size.

* P1/P2 (``kernels/pw_matmul.py``): the tool's ``pallas_call`` bodies are
  local to its ``main()``, so each is rebuilt here with the tool's body and
  BlockSpecs (copied, not imported) and run in interpret mode.  bf16
  products are exact in float32; the sums run in another order: 1e-5 of
  the range.
* P3 (``kernels/block_variants.py``): every mode in float32 and bfloat16
  storage against ``tools/bisect_smallc.py::variant_step`` in interpret
  mode (``BISECT_INTERPRET=1``, as ``tests/test_bisect_smallc.py`` runs
  it), at n 8, 8x8, C 8, E 16.  ``copy``: exact.  float32: the same sums in
  another order, 1e-4 of the range.  bfloat16 storage, and ``fullbf16``
  (which rounds its expand and depthwise outputs to bf16): a value that the
  two sum orders put on either side of a bf16 rounding edge lands one ulp
  (2^-8) apart, and such a flip in an intermediate reaches the output
  through the taps and the projection, and XLA may keep bf16 chains in
  float32 on the CPU: 2^-6 of the range.
* P4/P5 (``kernels/mosaic_probes.py``): bit-exact, against the probe
  bodies of ``tools/retest_backend_bugs.py`` (copied) in interpret mode.
"""

import importlib.util
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu
import torch

from ffcnn_tpu_torch import bench_pw_kernels as tbp
from ffcnn_tpu_torch import bisect_smallc as tbs
from ffcnn_tpu_torch import retest_backend_bugs as trb
from ffcnn_tpu_torch.kernels import block_fused as bf
from ffcnn_tpu_torch.kernels import block_variants as bv
from ffcnn_tpu_torch.kernels import mosaic_probes as mp
from ffcnn_tpu_torch.kernels import pw_matmul as pw
from ffcnn_tpu_torch.testing import cap_threads

cap_threads()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = os.path.join(REPO, "tools")


# ----------------------------------------------------------------- P1, P2
def _kb(x_ref, w_ref, o_ref):
    """The body of ``kb`` and ``kc`` (tools/bench_pw_kernels.py:58-60,
    :82-84)."""
    o_ref[...] = jnp.dot(x_ref[...], w_ref[...],
                         preferred_element_type=jnp.float32)


def _pallas_pw(x, w, rows):
    """The tool's ``pallas_call`` (P1 :61-71 with 2,048-row blocks, P2
    :85-95 with 1,024) in interpret mode."""
    s, k = x.shape
    n = w.shape[1]
    return pl.pallas_call(
        _kb, grid=(s // rows,),
        in_specs=[pl.BlockSpec((rows, k), lambda i: (i, 0),
                               memory_space=pltpu.VMEM),
                  pl.BlockSpec((k, n), lambda i: (0, 0),
                               memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec((rows, n), lambda i: (i, 0),
                               memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((s, n), jnp.float32),
        interpret=True)(x, w)


def _tool_pw_inputs(batch, hw):
    """The tool's draws and packing (tools/bench_pw_kernels.py:40-80) at
    ``batch`` x ``hw`` x ``hw``."""
    rng = np.random.RandomState(0)
    x4 = jnp.asarray(rng.randn(batch, hw, hw, 8).astype(np.float32),
                     jnp.bfloat16)
    w = jnp.asarray(rng.randn(8, 32).astype(np.float32) * 0.2, jnp.bfloat16)
    s = batch * hw * hw
    wblk = np.zeros((128, 512), np.float32)
    wn = np.asarray(w, np.float32)
    for p in range(16):
        wblk[p * 8:(p + 1) * 8, p * 32:(p + 1) * 32] = wn
    return (x4.reshape(s, 8), w, x4.reshape(s // 16, 128),
            jnp.asarray(wblk, jnp.bfloat16))


@pytest.mark.parametrize("packed", [False, True], ids=["P1", "P2"])
def test_pw_matmul_plain_matches_pallas(packed):
    """S = 16,384 rows: P1's grid takes 8 of the tool's row blocks, P2's
    one.  The port draws the tool's inputs, and its product agrees."""
    x2, w, xp, wb = _tool_pw_inputs(4, 64)
    inp = tbp.make_inputs("cpu", batch=4, hw=64)
    for mine, tools in ((inp.x2, x2), (inp.w, w), (inp.xp, xp),
                        (inp.wb, wb)):
        np.testing.assert_array_equal(mine.float().numpy(),
                                      np.asarray(tools, np.float32))
    x, w_, rows, tx, tw = ((xp, wb, 1024, inp.xp, inp.wb) if packed
                           else (x2, w, 2048, inp.x2, inp.w))
    want = np.asarray(_pallas_pw(x, w_, rows))
    got = pw.pw_matmul(tx, tw)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


def test_pw_bounds():
    """At the tool's shapes: 26.2 MB of x and 209.7 MB of y at 3.35 TB/s
    bound both products (0.070 ms); P2's 13.4 GFLOP take 0.014 ms at the
    bf16 tensor-core peak."""
    s = 256 * 80 * 80
    x1 = torch.empty((s, 8), device="meta", dtype=torch.bfloat16)
    w1 = torch.empty((8, 32), device="meta", dtype=torch.bfloat16)
    x2 = torch.empty((s // 16, 128), device="meta", dtype=torch.bfloat16)
    w2 = torch.empty((128, 512), device="meta", dtype=torch.bfloat16)
    b1, b2 = tbp.work(x1, w1), tbp.work(x2, w2)
    assert b1.bytes == 2 * s * 8 + 2 * 8 * 32 + 4 * s * 32
    assert b2.tc_flop == 2 * (s // 16) * 128 * 512 == 16 * b1.tc_flop
    for work in (b1, b2):
        ms, by = work.bound()
        assert by == "bytes" and 0.070 < ms < 0.071
    assert 0.0135 < b2.tc_flop / 989e9 < 0.0137


# --------------------------------------------------------------------- P3
@pytest.fixture()
def bisect_tool(monkeypatch):
    monkeypatch.setenv("BISECT_INTERPRET", "1")
    monkeypatch.syspath_prepend(TOOLS)
    import bisect_smallc
    return bisect_smallc


def _p3_inputs(seed, n, hh, width, c, e):
    """x on the tool's (H, C, W*N) layout and the nine params in the
    tool's shapes, float32 numpy, drawn as the tool draws them."""
    rng = np.random.RandomState(seed)
    x = rng.randn(hh, c, width * n).astype(np.float32) * 0.25
    mk = lambda *sh: rng.randn(*sh).astype(np.float32) * 0.2
    col = lambda m: rng.rand(m, 1).astype(np.float32) * 0.5 + 0.5
    return x, (mk(e, c), col(e), col(e), mk(3, 3, e), col(e), col(e),
               mk(c, e), col(c), col(c))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", bv.MODES)
def test_block_variant_plain_matches_pallas(bisect_tool, mode, dtype):
    n, hh, width, c, e = 8, 8, 8, 8, 16
    x, p9 = _p3_inputs(bv.MODES.index(mode), n, hh, width, c, e)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = bisect_tool.variant_step(
        mode, hh, width, n, c, e, [jnp.asarray(p) for p in p9], jd)(
            jnp.asarray(x, jd))
    got = bv.variant_step(mode, hh, width, n, c, e,
                          [torch.from_numpy(p) for p in p9], td)(
                              torch.from_numpy(x).to(td))
    assert got.dtype == td and got.shape == want.shape
    got = got.float().numpy()
    want = np.asarray(jnp.asarray(want, jnp.float32))
    if mode == "copy":
        np.testing.assert_array_equal(got, want)
        return
    tol = 2 ** -6 if dtype == "bfloat16" or mode == "fullbf16" else 1e-4
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * np.abs(want).max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dwmixed_equals_dwonly(dtype):
    """bf16 rows times float32 taps promote to float32: the two modes
    compute the same values (the kernel only stages their rows in
    another type)."""
    x, p9 = _p3_inputs(5, 2, 6, 7, 8, 16)
    vp = bv.variant_params([torch.from_numpy(p) for p in p9])
    xh = bv.cs_to_nhwc(torch.from_numpy(x).to(dtype), 2)
    assert torch.equal(bv.block_variant("dwmixed", xh, vp),
                       bv.block_variant("dwonly", xh, vp))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_full_is_k1(dtype):
    """``full`` is K1's block: the variants' parameters as K1's
    (``k1_params``, taps in K1's (E, 9)) give K1's plain version the
    same output, bit for bit."""
    x, p9 = _p3_inputs(8, 2, 6, 7, 8, 16)
    vp = bv.variant_params([torch.from_numpy(p) for p in p9])
    np.testing.assert_array_equal(
        vp.kdw.numpy(), p9[3].reshape(9, 16).T)
    xh = bv.cs_to_nhwc(torch.from_numpy(x).to(dtype), 2)
    assert torch.equal(bf.fused_block(xh, bv.k1_params(vp)),
                       bv.block_variant("full", xh, vp))


def test_variant_layout_helpers():
    """``cs_to_nhwc``/``nhwc_to_cs`` are the tool's transposes
    (S = w*N + n) and undo each other."""
    xh = np.random.RandomState(0).randn(3, 4, 5, 6).astype(np.float32)
    cs = bv.nhwc_to_cs(torch.from_numpy(xh))
    np.testing.assert_array_equal(
        cs.numpy(), np.transpose(xh, (1, 3, 2, 0)).reshape(4, 6, 15))
    assert cs.is_contiguous()
    back = bv.cs_to_nhwc(cs, 3)
    assert back.is_contiguous()
    np.testing.assert_array_equal(back.numpy(), xh)


def test_block_variant_into_out():
    """``out`` receives the result; a chain through two buffers equals the
    step applied over and over."""
    x, p9 = _p3_inputs(6, 2, 5, 6, 8, 16)
    vp = bv.variant_params([torch.from_numpy(p) for p in p9])
    g = tbs.Geom("t", bv.cs_to_nhwc(torch.from_numpy(x), 2), (), vp, None,
                 ())
    want = g.x0
    for _ in range(3):
        want = bv.variant_plain("full", want, vp)
    assert torch.equal(tbs.run_chain(g, "full", 3), want)


def test_block_variant_refuses_other_devices():
    """No fallback: a tensor off the CPU that the kernel cannot take raises
    instead of reaching the plain version, and counts no launch; an unknown
    mode raises everywhere."""
    _, p9 = _p3_inputs(7, 1, 4, 4, 8, 16)
    vp = bv.variant_params([torch.from_numpy(p) for p in p9])
    with pytest.raises(ValueError):
        bv.block_variant("full", torch.empty((1, 4, 4, 8), device="meta"), vp)
    with pytest.raises(ValueError, match="mode"):
        bv.block_variant("tapsonly", torch.zeros((1, 4, 4, 8)), vp)
    with pytest.raises(ValueError):
        bv.variant_step("full", 4, 4, 1, 8, 16, [torch.from_numpy(p)
                                                 for p in p9],
                        torch.float32)(torch.zeros((4, 8, 5)))
    with pytest.raises(ValueError):
        pw.pw_matmul(torch.empty((16, 8), device="meta",
                                 dtype=torch.bfloat16),
                     torch.empty((8, 4), device="meta",
                                 dtype=torch.bfloat16))
    with pytest.raises(ValueError):
        mp.strided_rows(torch.empty((4, 8), device="meta",
                                    dtype=torch.bfloat16))
    with pytest.raises(ValueError):
        mp.dynslice_carry(torch.empty((4, 8), device="meta"))
    assert (bv.block_variant.launches == pw.pw_matmul.launches
            == mp.strided_rows.launches == mp.dynslice_carry.launches == 0)


def test_bisect_inputs_follow_the_tools_draws():
    """x0, the nine params and xh0 of each geometry, in the tool's order
    (tools/bisect_smallc.py:211-224, :271), at batch 1."""
    rng = np.random.RandomState(0)
    mine = np.random.RandomState(0)
    for geom in tbs.GEOMS[2:]:
        _, hh, width, c, e = geom
        x0 = rng.randn(hh, c, width).astype(np.float32) * 0.25
        mk = lambda *sh: rng.randn(*sh).astype(np.float32) * 0.2
        col = lambda m: rng.rand(m, 1).astype(np.float32) * 0.5 + 0.5
        p9 = (mk(e, c), col(e), col(e), mk(3, 3, e), col(e), col(e),
              mk(c, e), col(c), col(c))
        xh0 = rng.randn(1, hh, width, c).astype(np.float32) * 0.25
        g = tbs.make_geom(geom, 1, torch.float32, mine, "cpu")
        np.testing.assert_array_equal(bv.nhwc_to_cs(g.x0).numpy(), x0)
        for a, b in zip(g.params9, p9):
            np.testing.assert_array_equal(a.numpy(), b)
        np.testing.assert_array_equal(g.xh0.numpy(), xh0)


def test_bisect_xla_chain_matches_full():
    """The cuDNN chain row computes the block of ``full`` (the tool pins
    its full variant to the XLA chain the same way): float32, 1e-4 of the
    range."""
    g = tbs.make_geom(tbs.GEOMS[3], 2, torch.float32,
                      np.random.RandomState(0), "cpu")
    want = bv.variant_plain("full", g.xh0, g.vp)
    got = tbs.xla_block(g, g.xh0)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                               atol=1e-4 * want.abs().max().item())


def test_bisect_bounds():
    """copy moves the input and output once; full is ``block_work``."""
    g = tbs.make_geom(tbs.GEOMS[0], 1, torch.bfloat16,
                      np.random.RandomState(0), "cpu")
    assert tbs.mode_work("copy", g).bytes == 2 * 2 * 160 * 160 * 8
    full = tbs.mode_work("full", g)
    assert full.tc_flop == 2 * 160 * 160 * (8 * 32 + 32 * 8)
    assert full.f32_flop == 2 * 9 * 160 * 160 * 32
    # at the tool's batch 256: 209.7 MB in and out, 0.063 ms
    ms = 256 * tbs.mode_work("copy", g).bytes / 3.35e12 * 1e3
    assert 0.062 < ms < 0.063


# ----------------------------------------------------------------- P4, P5
def _strided_kern(x_ref, o_ref):
    """MOSAIC_STRIDED_16's body (tools/retest_backend_bugs.py:69-70)."""
    o_ref[...] = x_ref[::2, :]


def _carry_kern(x_ref, o_ref):
    """MOSAIC_DYNSLICE_CARRY's body (tools/retest_backend_bugs.py:85-89)."""
    def body(i, acc):
        seg = lax.dynamic_slice(acc, (i, 0), (8, 128))
        return jnp.concatenate([seg, seg], axis=0)
    o_ref[...] = lax.fori_loop(0, 3, body, x_ref[...])


@pytest.mark.parametrize("probe", trb.PROBES, ids=lambda p: p.kernel)
def test_probe_kernels_match_pallas(probe):
    """Each probe on the sweep's input, bit for bit."""
    x = jnp.arange(16 * 128, dtype=jnp.float32)
    if probe.kernel == "P4":
        x = x.astype(jnp.bfloat16).reshape(16, 128)
        want = pl.pallas_call(_strided_kern, out_shape=jax.ShapeDtypeStruct(
            (8, 128), jnp.bfloat16), interpret=True)(x)
    else:
        x = x.reshape(16, 128)
        want = pl.pallas_call(_carry_kern, out_shape=jax.ShapeDtypeStruct(
            (16, 128), jnp.float32), interpret=True)(x)
    tx = probe.make_input("cpu")
    np.testing.assert_array_equal(tx.float().numpy(),
                                  np.asarray(x, np.float32))
    got = probe.run(tx)
    assert got.dtype == tx.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))


@pytest.mark.parametrize("steps", [0, 1, 12])
def test_dynslice_carry_clamps_as_jax(steps):
    """Beyond seg steps, ``lax.dynamic_slice`` clamps the start to seg; the
    port does too (random rows, seg 4)."""
    x = np.random.RandomState(steps).randn(8, 5).astype(np.float32)

    def body(i, acc):
        seg = lax.dynamic_slice(acc, (i, 0), (4, 5))
        return jnp.concatenate([seg, seg], axis=0)
    want = lax.fori_loop(0, steps, body, jnp.asarray(x))
    got = mp.dynslice_carry(torch.from_numpy(x), steps)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("segs", [(1, 16), (17, 32), (33, 48), (49, 64)],
                         ids=lambda r: f"seg{r[0]}-{r[1]}")
def test_dynslice_rows_match_the_step_by_step_plain(segs):
    """P5's kernel copies each output row from the row of its closed-form
    map (``src_row``, the steps composed backwards, those past seg folded
    into one): it equals the step-by-step plain version for every seg and
    every step count up to 2*seg + 2, and the wrapper's fold of the steps
    (``min(steps, seg + 1)``) changes no row."""
    for seg in range(segs[0], segs[1] + 1):
        x = torch.arange(2 * seg, dtype=torch.float32)[:, None]
        for steps in range(2 * seg + 3):
            want = mp.dynslice_carry_plain(x, steps)[:, 0].long()
            assert torch.equal(mp.dynslice_rows(seg, steps), want), \
                (seg, steps)
            assert torch.equal(mp.dynslice_rows(seg, min(steps, seg + 1)),
                               want), (seg, steps)


def test_dynslice_rows_match_pallas():
    """The row map on the sweep's input against the Pallas probe itself:
    ``x.index_select(0, rows)`` (the library call P5 is timed beside) is
    its output bit for bit."""
    x = jnp.arange(16 * 128, dtype=jnp.float32).reshape(16, 128)
    want = pl.pallas_call(_carry_kern, out_shape=jax.ShapeDtypeStruct(
        (16, 128), jnp.float32), interpret=True)(x)
    tx = torch.from_numpy(np.asarray(x))
    got = tx.index_select(0, mp.dynslice_rows(8, 3))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_dynslice_carry_limits():
    """No shared memory, so no seg limit of 48 any more: the kernel takes
    any seg whose 2*seg rows fit an int, the wrapper mirrors that, and
    what it refuses (another device, dtype, a negative step count) it
    refuses before any launch."""
    src = open(os.path.join(REPO, "ffcnn_tpu_torch", "csrc",
                            "mosaic_probes.cu")).read()
    body = src[src.index("dynslice_carry_kernel"):]
    assert "__shared__" not in body and "__syncthreads" not in body
    assert "seg < 1 || seg > (1 << 30) - 1" in src
    assert mp._MAX_SEG == 2**30 - 1 and mp._MAX_COLS == 2**31 - 1
    wide = torch.empty((200, 8), device="meta")   # seg 100 > the old 48
    with pytest.raises(ValueError, match=f"at most {2 * mp._MAX_SEG} rows"):
        mp.dynslice_carry(wide)
    with pytest.raises(ValueError, match="steps >= 0"):
        mp.dynslice_carry(wide, -1)
    with pytest.raises(ValueError, match=r"\(2\*seg, C\)"):
        mp.dynslice_carry(torch.empty((3, 8), device="meta"))
    assert mp.dynslice_carry.launches == 0
    # on the CPU a wide carry takes the plain version
    x = torch.randn(200, 3)
    assert torch.equal(mp.dynslice_carry(x, 5),
                       x.index_select(0, mp.dynslice_rows(100, 5)))


def test_strided_rows_odd_count():
    x = torch.arange(15 * 3, dtype=torch.float32).to(torch.bfloat16)
    x = x.reshape(15, 3)
    assert torch.equal(mp.strided_rows(x), x[::2])


def _p4_launch(plan, rows, cols, x):
    """P4's kernel as the card runs ``plan``, in numpy: every thread of
    every CTA, its run from the block indices, its rows striding over the
    bands; returns y and how often each of its runs was written."""
    vec, (bx, by), (gx, gy) = plan
    runs, rows_out = cols // vec, -(-rows // 2)
    xr = x.reshape(rows, runs, vec)
    y = np.zeros((rows_out, runs, vec), x.dtype)
    hits = np.zeros((rows_out, runs), np.int64)
    for bxi in range(gx):
        for byi in range(gy):
            for ty in range(by):
                for tx in range(bx):
                    run = bxi * bx + tx
                    if run >= runs:
                        continue
                    for r in range(byi * by + ty, rows_out, gy * by):
                        y[r, run] = xr[2 * r, run]
                        hits[r, run] += 1
    return y.reshape(rows_out, cols), hits


# (rows, cols, x's address mod 16, want: columns a thread, block, grid):
# the sweep's shape (one CTA, one load and one store a thread), an odd R on
# 16-byte runs, the 2-byte path's odd R, C % 8 != 0 and unaligned view, a
# row longer than a CTA, and the timed shape past what 132 SMs keep
# resident (the CTAs stride over its 4,096 bands)
P4_PLANS = [((16, 128, 0), (8, (16, 8), (1, 1))),
            ((17, 128, 0), (8, (16, 8), (1, 2))),
            ((17, 130, 0), (1, (128, 1), (2, 9))),
            ((16, 130, 0), (1, (128, 1), (2, 8))),
            ((16, 128, 2), (1, (128, 1), (1, 8))),
            ((5, 2056, 0), (8, (128, 1), (3, 3))),
            ((65536, 128, 0), (8, (16, 8), (1, 2112)))]


@pytest.mark.parametrize("shape,want", P4_PLANS,
                         ids=[f"{r}x{c}+{o}" for (r, c, o), _ in P4_PLANS])
def test_p4_launch_mirror(shape, want):
    """``strided_plan`` gives the launch that ``ffcnn_strided_rows`` makes
    (a thread's width, block and grid, on an H100's 132 SMs), and that
    launch, run thread by thread, writes each run of ``x[::2]`` once."""
    rows, cols, off = shape
    plan = mp.strided_plan(rows, cols, 4096 + off, 8192, 132)
    assert plan == mp.StridedPlan(*want)
    assert plan.block[0] * plan.block[1] == mp.THREADS
    if rows * cols > 4096:
        return
    x = np.arange(rows * cols, dtype=np.int32)
    y, hits = _p4_launch(plan, rows, cols, x)
    np.testing.assert_array_equal(y, x.reshape(rows, cols)[::2])
    assert (hits == 1).all()


def test_p4_mirror_pins_the_source():
    """The mirror's constants and choices are the launcher's."""
    src = open(os.path.join(REPO, "ffcnn_tpu_torch", "csrc",
                            "mosaic_probes.cu")).read()
    assert f"constexpr int kThreads = {mp.THREADS};" in src
    assert f"constexpr int kResident = {mp.RESIDENT};" in src
    for line in ("cols % 8 == 0 && (uintptr_t)x % 16 == 0",
                 "(uintptr_t)y % 16 == 0",
                 "while (bx < runs && bx < kThreads) bx *= 2;",
                 "const int resident = sms * (kResident / kThreads) / gx;",
                 "strided_rows_kernel<uint4>", "strided_rows_kernel<uint16_t>"):
        assert line in src, line
    # an empty output launches nothing
    assert mp.strided_plan(0, 128, 0, 0, 132).grid == (0, 0)
    assert mp.strided_plan(16, 0, 0, 0, 132).grid == (0, 0)


# -------------------------------------------------------------- the CLIs
def test_bench_pw_kernels_runs_on_the_cpu(capsys):
    r = tbp.main(["--device", "cpu", "--batch", "2", "--hw", "16"])
    out = capsys.readouterr().out
    for row in ("A conv 1x1", "D torch.mm 2d", "B 2d", "C packed",
                "C maxdiff vs D"):
        assert row in out
    assert r["c_vs_d"] <= 1e-5
    assert r["B_bound"][1] == r["C_bound"][1] == "bytes"


def test_bisect_smallc_runs_on_the_cpu(capsys):
    rows = tbs.main(["--device", "cpu", "--batch", "1", "--iters", "2",
                     "--geoms", "40x40/C16/E96", "20x20/C24/E136"])
    out = capsys.readouterr().out
    assert [r["geom"] for r in rows] == ["40x40/C16/E96", "20x20/C24/E136"]
    for r in rows:
        for k in bv.MODES + ("xla", "tpose"):
            assert r[k] > 0 and r[k + "_bound"] > 0
    assert out.count("us/block") == 2 * 8 and "us/round-trip" in out
    with pytest.raises(SystemExit):
        tbs.main(["--device", "cpu", "--modes", "tapsonly"])


def _tool_probes():
    """The tool's registry (importing the tool runs no probe)."""
    spec = importlib.util.spec_from_file_location(
        "retest_tool", os.path.join(TOOLS, "retest_backend_bugs.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    return tool.PROBES


def test_retest_backend_bugs_cli(capsys):
    """The port holds exactly the tool's probes that reach a
    ``pallas_call``, under their registry names and in its order; --list
    and --only work."""
    with_pallas = [name for name, _, _, code, _ in _tool_probes()
                   if "pallas_call" in code]
    assert [p.name for p in trb.PROBES] == with_pallas
    assert trb.main(["--list"]) == 0
    listed = [ln.split()[0] for ln in
              capsys.readouterr().out.strip().splitlines()]
    assert listed == with_pallas
    assert trb.main(["--device", "cpu", "--only",
                     "mosaic_dynslice_carry"]) == 0
    ran = capsys.readouterr().out.strip().splitlines()
    assert [ln.split()[:3] for ln in ran] == [
        ["mosaic_dynslice_carry", "P5", "agree"]]
    with pytest.raises(SystemExit):
        trb.main(["--device", "cpu", "--only", "no_such_probe"])


@pytest.mark.parametrize("cli", [tbp, tbs, trb],
                         ids=lambda m: m.__name__.split(".")[-1])
def test_probe_clis_need_a_card_unless_asked(cli):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main([])
