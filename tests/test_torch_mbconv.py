"""K8 (``kernels/mbconv.py``) and K9 (``kernels/mbconv_cs.py``): their plain
versions against the Pallas kernels they replace (``block_pallas`` and
``csblock_pallas``, interpret mode on the CPU) on the same numpy inputs,
and the block A/B bench (``ffcnn_tpu_torch/bench_block.py``) end to end on
the CPU at a tiny size.

Tolerances, of the output's range.  float32: the same sums in another order
(2e-5, as ``tests/test_csblock_kernel.py``).  bfloat16: both kernels round
an intermediate to bf16 before the next stage (K8 the expand and depthwise
outputs, K9 the depthwise output), so a value that the two sum orders put
on either side of a rounding edge lands one bf16 ulp (2^-8 relative) apart
there, and the flip, times the taps and the projection weights, reaches the
output besides the output's own rounding; allow four ulps (2^-6)."""

import itertools

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from ffcnn_tpu.kernels import block_pallas as jk8
from ffcnn_tpu.kernels import csblock_pallas as jk9
from ffcnn_tpu_torch import bench_block as bb
from ffcnn_tpu_torch.kernels import mbconv as tk8
from ffcnn_tpu_torch.kernels import mbconv_cs as tk9
from ffcnn_tpu_torch.testing import cap_threads

cap_threads()

TOL = {"float32": 2e-5, "bfloat16": 2 ** -6}


def _weights(rng, cin, cmid, cout):
    """w1 (Cin, Cmid), wd (3, 3, Cmid), w2 (Cmid, Cout) and the six scale
    and bias vectors, float32."""
    w1 = rng.randn(cin, cmid).astype(np.float32) * 0.3
    wd = rng.randn(3, 3, cmid).astype(np.float32) * 0.3
    w2 = rng.randn(cmid, cout).astype(np.float32) * 0.3
    vec = [rng.rand(c).astype(np.float32) + o for c, o in (
        (cmid, 0.5), (cmid, -0.5), (cmid, 0.5), (cmid, -0.5), (cout, 0.5),
        (cout, -0.5))]
    s1, b1, sd, bd, s2, b2 = vec
    return w1, s1, b1, wd, sd, bd, w2, s2, b2


def _close(got, want, dtype):
    got = got.float().numpy()
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert got.shape == want.shape
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL[dtype] * scale)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("stride,residual,act_mid,act_out",
                         list(itertools.product((1, 2), (True, False),
                                                (True, False),
                                                (True, False))))
def test_k8_plain_matches_pallas(stride, residual, act_mid, act_out, dtype):
    rng = np.random.RandomState(stride * 8 + residual * 4 + act_mid * 2
                                + act_out)
    n, h, w, cin, cmid, cout = 2, 8, 6, 8, 24, 8
    x = rng.randn(n, h, w, cin).astype(np.float32) * 0.5
    res = rng.randn(n, h // stride, w // stride, cout).astype(np.float32)
    ws = _weights(rng, cin, cmid, cout)
    kw = dict(stride=stride, residual=residual, act_mid=act_mid,
              act_out=act_out)
    want = jk8.fused_mbconv(jnp.asarray(x, dtype),
                            *(jnp.asarray(t) for t in ws),
                            jnp.asarray(res, dtype), interpret=True, **kw)
    td = getattr(torch, dtype)
    got = tk8.fused_mbconv(torch.from_numpy(x).to(td),
                           *(torch.from_numpy(t) for t in ws),
                           torch.from_numpy(res).to(td), **kw)
    assert got.dtype == td
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act_mid,act_dw,act_out",
                         list(itertools.product((jk9._LEAKY, jk9._LINEAR),
                                                repeat=3)))
@pytest.mark.parametrize("residual", [True, False])
def test_k9_plain_matches_pallas(residual, act_mid, act_dw, act_out, dtype):
    rng = np.random.RandomState(act_mid * 4 + act_dw * 2 + act_out)
    n, h, w, cin, cmid, cout = 2, 6, 5, 8, 16, 8
    x = rng.randn(n, h, w, cin).astype(np.float32) * 0.5
    res = rng.randn(n, h, w, cout).astype(np.float32) * 0.5
    w1, s1, b1, wd, sd, bd, w2, s2, b2 = _weights(rng, cin, cmid, cout)
    ws = (w1.T.copy(), s1, b1, wd, sd, bd, w2.T.copy(), s2, b2)
    kw = dict(H=h, W=w, act_mid=act_mid, act_dw=act_dw, act_out=act_out)
    want = jk9.fused_mbconv_cs(
        jk9.nhwc_to_cs(jnp.asarray(x, dtype)), *(jnp.asarray(t) for t in ws),
        jk9.nhwc_to_cs(jnp.asarray(res, dtype)) if residual else None,
        interpret=True, **kw)
    td = getattr(torch, dtype)
    got = tk9.fused_mbconv_cs(
        tk9.nhwc_to_cs(torch.from_numpy(x).to(td)),
        *(torch.from_numpy(t) for t in ws),
        tk9.nhwc_to_cs(torch.from_numpy(res).to(td)) if residual else None,
        **kw)
    assert got.dtype == td and got.shape == (cout, n * h * w)
    _close(got, want, dtype)


def test_k9_codes_are_the_tpu_kernels():
    assert (tk9.LEAKY, tk9.LINEAR) == (jk9._LEAKY, jk9._LINEAR)


def test_layout_helpers_round_trip():
    """``nhwc_to_cs``/``cs_to_nhwc`` equal JAX's and undo each other."""
    x = np.random.RandomState(0).randn(3, 4, 5, 6).astype(np.float32)
    cs = tk9.nhwc_to_cs(torch.from_numpy(x))
    np.testing.assert_array_equal(cs.numpy(),
                                  np.asarray(jk9.nhwc_to_cs(jnp.asarray(x))))
    assert cs.is_contiguous() and cs.shape == (6, 60)
    back = tk9.cs_to_nhwc(cs, 3, 4, 5)
    np.testing.assert_array_equal(back.numpy(), x)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jk9.cs_to_nhwc(jnp.asarray(cs.numpy()),
                                                3, 4, 5)))


def test_k8_odd_size_at_stride_2_raises():
    """Odd H or W at stride 2: the JAX kernel cannot run it (shapes do not
    add up), and both the port's versions raise ValueError."""
    rng = np.random.RandomState(1)
    ws = _weights(rng, 4, 8, 4)
    for h, w in ((5, 6), (6, 5)):
        x = rng.randn(1, h, w, 4).astype(np.float32)
        with pytest.raises(Exception):
            jk8.fused_mbconv(jnp.asarray(x), *(jnp.asarray(t) for t in ws),
                             stride=2, interpret=True)
        for fn in (tk8.fused_mbconv, tk8.fused_mbconv_plain):
            with pytest.raises(ValueError, match="even"):
                fn(torch.from_numpy(x), *(torch.from_numpy(t) for t in ws),
                   stride=2)


def test_k9_needs_whole_images():
    rng = np.random.RandomState(2)
    w1, s1, b1, wd, sd, bd, w2, s2, b2 = (torch.from_numpy(t) for t in
                                          _weights(rng, 4, 8, 4))
    x = torch.zeros((4, 31))
    with pytest.raises(ValueError, match="whole number"):
        tk9.fused_mbconv_cs(x, w1.t(), s1, b1, wd, sd, bd, w2.t(), s2, b2,
                            H=3, W=5)


def test_wrappers_refuse_other_devices():
    """No fallback: a tensor off the CPU that the kernels cannot take
    raises instead of reaching the plain version, and counts no launch."""
    ws = [torch.from_numpy(t) for t in _weights(np.random.RandomState(3), 4,
                                                8, 4)]
    with pytest.raises(ValueError):
        tk8.fused_mbconv(torch.empty((1, 4, 4, 4), device="meta"), *ws)
    cs_ws = [ws[0].t()] + ws[1:6] + [ws[6].t()] + ws[7:]
    with pytest.raises(ValueError):
        tk9.fused_mbconv_cs(torch.empty((4, 16), device="meta"), *cs_ws,
                            H=4, W=4)
    assert tk8.fused_mbconv.launches == tk9.fused_mbconv_cs.launches == 0


def test_bound_of_a_block():
    """``Work.bound`` on K1's 10x10 C96 E448 P96 block at batch 64, bf16:
    1.10 GFLOP of pointwise work (1.1 us at 989 TFLOP/s) outweighs 52 MFLOP
    of taps (0.8 us at 67 TFLOP/s) and 2.8 MB (0.84 us at 3.35 TB/s)."""
    work = bb.block_work(64, 10, 10, 96, 448, 96)
    assert work.tc_flop == 2 * 64 * 100 * 448 * 192
    assert work.f32_flop == 2 * 9 * 64 * 100 * 448
    assert work.bytes == 2 * 64 * 100 * 192 + 4 * (448 * 205 + 2 * 96)
    ms, by = work.bound()
    assert by == "operations" and abs(ms - work.tc_flop / 989e9) < 1e-12
    ms, by = bb.block_work(256, 160, 160, 8, 8, 4, 1, True).bound()
    assert by == "bytes" and 0.06 < ms < 0.07


def test_bench_block_runs_on_the_cpu(capsys):
    """``python -m ffcnn_tpu_torch.bench_block --device cpu`` at a tiny
    size: the tool's seven configs and xl's 24 region blocks, each through
    the plain versions, agree with themselves and with K1/K3 within the
    rounding of their different rounding points."""
    rows = bb.main(["--device", "cpu", "--batch", "2", "--shrink", "5",
                    "--xl-size", "64", "--xl-batch", "2", "--iters", "1"])
    out = capsys.readouterr().out
    assert "bench_block on cpu" in out
    assert [r["part"] for r in rows] == ["a"] * 7 + ["b"] * 24
    assert sum("err9" in r for r in rows) == 5 + 20
    assert all(r["finite"] and r["err8"] == 0 for r in rows)
    assert all(r.get("err9", 0) == 0 for r in rows)
    # K8 beside K1/K3: both round their outputs to bf16 from float32 sums,
    # K8 also its expand and depthwise outputs
    assert all(r["err8_block"] <= 2 ** -5 * r["range8"]
               for r in rows if r["part"] == "b")


def test_bench_block_needs_a_card_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bb.main([])
