"""The uint8 stem (K6, ffcnn_tpu_torch/kernels/conv0_fused.py) and the NMS
keep mask (K2, ffcnn_tpu_torch/kernels/nms.py) on the CPU.

K6: the weights' TF32 parts that the kernel multiplies, the launch plan the
wrapper passes it (pinned to the source's instances and constants), the
kernel's staging and gather emulated in numpy from that plan against the
plain version, and the plain version against JAX's ``conv0_cs`` in
interpret mode on the repo's other stride-2 stems (F 8 and F 32).

K2: the plain version against JAX's scan and the Pallas kernel in interpret
mode at K around the kernel's 32-anchor blocks, on suppression chains that
cross a block edge, one class and NaN boxes; and the kernel's blocked
schedule written out in numpy, bit-equal to the plain version on the same
inputs."""

import os
import re

import numpy as np
import pytest

import jax.numpy as jnp
import torch

import chip_smoke
import ffcnn_tpu_torch as pt
from ffcnn_tpu.darknet import parse_cfg
from ffcnn_tpu.darknet.weights import load_weights, synth_weights_bytes
from ffcnn_tpu.graph import build as jbuild
from ffcnn_tpu.kernels import conv0_fused as jc0
from ffcnn_tpu.kernels.nms_pallas import nms_keep_mask as jax_pallas_keep
from ffcnn_tpu.ops import nms as jnms
from ffcnn_tpu_torch.darknet import parse_cfg as tparse_cfg
from ffcnn_tpu_torch.graph import build as tbuild
from ffcnn_tpu_torch.kernels import conv0_fused as tc0
from ffcnn_tpu_torch.kernels.nms import keep_mask_plain, nms_keep_mask
from ffcnn_tpu_torch.testing import cap_threads

cap_threads()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(REPO, "ffcnn_tpu_torch", "csrc")
SMS = 132                                   # an H100 SXM's SMs


def _seeded_params(f: int, act: int = 2, seed: int = 0) -> tc0.Conv0Params:
    """A stem of ``f`` channels with weights of a folded stem's size."""
    rng = np.random.RandomState(seed)
    return tc0.conv0_params_from(
        torch.from_numpy(rng.randn(f, 3, 3, 3).astype(np.float32) * 0.02),
        torch.from_numpy(rng.uniform(0.5, 2.0, f).astype(np.float32)),
        torch.from_numpy(rng.randn(f).astype(np.float32)), act)


# ---------------------------------------------------------------- K6 host
@pytest.mark.parametrize("f", [8, 16, 20, 32])
def test_conv0_tf32_parts(f):
    """whi and wlo are TF32 values (low 13 bits zero), zero outside the
    (27, F) weights, and give them back to 2^-22 of each weight."""
    cp = _seeded_params(f)
    fp = -(-f // 8) * 8
    for part in (cp.whi, cp.wlo):
        assert part.shape == (32, fp) and part.dtype == torch.float32
        assert int((part.view(torch.int32) & 0x1FFF).abs().sum()) == 0
        assert not part[27:].any() and not part[:, f:].any()
    w = cp.wm.double()
    err = ((cp.whi[:27, :f].double() + cp.wlo[:27, :f].double()) - w).abs()
    assert bool((err <= 2.0 ** -22 * w.abs()).all())
    # the big part is the nearest TF32 value: within half a TF32 ulp
    assert bool(((cp.whi[:27, :f].double() - w).abs()
                 <= 2.0 ** -11 * w.abs()).all())


def test_conv0_params_of_the_xl_stem():
    """conv0_params on xl's folded stem: the same wm as before, and its
    TF32 parts."""
    path = os.path.join(REPO, "models", "yolo-fastest-xl.cfg")
    jir, ir = parse_cfg(path, 64, 64), tparse_cfg(path, 64, 64)
    params, _ = load_weights(jir, synth_weights_bytes(jir, seed=42,
                                                      obj_bias=2.0))
    tp = tbuild.fold_input_transform(ir, tbuild.params_from_numpy(params),
                                     pt.DEFAULT_MEAN, pt.DEFAULT_NORM)
    cp = tc0.conv0_params(ir, tp)
    w = tp[0]["weights"].float()
    torch.testing.assert_close(cp.wm, w.permute(2, 3, 1, 0).reshape(27, 16),
                               rtol=0, atol=0)
    assert (cp.act, cp.whi.shape, cp.wlo.shape) == (2, (32, 16), (32, 16))
    torch.testing.assert_close(cp.whi + cp.wlo, torch.nn.functional.pad(
        cp.wm, (0, 0, 0, 5)), rtol=2.0 ** -21, atol=0)


@pytest.mark.parametrize("w", [64, 320, 322, 416])
@pytest.mark.parametrize("f", [8, 16, 20, 32])
def test_conv0_plan(f, w):
    """The instance, band and copy path the wrapper passes the kernel."""
    for n in (1, 64):
        pl = tc0.plan(n, w, w, f, 2, 2, SMS)
        assert (pl.inst_f, pl.inst_act) == ((f, 2) if f in (8, 16, 32)
                                            else (0, -1))
        # every row 16-byte aligned: cp.async; 322 * 3 = 966 is not
        assert pl.aligned == (w != 322)
        assert not tc0.plan(n, w, w, f, 2, 2, SMS, False).aligned
        wo = w // 2
        assert pl.cols % 8 == 0 and pl.cols >= wo == min(wo, tc0.MAX_COLS)
        assert pl.ld % 128 == 64 and 16 + 6 * pl.cols <= pl.ld < \
            16 + 6 * pl.cols + 128 + 64
        assert pl.bands == n * -(-wo // pl.rows)
        assert pl.grid == min(pl.bands, tc0.CTAS_PER_SM * SMS)
        # the first of 4, 2, 1 rows that gives two bands an SM
        assert pl.rows == (4 if n == 64 else 1)
        out = 4 * 16 * (f * 2 + 16) if pl.inst_f else 0
        assert pl.smem == 2 * (2 * pl.rows + 1) * pl.ld + out <= \
            tc0.MAX_SMEM
    # any other activation takes the generic instance
    assert (tc0.plan(64, w, w, f, 1, 2, SMS).inst_f,
            tc0.plan(64, w, w, f, 1, 2, SMS).inst_act) == (0, -1)


def test_conv0_plan_wide_image():
    """Wider than MAX_COLS output columns: bands across as well."""
    pl = tc0.plan(2, 64, 2100, 16, 2, 4, SMS)
    assert (pl.cols, pl.rows, pl.bands) == (tc0.MAX_COLS, 1, 2 * 32 * 3)
    assert pl.smem <= tc0.MAX_SMEM


def test_conv0_plan_matches_the_source():
    """The compiled instances, the CTA size and the limits the plan assumes
    are the source's."""
    src = open(os.path.join(CSRC, "conv0_fused.cu")).read()
    inst = {(int(a), int(b)) for a, b in re.findall(
        r"inst_f == (\d+) && inst_act == (\d+)\) return launch<", src)}
    assert inst == set(tc0.INSTANCES)
    assert "inst_f == 0 && inst_act < 0) return launch<0, -1, T>" in src
    for name, value in (("kThreads", tc0.THREADS), ("kMaxF", tc0.MAX_F),
                        ("kMaxSmem", tc0.MAX_SMEM)):
        assert re.search(rf"constexpr (int|size_t) {name} = {value};", src)
    assert "kWarps * 16 * (inst_f * out + 16)" in src
    assert "2 * (size_t)(2 * rows + 1) * ld" in src
    assert "k<<<a.ctas, kThreads, smem, st>>>(a);" in src


def _emulate_k6(x: np.ndarray, cp: tc0.Conv0Params, pl: tc0.Plan):
    """The kernel's arithmetic as its plan lays it out: each band's input
    rows staged at stride ``pl.ld`` (bytes [6 c0 - 16, 6 c0 + 6 nc) of
    each, zero outside the image, every other byte NaN so that a gather
    outside the staged bytes shows), the 27 taps gathered at the kernel's
    offsets, the two TF32 parts' products summed in float64."""
    n, h, w, _ = x.shape
    ho, wo, f = h // 2, w // 2, cp.wm.shape[1]
    xb = x.reshape(n, h, 3 * w).astype(np.float64)
    whi, wlo = cp.whi.double().numpy(), cp.wlo.double().numpy()
    toff = np.array([dy * pl.ld + dx * 3 + ch for dy in range(3)
                     for dx in range(3) for ch in range(3)])
    y = np.full((n, ho, wo, f), np.nan)
    for img in range(n):
        for r0 in range(0, ho, pl.rows):
            for c0 in range(0, wo, pl.cols):
                nr, nc = min(pl.rows, ho - r0), min(pl.cols, wo - c0)
                seg0, nbytes = 6 * c0 - 16, -(-(16 + 6 * nc) // 16) * 16
                assert nbytes <= pl.ld
                if pl.aligned:       # whole 16-byte chunks in or out
                    assert seg0 % 16 == 0 and (3 * w) % 16 == 0
                smem = np.full((2 * nr + 1, pl.ld), np.nan)
                for r in range(2 * nr + 1):
                    gy = 2 * r0 - 1 + r
                    rb = seg0 + np.arange(nbytes)
                    ok = (gy >= 0) & (rb >= 0) & (rb < 3 * w)
                    smem[r, :nbytes] = np.where(
                        ok, xb[img, max(gy, 0), np.clip(rb, 0, 3 * w - 1)],
                        0.0)
                p = np.arange(nr * nc)
                orow, oc = p // nc, p % nc
                base = 2 * orow * pl.ld + 13 + 6 * oc
                taps = smem.reshape(-1)[base[:, None] + toff[None]]
                acc = taps @ wlo[:27] + taps @ whi[:27]
                y[img, r0:r0 + nr, c0:c0 + nc] = \
                    acc[:, :f].reshape(nr, nc, f)
    return y * cp.scale.double().numpy() + cp.bias.double().numpy()


@pytest.mark.parametrize("n,h,w,f", [(2, 64, 64, 16), (2, 34, 322, 8),
                                     (1, 20, 322, 20), (3, 16, 416, 32),
                                     (1, 6, 1100, 16)])
def test_conv0_emulated_kernel_matches_plain(n, h, w, f):
    """The staging layout and tap offsets of every plan shape (both copy
    paths, bands of 4 and 1 rows, a ragged last band, two bands across)
    give the plain version's pre-activation values."""
    rng = np.random.RandomState(n * h + w + f)
    x = rng.randint(0, 256, (n, h, w, 3), dtype=np.uint8)
    cp = _seeded_params(f, act=0, seed=f)
    pl = tc0.plan(n, h, w, f, 0, 4, SMS)
    got = _emulate_k6(x, cp, pl)
    assert not np.isnan(got).any()
    want = tc0.conv0_plain(torch.from_numpy(x), cp, torch.float32).double()
    scale = want.abs().max().item()
    np.testing.assert_allclose(got, want.numpy(), rtol=0,
                               atol=2e-5 * scale)


@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cfg,f", [("ffcnn-micro", 8), ("yolov4-tiny", 32)])
def test_conv0_plain_matches_jax_interpret_other_stems(cfg, f, out_dtype):
    """K6's plain version against ``conv0_cs`` (interpret mode) on the
    folded stems of micro (F 8) and yolov4-tiny (F 32)."""
    path = os.path.join(REPO, "models", f"{cfg}.cfg")
    ir = parse_cfg(path, 64, 64)
    params, _ = load_weights(ir, synth_weights_bytes(ir, seed=3,
                                                     obj_bias=2.0))
    jp = jbuild.fold_input_transform(ir, jbuild.params_to_pytree(params),
                                     pt.DEFAULT_MEAN, pt.DEFAULT_NORM)
    x = np.random.RandomState(11).randint(0, 256, (2, 64, 64, 3),
                                          dtype=np.uint8)
    p = jp[0]
    cs = jc0.conv0_cs(jnp.asarray(x), p["weights"], p["scale"], p["bias"],
                      ir.layers[0].activation,
                      out_dtype=getattr(jnp, out_dtype), interpret=True)
    assert ir.blobs[1].c == f
    want = np.asarray(jnp.asarray(jnp.transpose(
        cs.reshape(32, f, 32, 2), (3, 0, 2, 1)), jnp.float32))
    tir = tparse_cfg(path, 64, 64)
    tp = tbuild.fold_input_transform(tir, tbuild.params_from_numpy(params),
                                     pt.DEFAULT_MEAN, pt.DEFAULT_NORM)
    cp = tc0.conv0_params(tir, tp)
    assert (cp.act, tc0.plan(2, 64, 64, f, cp.act, 2, SMS).inst_f) == (2, f)
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


# --------------------------------------------------------------------- K2
def _random_set(n, k, seed, classes=3):
    """Sorted candidates on a coarse grid (ties, touching and degenerate
    boxes), equal scores in blocks, some absent."""
    rng = np.random.RandomState(seed)
    xy = rng.randint(0, 24, (n, k, 2)).astype(np.float32)
    wh = rng.randint(0, 10, (n, k, 2)).astype(np.float32)
    boxes = np.concatenate([xy, xy + wh], axis=-1)
    scores = rng.choice([0.5, 0.6, 0.75, 0.9], (n, k)).astype(np.float32)
    scores[rng.rand(n, k) > 0.7] = 0.0
    order = np.argsort(-scores, axis=1, kind="stable")
    return (np.take_along_axis(boxes, order[..., None], axis=1),
            np.take_along_axis(scores, order, axis=1),
            rng.randint(0, classes, (n, k)).astype(np.int32))


def _one_class_set(n, k, seed):
    b, s, _ = _random_set(n, k, seed)
    return b, s, np.zeros((n, k), np.int32)


def _nan_set(n, k, seed):
    b, s, c = _random_set(n, k, seed, classes=2)
    rng = np.random.RandomState(seed + 1)
    b[rng.rand(n, k) < 0.15, rng.randint(0, 4)] = np.nan
    b[:, :2] = np.array([5, 5, 5, 9], np.float32)   # 0/0 IoU: NaN
    return b, s, c


SETS = {"random": _random_set, "chain": chip_smoke.nms_chains,
        "one_class": _one_class_set, "nan": _nan_set}
KS = [1, 31, 32, 33, 95]


def _blocked_keep(boxes, scores, classes, thr, kind):
    """The kernel's schedule (csrc/nms.cu), in numpy float32: blocks of 32
    anchors; the block's masks (a row for each anchor with score > 0); the
    block resolved on a bitset; then every later candidate still kept
    tested against the block's kept anchors, in order."""
    thr = np.float32(thr)
    n, k = scores.shape
    with np.errstate(invalid="ignore", divide="ignore"):
        a, b = boxes[:, :, None], boxes[:, None, :]     # a: the earlier
        x1 = np.maximum(a[..., 0], b[..., 0])
        y1 = np.maximum(a[..., 1], b[..., 1])
        x2 = np.minimum(a[..., 2], b[..., 2])
        y2 = np.minimum(a[..., 3], b[..., 3])
        inter = np.where((x1 < x2) & (y1 < y2), (x2 - x1) * (y2 - y1),
                         np.float32(0))
        area = (boxes[..., 2] - boxes[..., 0]) * (boxes[..., 3]
                                                  - boxes[..., 1])
        aa, ab = area[:, :, None], area[:, None, :]
        iou = (inter / ((aa + ab) - inter) if kind == "union"
               else inter / np.minimum(aa, ab))
        sup = (iou > thr) & (classes[:, :, None] == classes[:, None, :])
    keep = scores > 0
    for img in range(n):
        for b0 in range(0, k, 32):
            cnt = min(32, k - b0)
            masks = [sum(1 << u for u in range(r + 1, cnt)
                         if sup[img, b0 + r, b0 + u])
                     if scores[img, b0 + r] > 0 else 0 for r in range(cnt)]
            alive = sum(1 << u for u in range(cnt) if keep[img, b0 + u])
            for r in range(cnt):
                if alive >> r & 1:
                    alive &= ~masks[r]
            kept = [b0 + u for u in range(cnt) if alive >> u & 1]
            keep[img, b0:b0 + cnt] = [bool(alive >> u & 1)
                                      for u in range(cnt)]
            for j in range(b0 + 32, k):
                if keep[img, j] and any(sup[img, i, j] for i in kept):
                    keep[img, j] = False
    return keep


def _kernel_overlaps(a, b, thr, kind):
    """csrc/nms.cu's ``overlaps`` in numpy float32, for arrays of pairs:
    false on a NaN area, fmaxf/fminf, no division where the intersection
    is 0."""
    f = np.float32
    with np.errstate(invalid="ignore", divide="ignore", over="ignore"):
        area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
        area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
        x1, y1 = np.fmax(a[:, 0], b[:, 0]), np.fmax(a[:, 1], b[:, 1])
        x2, y2 = np.fmin(a[:, 2], b[:, 2]), np.fmin(a[:, 3], b[:, 3])
        inter = np.where((x1 < x2) & (y1 < y2), (x2 - x1) * (y2 - y1), f(0))
        den = ((area_a + area_b) - inter if kind == "union"
               else np.fmin(area_a, area_b))
        zero = (f(thr) < 0) & (den == den) & (den != 0)
        out = np.where(inter == 0, zero, inter / den > f(thr))
    return out & ~np.isnan(area_a) & ~np.isnan(area_b)


@pytest.mark.parametrize("thr", [0.5, 0.0, -0.25, 0.7])
@pytest.mark.parametrize("kind", ["min", "union"])
def test_kernel_overlaps_equals_plain_iou(kind, thr):
    """The kernel's shortcuts (a NaN area, an intersection of 0) give the
    plain version's ``iou > thr`` on every pair: NaN, infinite, negative,
    degenerate and touching coordinates included."""
    rng = np.random.RandomState(7)
    vals = np.array([0, 1, 2, 3, 5, 8, -1, -4, np.nan, np.inf, -np.inf,
                     0.5, 1e-30, 3e38], np.float32)
    a = rng.choice(vals, (20000, 4)).astype(np.float32)
    b = rng.choice(vals, (20000, 4)).astype(np.float32)
    # a quarter as boxes proper: x1 <= x2, y1 <= y2
    a[:5000] = np.sort(a[:5000].reshape(-1, 2, 2), axis=1).reshape(-1, 4)
    from ffcnn_tpu_torch.kernels.nms import _iou
    with np.errstate(invalid="ignore"):
        want = (_iou(torch.from_numpy(a), torch.from_numpy(b)[:, None], kind)
                [:, 0] > thr).numpy()
    np.testing.assert_array_equal(_kernel_overlaps(a, b, thr, kind), want)


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("name", list(SETS))
def test_keep_mask_plain_matches_jax(name, k):
    """The plain version equals JAX's scan (min and union IoU) and the
    Pallas kernel in interpret mode (min), bit for bit."""
    b, s, c = SETS[name](3, k, seed=k)
    tb, ts, tc = (torch.from_numpy(v) for v in (b, s, c))
    for kind in ("min", "union"):
        want = np.asarray(jnms._keep_mask_scan(
            jnp.asarray(b), jnp.asarray(s), jnp.asarray(c), k, 0.5, kind))
        got = keep_mask_plain(tb, ts, tc, 0.5, kind).numpy()
        np.testing.assert_array_equal(got, want, f"{name} {kind}")
    pallas = np.asarray(jax_pallas_keep(
        jnp.asarray(b), jnp.asarray(s), jnp.asarray(c), k=k, threshold=0.5,
        interpret=True)) > 0.5
    np.testing.assert_array_equal(keep_mask_plain(tb, ts, tc, 0.5).numpy(),
                                  pallas, f"{name} pallas")


@pytest.mark.parametrize("k", KS + [128])
@pytest.mark.parametrize("name", list(SETS))
def test_blocked_schedule_matches_plain(name, k):
    """The kernel's blocked schedule gives the plain version's mask bit for
    bit (and a chain set keeps what greedy keeps across block edges)."""
    b, s, c = SETS[name](3, k, seed=k + 100)
    tb, ts, tc = (torch.from_numpy(v) for v in (b, s, c))
    for kind in ("min", "union"):
        want = keep_mask_plain(tb, ts, tc, 0.5, kind).numpy()
        np.testing.assert_array_equal(_blocked_keep(b, s, c, 0.5, kind), want,
                                      f"{name} {kind}")
        # the wrapper takes the plain version for CPU tensors
        np.testing.assert_array_equal(
            nms_keep_mask(tb, ts, tc, threshold=0.5, iou_kind=kind).numpy(),
            want)


def test_chain_set_crosses_block_edges():
    """The chain set keeps every third box of a chain (min IoU) across the
    32-anchor edges, and every other box (union)."""
    b, s, c = chip_smoke.nms_chains(1, 95, seed=5)
    for kind, step in (("min", 3), ("union", 2)):
        keep = keep_mask_plain(*(torch.from_numpy(v) for v in (b, s, c)),
                               0.5, kind).numpy()[0]
        starts = [0] + [i for i in range(1, 95)
                        if b[0, i, 1] != b[0, i - 1, 1]]
        for a, e in zip(starts, starts[1:] + [95]):
            e = min(e, int((s[0] > 0).sum()))
            idx = np.arange(a, e)
            np.testing.assert_array_equal(keep[idx], (idx - a) % step == 0)
    assert any(a % 32 != 0 and e - a > 32 - a % 32
               for a, e in zip(starts, starts[1:] + [95]))


@pytest.mark.parametrize("k", [1, 33, 128])
def test_nms_candidates_are_sorted(k):
    """The smoke's candidate sets come as the kernel takes them: scores
    sorted descending, absent candidates (score 0) last, boxes with x1 <= x2
    and y1 <= y2, five classes; seeded."""
    b, s, c = chip_smoke.nms_candidates(3, k, seed=k)
    assert b.shape == (3, k, 4) and s.shape == c.shape == (3, k)
    assert (b.dtype, s.dtype, c.dtype) == (np.float32, np.float32, np.int32)
    assert (np.diff(s, axis=1) <= 0).all()
    assert (b[..., 2] >= b[..., 0]).all() and (b[..., 3] >= b[..., 1]).all()
    assert c.min() >= 0 and c.max() < 5
    for got, want in zip(chip_smoke.nms_candidates(3, k, seed=k), (b, s, c)):
        np.testing.assert_array_equal(got, want)
