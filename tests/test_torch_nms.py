"""The port's NMS (ffcnn_tpu_torch/ops/nms.py and the plain keep mask of
kernels/nms.py) against the JAX package's scan and its Pallas kernel in
interpret mode, on the CPU.  Keep masks and results must be equal, not
close: both sides evaluate the same IEEE float32 operations."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from ffcnn_tpu.kernels.nms_pallas import nms_keep_mask as jax_pallas_keep
from ffcnn_tpu.ops import nms as jnms
from ffcnn_tpu_torch.kernels.nms import keep_mask_plain, nms_keep_mask
from ffcnn_tpu_torch.ops import nms as tnms
from ffcnn_tpu_torch.testing import cap_threads

cap_threads()


def _candidates(seed, n=3, m=96, density=0.7, classes=3):
    """Boxes on a coarse integer grid (ties, touching and degenerate boxes
    occur), equal scores in blocks, a few classes."""
    rng = np.random.RandomState(seed)
    xy = rng.randint(0, 24, (n, m, 2)).astype(np.float32)
    wh = rng.randint(0, 10, (n, m, 2)).astype(np.float32)   # 0 = degenerate
    boxes = np.concatenate([xy, xy + wh], axis=-1)
    scores = rng.choice([0.5, 0.6, 0.75, 0.9], size=(n, m)).astype(np.float32)
    scores[rng.rand(n, m) > density] = 0.0
    cls = rng.randint(0, classes, (n, m)).astype(np.float32)
    return boxes, scores, cls


def _sorted_top(boxes, scores, cls, k):
    order = np.argsort(-scores, axis=1, kind="stable")[:, :k]
    take = lambda a: np.take_along_axis(a, order, axis=1)
    return (np.take_along_axis(boxes, order[..., None], axis=1),
            take(scores), take(cls).astype(np.int32))


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("iou_kind", ["min", "union"])
def test_keep_mask_matches_jax_scan(seed, iou_kind):
    b, s, c = _sorted_top(*_candidates(seed), k=64)
    want = np.asarray(jnms._keep_mask_scan(
        jnp.asarray(b), jnp.asarray(s), jnp.asarray(c), 64, 0.5, iou_kind))
    got = keep_mask_plain(torch.from_numpy(b), torch.from_numpy(s),
                          torch.from_numpy(c), 0.5, iou_kind)
    np.testing.assert_array_equal(got.numpy(), want)
    # the wrapper takes the plain version for CPU tensors
    np.testing.assert_array_equal(
        nms_keep_mask(torch.from_numpy(b), torch.from_numpy(s),
                      torch.from_numpy(c), threshold=0.5,
                      iou_kind=iou_kind).numpy(), want)


@pytest.mark.parametrize("seed", range(3))
def test_keep_mask_matches_pallas_kernel(seed):
    b, s, c = _sorted_top(*_candidates(seed + 10, n=4), k=32)
    want = np.asarray(jax_pallas_keep(jnp.asarray(b), jnp.asarray(s),
                                      jnp.asarray(c), k=32, threshold=0.5,
                                      interpret=True)) > 0.5
    got = keep_mask_plain(torch.from_numpy(b), torch.from_numpy(s),
                          torch.from_numpy(c), 0.5)
    np.testing.assert_array_equal(got.numpy(), want)


def test_nan_iou_suppresses_nothing():
    # two identical zero-area boxes: inter 0, min area 0 -> 0/0 = NaN
    b = np.array([[[5, 5, 5, 9], [5, 5, 5, 9], [0, 0, 4, 4],
                   [0, 0, 4, 4]]], np.float32)
    s = np.array([[0.9, 0.8, 0.7, 0.6]], np.float32)
    c = np.zeros((1, 4), np.int32)
    for kind in ("min", "union"):
        keep = keep_mask_plain(torch.from_numpy(b), torch.from_numpy(s),
                               torch.from_numpy(c), 0.5, kind)
        assert keep.tolist() == [[True, True, True, False]]


@pytest.mark.parametrize("impl", ["scan", "pallas"])
@pytest.mark.parametrize("seed,k", [(0, 16), (1, 48), (2, 100)])
def test_nms_matches_jax(impl, seed, k):
    boxes, scores, cls = _candidates(seed + 20, m=120)
    want = jnms.nms(jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(cls),
                    k=k, threshold=0.5, scale1=640, scale2=320, impl=impl)
    got = tnms.nms(torch.from_numpy(boxes), torch.from_numpy(scores),
                   torch.from_numpy(cls), k=k, threshold=0.5, scale1=640,
                   scale2=320)
    for name in ("boxes", "scores", "classes", "count", "saturated"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), name)
    # k=16/48 of ~84 live candidates saturate, k=100 fits.  (k < m: at
    # k == m JAX's approx_max_k drops the stable order of equal scores.)
    assert bool(got.saturated.any()) == (k < 84)


def test_nms_union_matches_jax_scan():
    boxes, scores, cls = _candidates(30, m=90)
    want = jnms.nms(jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(cls),
                    k=80, threshold=0.7, impl="scan", iou_kind="union")
    got = tnms.nms(torch.from_numpy(boxes), torch.from_numpy(scores),
                   torch.from_numpy(cls), k=80, threshold=0.7,
                   iou_kind="union")
    np.testing.assert_array_equal(got.scores.numpy(), np.asarray(want.scores))
    np.testing.assert_array_equal(got.count.numpy(), np.asarray(want.count))


def test_wrapper_refuses_other_devices():
    """No fallback: a tensor that is neither on the CPU nor usable by the
    kernel raises instead of reaching the plain version."""
    b = torch.empty((1, 4, 4), device="meta")
    s = torch.empty((1, 4), device="meta")
    c = torch.empty((1, 4), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        nms_keep_mask(b, s, c, threshold=0.5)
