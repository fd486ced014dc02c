"""The port's remaining Net entry points against the JAX package's, on the
CPU: detect_async/detect_stream (the serial detect and JAX's stream at
tests/test_stream.py's tolerances), warmup's K ladder (the same bucket
keys as JAX's), forward_raw (tests/test_torch_net.py's blob tolerances),
memory_stats on a CPU Net, the folded-params cache shared with JAX's, and
the leaky slope and avgpool divisor in the tensor's dtype, bit for bit."""

import os

import numpy as np
import pytest

import jax.numpy as jnp
import torch

import ffcnn_tpu as jt
import ffcnn_tpu_torch as pt
from ffcnn_tpu.darknet import cache as jcache
from ffcnn_tpu.darknet import parse_cfg
from ffcnn_tpu.darknet.ir import Activation
from ffcnn_tpu.darknet.weights import load_weights, synth_weights_bytes
from ffcnn_tpu.ops import activations as jact
from ffcnn_tpu.ops import pool as jpool
from ffcnn_tpu_torch.darknet import cache as tcache
from ffcnn_tpu_torch.ops import activations as tact
from ffcnn_tpu_torch.ops import pool as tpool
from ffcnn_tpu_torch.testing import cap_threads

cap_threads()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MICRO = os.path.join(REPO, "models", "ffcnn-micro.cfg")


def _model(seed=7, size=0):
    ir = parse_cfg(MICRO, size, size)
    params, _ = load_weights(ir, synth_weights_bytes(ir, seed=seed,
                                                     obj_bias=2.0))
    return ir, pt.parse_cfg(MICRO, size, size), params


@pytest.fixture(scope="module")
def nets():
    """The port's and JAX's parity Nets on the same weights (as
    tests/test_stream.py builds JAX's)."""
    ir, tir, params = _model()
    return (pt.Net(tir, params, mode="parity", device="cpu"),
            jt.Net(ir, params, mode="parity"))


def _batches(n_batches, n, seed=1):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 256, (n, 64, 64, 3), dtype=np.uint8)
            for _ in range(n_batches)]


def _assert_same(got, want):
    """tests/test_stream.py's tolerances: class, score to 1e-6, box to
    1e-4 px."""
    assert len(got) == len(want)
    for g_img, w_img in zip(got, want):
        assert len(g_img) == len(w_img)
        for g, w in zip(g_img, w_img):
            assert g.class_id == w.class_id
            assert abs(g.score - w.score) < 1e-6
            assert max(abs(a - b) for a, b in
                       zip((g.x1, g.y1, g.x2, g.y2),
                           (w.x1, w.y1, w.x2, w.y2))) < 1e-4


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_detect_stream_matches_detect_and_jax(nets, depth):
    net, jnet = nets
    batches = _batches(4, 3)
    want = [net.detect(b) for b in batches]
    got = list(net.detect_stream(iter(batches), depth=depth))
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        _assert_same(g, w)
    for g, j in zip(got, jnet.detect_stream(iter(batches), depth=depth)):
        _assert_same(g, j)


def test_detect_stream_more_batches_than_depth(nets):
    """In-flight order holds over a long stream."""
    net, jnet = nets
    batches = _batches(7, 2, seed=5)
    got = list(net.detect_stream(batches, depth=2))
    want = [net.detect(b) for b in batches]
    assert len(got) == 7
    for g, w, j in zip(got, want, jnet.detect_stream(batches, depth=2)):
        _assert_same(g, w)
        _assert_same(g, j)


def test_detect_stream_rejects_bad_shapes(nets):
    net, _ = nets
    with pytest.raises(ValueError):
        list(net.detect_stream([np.zeros((64, 64, 3), np.uint8)]))
    with pytest.raises(ValueError):
        net.detect_stream([], depth=0)      # raises at call time


def test_detect_stream_empty(nets):
    net, _ = nets
    assert list(net.detect_stream([])) == []


def test_detect_async_matches_detect_and_jax(nets):
    net, jnet = nets
    (batch,) = _batches(1, 4, seed=9)
    want = net.detect(batch)
    finish = net.detect_async(batch)
    got = finish()
    _assert_same(got, want)
    _assert_same(got, jnet.detect_async(batch)())


def test_warmup_topk_ladder_builds_jax_buckets():
    """warmup(topk_ladder=True) builds every K bucket JAX's does (the keys'
    index 3, as tests/test_saturation.py checks JAX's), and a crowded
    detect that grows K then adds no bucket."""
    ir, tir, params = _model(seed=42, size=64)
    img = np.random.RandomState(0).randint(0, 256, (64, 64, 3),
                                           dtype=np.uint8)
    net = pt.Net(tir, params, mode="parity", topk=8, device="cpu")
    jnet = jt.Net(ir, params, mode="parity", topk=8)
    net.warmup(topk_ladder=True)
    jnet.warmup(topk_ladder=True)
    ks = {key[3] for key in net._pipelines}
    assert ks == {key[3] for key in jnet._pipelines}
    assert {8, net._max_candidates()} <= ks and len(ks) > 2
    before = set(net._pipelines)
    dets = net.detect(img)
    assert len(dets) > 8
    assert set(net._pipelines) == before
    _assert_same([dets], [jnet.detect(img)])


@pytest.mark.parametrize("mode", ["parity", "fast"])
def test_forward_raw_matches_jax(mode):
    """The unfused forward in the net's dtype, on a preprocessed float
    input: parity to 1e-4 of each head's range, fast at bf16's one-ulp
    flips (tests/test_torch_net.py's bounds)."""
    ir, tir, params = _model(seed=42, size=64)
    x = np.random.RandomState(3).rand(2, 64, 64, 3).astype(np.float32)
    net = pt.Net(tir, params, mode=mode, device="cpu")
    got = net.forward_raw(x)
    want = jt.Net(ir, params, mode=mode).forward_raw(x)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g.dtype == (torch.float32 if mode == "parity"
                           else torch.bfloat16)
        g, w = g.float().numpy(), np.asarray(jnp.asarray(w, jnp.float32))
        assert g.shape == w.shape
        scale = np.abs(w).max()
        if mode == "parity":
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4 * scale)
        else:
            err = np.abs(g - w)
            assert err.max() <= 2 ** -3 * scale, err.max() / scale
            assert err.mean() <= 2 ** -8 * scale, err.mean() / scale


def test_memory_stats_needs_the_card(nets):
    net, _ = nets
    with pytest.raises(RuntimeError, match="CUDA allocator"):
        net.memory_stats()


def test_load_cache_dir_shares_jax_cache(tmp_path):
    """Net.load(cache_dir=) writes the entry JAX's cache writes (the same
    key and params), and each package reads the other's entry."""
    tir = pt.parse_cfg(MICRO)
    wpath = str(tmp_path / "micro.weights")
    with open(wpath, "wb") as f:
        f.write(pt.synth_weights_bytes(tir, seed=3, obj_bias=2.0))
    key = tcache.cache_key(MICRO, wpath)
    assert key == jcache.cache_key(MICRO, wpath)
    with open(wpath, "rb") as f:
        assert tcache.cache_key(MICRO, f.read()) == key
    d1 = str(tmp_path / "port")
    net = pt.Net.load(MICRO, wpath, mode="parity", cache_dir=d1,
                      device="cpu")
    assert os.listdir(d1) == [f"ffcnn-params-{key}.npz"]
    want, _ = load_weights(parse_cfg(MICRO), wpath)
    jparams, hit = jcache.load_or_build(parse_cfg(MICRO), MICRO, wpath, d1)
    assert hit
    d2 = str(tmp_path / "jax")
    jcache.load_or_build(parse_cfg(MICRO), MICRO, wpath, d2)
    tparams, hit = tcache.load_or_build(tir, MICRO, wpath, d2)
    assert hit
    for li in want:
        for f in ("weights", "scale", "bias"):
            np.testing.assert_array_equal(getattr(jparams[li], f),
                                          getattr(want[li], f))
            np.testing.assert_array_equal(getattr(tparams[li], f),
                                          getattr(want[li], f))
    w0 = net.params[0]["weights"].numpy()
    np.testing.assert_array_equal(w0, want[0].weights.transpose(3, 2, 0, 1))
    again = pt.Net.load(MICRO, wpath, mode="parity", cache_dir=d1,
                        device="cpu")
    img = _batches(1, 2, seed=4)[0]
    assert again.detect(img) == net.detect(img)


@pytest.mark.parametrize("act", [Activation.LEAKY, Activation.RELU,
                                 Activation.LINEAR])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_activate_equals_jax_bit_for_bit(act, dtype):
    """The leaky slope is 0.1 in x's dtype on both sides (0.10009765625 in
    bf16): the same products, rounded once."""
    x = (np.random.RandomState(int(act) + 1).randn(3, 9, 7, 8) * 4
         ).astype(np.float32)
    got = tact.activate(torch.from_numpy(x).to(getattr(torch, dtype)),
                        int(act))
    want = jact.activate(jnp.asarray(x, dtype), int(act))
    assert (x < 0).any() and (x > 0).any()
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(jnp.asarray(want, jnp.float32)))


@pytest.mark.parametrize("fs,stride", [(2, 2), (3, 1), (3, 2), (5, 1)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_avgpool_equals_jax_bit_for_bit(fs, stride, dtype):
    """The divisor 1/(fs*fs) in x's dtype on both sides.  Inputs on a
    grid of 1/4 in [-2, 2] make every window sum exact in any order and
    dtype, so only the divisor's product rounds."""
    x = np.random.RandomState(fs * 10 + stride).randint(
        -8, 9, (2, 11, 10, 6)).astype(np.float32) / 4
    got = tpool.avgpool2d(torch.from_numpy(x).to(getattr(torch, dtype)),
                          fs, stride)
    want = jpool.avgpool2d(jnp.asarray(x, dtype), fs, stride)
    assert (x < 0).any() and (x > 0).any()
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(jnp.asarray(want, jnp.float32)))


def test_concurrent_callers_share_one_bucket_a_key(nets):
    """Threads that ask for buckets at once get one bucket a key (the
    Net's lock around making one), and concurrent detects give each
    caller its own batch's detections, as serial ones do."""
    import concurrent.futures
    import sys
    net, _ = nets
    sizes = [(64, 64), (48, 64), (32, 48), (40, 40)]
    seen = {}

    def ask(i):
        h, w = sizes[i % len(sizes)]
        topk = 8 * (1 + i % 3)
        return (h, w, topk), id(net._pipeline_for(h, w, pt.DEFAULT_MEAN,
                                                  pt.DEFAULT_NORM, topk))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with concurrent.futures.ThreadPoolExecutor(16) as ex:
            for key, ident in ex.map(ask, range(480)):
                seen.setdefault(key, set()).add(ident)
            batches = _batches(6, 2, seed=12)
            got = list(ex.map(net.detect, batches))
    finally:
        sys.setswitchinterval(old)
    assert len(seen) == 12 and all(len(v) == 1 for v in seen.values())
    assert got == [net.detect(b) for b in batches]
