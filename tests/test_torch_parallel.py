"""The port's multi-device package (``ffcnn_tpu_torch/parallel/``) against
the JAX package's (``ffcnn_tpu/parallel/``) on the CPU: the port's meshes
are lists of ``cpu`` slots (``["cpu"] * 8``), JAX's its 8 host devices
(conftest).  Models: ``models/ffcnn-micro.cfg`` at 64x64 with synthesized
weights (seed 42) and ``tests/test_sharding.py``'s 8-layer graph (copied
here), on seeded uint8 frames.

Detections are held as ``tests/_mp_worker.py`` holds them: per image the
same count, and the same (class, integer box) set, scores within 1e-5."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import conftest  # noqa: F401  (JAX's 8 CPU devices)
import ffcnn_tpu_torch as pt
from ffcnn_tpu import Net as JNet
from ffcnn_tpu import parallel as jpar
from ffcnn_tpu.darknet import parse_cfg as jparse
from ffcnn_tpu.darknet.weights import (load_weights, synth_weights_bytes,
                                       zero_weights)
from ffcnn_tpu.graph.build import params_to_pytree
from ffcnn_tpu.quant import build_plan
from ffcnn_tpu_torch import parallel as tpar
from ffcnn_tpu_torch.graph.build import params_from_numpy
from ffcnn_tpu_torch.parallel import dp as tdp
from ffcnn_tpu_torch.parallel import mesh as tmesh
from ffcnn_tpu_torch.quant import plan_from_numpy
from ffcnn_tpu_torch.testing import cap_threads

cap_threads()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MICRO = os.path.join(REPO, "models", "ffcnn-micro.cfg")
CFGS = sorted(os.path.join(REPO, "models", f)
              for f in os.listdir(os.path.join(REPO, "models"))
              if f.endswith(".cfg"))
HIGHEST = jax.lax.Precision.HIGHEST
MEAN, NORM = (0.0, 0.0, 0.0), (1 / 255.0,) * 3

# tests/test_sharding.py's graph: every layer type but avgpool
TINY_CFG = """
[net]
width=64
height=64
channels=3

[convolutional]
batch_normalize=1
filters=8
size=3
stride=2
pad=1
activation=leaky

[convolutional]
filters=8
size=3
stride=1
pad=1
groups=8
activation=leaky

[shortcut]
from=-2
activation=linear

[maxpool]
size=3
stride=1

[route]
layers=-1,-3

[upsample]
stride=2

[dropout]
probability=.2

[convolutional]
filters=255
size=1
stride=1
pad=1
activation=linear

[yolo]
mask = 0,1,2
anchors = 10,14, 23,27, 37,58, 81,82, 135,169, 344,319
classes=80
ignore_thresh=.45
"""


def _tiny():
    """(JAX IR, port IR, numpy params), seeded as test_sharding.py's."""
    return _random_params(TINY_CFG)


# grouped convs whose model slices keep whole groups (6 groups of 2
# filters over 2 slots) or split one (3 groups of 4), under a 2x2 pool
GROUPED_CFG = TINY_CFG.split("[convolutional]\nfilters=8\nsize=3")[0] + """
[convolutional]
batch_normalize=1
filters=12
size=3
stride=1
pad=1
groups=2
activation=leaky

[convolutional]
filters=12
size=3
stride=1
pad=1
groups=3
activation=leaky

[maxpool]
size=2
stride=2

[convolutional]
filters=12
size=1
stride=1
groups=6
activation=leaky

[convolutional]
filters=255
size=1
stride=1
activation=linear
""" + "[yolo]" + TINY_CFG.split("[yolo]")[1]


def _random_params(cfg_text):
    ir = jparse(cfg_text, is_path=False)
    params = zero_weights(ir)
    rng = np.random.RandomState(0)
    for p in params.values():
        p.weights[...] = rng.randn(*p.weights.shape).astype(np.float32) * 0.3
        p.bias[...] = rng.randn(*p.bias.shape).astype(np.float32) * 0.1
    return ir, pt.parse_cfg(cfg_text, is_path=False), params


def _micro(size=64, seed=42):
    ir = jparse(MICRO, size, size)
    params, _ = load_weights(ir, synth_weights_bytes(ir, seed=seed,
                                                     obj_bias=2.0))
    return ir, pt.parse_cfg(MICRO, size, size), params


MODELS = {"tiny": _tiny, "micro": _micro,
          "grouped": lambda: _random_params(GROUPED_CFG)}


def _frames(n, h=64, w=64, seed=1):
    rng = np.random.RandomState(seed)
    return rng.randint(0, 256, (n, h, w, 3), dtype=np.uint8)


def _np(res):
    return [np.asarray(t.cpu() if isinstance(t, torch.Tensor) else t)
            for t in res]


def _dets(res):
    """Per image: sorted (class, integer box, score) of its live slots."""
    boxes, scores, classes, count, _ = _np(res)
    out = []
    for i in range(scores.shape[0]):
        live = scores[i] > 0
        assert live.sum() == count[i]
        out.append(sorted(
            (int(c), tuple(int(v) for v in b), float(s))
            for c, b, s in zip(classes[i][live], boxes[i][live],
                               scores[i][live])))
    return out


def assert_same_detections(got, want, tol=1e-5):
    g, w = _dets(got), _dets(want)
    assert len(g) == len(w)
    for i, (a, b) in enumerate(zip(g, w)):
        assert len(a) == len(b), (i, len(a), len(b))
        for x, y in zip(a, b):
            assert x[:2] == y[:2], (i, x, y)
            assert abs(x[2] - y[2]) <= tol, (i, x, y)
    assert sum(map(len, w)) > 0            # the test compares something


def _cpu(n):
    return [torch.device("cpu")] * n


# ---------------------------------------------------------------- mesh
MESH_CASES = [{}, {"model_parallel": 2}, {"spatial_parallel": 2},
              {"spatial_parallel": 4}, {"model_parallel": 2,
                                        "spatial_parallel": 2},
              {"pipeline_parallel": 4}, {"pipeline_parallel": 2,
                                         "model_parallel": 2}]


@pytest.mark.parametrize("kw", MESH_CASES, ids=str)
def test_make_mesh_axes_equal_jax(kw):
    """Axis names, sizes and the device order: eight distinct cards
    (``torch.device('cuda', i)``, named, not touched) land where JAX's
    eight devices land."""
    want = jpar.make_mesh(**kw)
    got = tpar.make_mesh([torch.device("cuda", i) for i in range(8)], **kw)
    assert got.axis_names == tuple(want.axis_names)
    assert got.shape == dict(want.shape)
    ids = np.vectorize(lambda d: d.id)(want.devices)
    assert np.array_equal(np.vectorize(lambda d: d.index)(got.devices), ids)


@pytest.mark.parametrize("n,kw", [(6, {"model_parallel": 4}),
                                  (8, {"spatial_parallel": 3}),
                                  (8, {"pipeline_parallel": 3,
                                       "model_parallel": 2})])
def test_make_mesh_errors_equal_jax(n, kw):
    with pytest.raises(ValueError) as want:
        jpar.make_mesh(jax.devices()[:n], **kw)
    with pytest.raises(ValueError) as got:
        tpar.make_mesh(_cpu(n), **kw)
    assert str(got.value) == str(want.value)


def test_default_mesh_without_a_card_raises(monkeypatch):
    """No devices and no card: a RuntimeError, never a CPU mesh."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no(ne| CUDA)"):
        tpar.make_mesh()
    with pytest.raises(RuntimeError):
        tmesh.slot_devices("cuda")
    assert tmesh.slot_devices("cpu") == _cpu(1)


def test_shardings_describe_the_split():
    m = tpar.make_mesh(_cpu(8))
    assert tpar.activation_sharding(m) == tpar.batch_sharding(m)
    m2 = tpar.make_mesh(_cpu(8), spatial_parallel=2)
    assert tpar.activation_sharding(m2) != tpar.batch_sharding(m2)
    assert tpar.activation_sharding(m2).spec == ("data", "spatial")
    assert tpar.replicated(m2).spec == ()
    assert m2.shape == {"data": 4, "spatial": 2, "model": 1}
    # the blocks each slot holds, and its part placed
    acts = tpar.activation_sharding(m2)
    assert [acts.block(0, 8, d) for d in range(4)] == \
        [(0, 2), (2, 4), (4, 6), (6, 8)]
    assert acts.block(2, 5, 1) == (0, 5)          # W: whole
    x = torch.arange(8 * 5 * 2).reshape(8, 5, 2)
    assert torch.equal(acts.shard(x, (1, 1, 0)), x[2:4, 3:5])
    assert torch.equal(tpar.replicated(m2).shard(x, (3, 1, 0)), x)


# ------------------------------------------------------- plan_stages
@pytest.mark.parametrize("n_stages", [2, 3, 4])
@pytest.mark.parametrize("cfg", CFGS, ids=os.path.basename)
def test_plan_stages_equal_jax(cfg, n_stages):
    """Cut for cut and live set for live set (IR math only)."""
    want = jpar.plan_stages(jparse(cfg), n_stages)
    got = tpar.plan_stages(pt.parse_cfg(cfg), n_stages)
    assert [(s.start, s.stop, s.live_in, s.live_out) for s in got] == \
        [(s.start, s.stop, s.live_in, s.live_out) for s in want]


def test_plan_stages_refusals_equal_jax():
    jir, tir, _ = _micro()
    for n in (0, 1000):
        with pytest.raises(ValueError) as want:
            jpar.plan_stages(jir, n)
        with pytest.raises(ValueError) as got:
            tpar.plan_stages(tir, n)
        assert str(got.value) == str(want.value)
    headless = pt.parse_cfg(TINY_CFG.split("[yolo]")[0], is_path=False)
    with pytest.raises(ValueError, match="yolo head"):
        tpar.plan_stages(headless, 2)


# ----------------------------------------------- the sharded pipeline
SHARD_CASES = {"dp": {}, "sp2": {"spatial_parallel": 2},
               "sp4": {"spatial_parallel": 4},
               "tp2": {"model_parallel": 2},
               "3d": {"model_parallel": 2, "spatial_parallel": 2}}


@pytest.mark.parametrize("kind", ["tp2", "3d"])
@pytest.mark.parametrize("model", sorted(MODELS))
def test_tp_report_equals_jax(model, kind):
    """``place_params.report``, layer for layer: the filters % model
    fallback and the windowed-dense-conv fallback under SP."""
    jir, tir, params = MODELS[model]()
    kw = SHARD_CASES[kind]
    _, jplace = jpar.build_sharded_pipeline(
        jir, jpar.make_mesh(**kw), 64, 64, dtype=jnp.float32,
        shard_filters=True)
    _, tplace = tpar.build_sharded_pipeline(
        tir, tpar.make_mesh(_cpu(8), **kw), 64, 64, dtype=torch.float32,
        shard_filters=True)
    jplace(params_to_pytree(params))
    tplace(params_from_numpy(params))
    assert tplace.report == jplace.report
    assert tplace.report["sharded"]
    # the tiny head's 255 filters, micro's windowed dense convs under SP
    assert tplace.report["replicated"] or (model, kind) == ("micro", "tp2")


@pytest.mark.parametrize("kind", sorted(SHARD_CASES))
@pytest.mark.parametrize("model", sorted(MODELS))
def test_sharded_parity_equals_jax(model, kind):
    """DP, SP over 2 and 4 row blocks (micro's 2x2 maps leave SP-4 slots
    with no rows), TP over 2 and the 3-D mesh, in float32, against JAX's
    ``build_sharded_pipeline`` on the same mesh shape over its 8 CPU
    devices; 48x64 frames, so the letterbox pads rows.  The grouped graph
    under TP is held to JAX's one-device pipeline instead: JAX's own
    filter-sharded program gives other detections there than its
    one-device program does (ROADMAP Queue 3)."""
    jir, tir, params = MODELS[model]()
    kw = SHARD_CASES[kind]
    tp = "model_parallel" in kw
    frames = _frames(8, 48, 64, seed=3)
    jmesh = (jpar.make_mesh(jax.devices()[:1]) if tp and model == "grouped"
             else jpar.make_mesh(**kw))
    jfn, jplace = jpar.build_sharded_pipeline(
        jir, jmesh, 48, 64, dtype=jnp.float32, precision=HIGHEST,
        shard_filters=tp)
    want = jfn(jplace(params_to_pytree(params)), jnp.asarray(frames),
               jnp.zeros(3), jnp.full(3, 1 / 255.0))
    fn, place = tpar.build_sharded_pipeline(
        tir, tpar.make_mesh(_cpu(8), **kw), 48, 64, dtype=torch.float32,
        shard_filters=tp)
    got = fn(place(params_from_numpy(params)), frames, MEAN, NORM)
    assert_same_detections(got, want)


def test_sp_row_blocks_and_window_rows():
    """Every slot agrees on who owns which row (blocks of ceil(h / 4) rows:
    at 2 rows over 4 slots two own none), and the rows a window reads:
    aligned down to its stride, one spare output above, clipped to the
    image, a pool reaching its own output count.  The parity cases above
    hold the result at micro's stride-2 layers, its upsample -> route join
    and its 2x2 head maps."""
    rows = tpar.activation_sharding(tpar.make_mesh(_cpu(4),
                                                   spatial_parallel=4))
    assert [rows.block(1, 10, i) for i in range(4)] == \
        [(0, 3), (3, 6), (6, 9), (9, 10)]
    assert [rows.block(1, 2, i) for i in range(4)] == \
        [(0, 1), (1, 2), (2, 2), (2, 2)]
    # a 3x3/s2/p1 conv's output rows 3-5 read input rows 5-11; the rows
    # start at 4 = 2 x (3 - 1), one spare output above row 3
    assert tdp._window_rows(3, 2, 1, 3, 6, 20) == (4, 12, 2)
    # the first block reads from the image's top, which the layer pads
    assert tdp._window_rows(3, 2, 1, 0, 3, 20) == (0, 6, 0)
    # and the last stops at its bottom
    assert tdp._window_rows(3, 2, 1, 8, 10, 20) == (14, 20, 7)
    # a 2x2/s2 maxpool's output rows 1-2 of 3 read rows 2-5
    assert tdp._window_rows(2, 2, 0, 1, 3, 7, cover=6) == (2, 6, 1)


@pytest.mark.parametrize("kind", ["dp", "tp2"])
def test_sharded_int8_equals_jax(kind):
    """An int8 plan composes with DP (micro, the plan JAX's ``Net``
    calibrates; tests/test_sharding.py's DP case) and with TP (the tiny
    graph, ``build_plan`` at 0.1; its TP case): the port takes JAX's plan
    (``plan_from_numpy``) and gives its detections."""
    if kind == "dp":
        jir, tir, params = _micro()
        jnet = JNet(jir, params, mode="int8")
        jnet.calibrate(_frames(4, seed=5))
        plan = jnet.quant
    else:
        jir, tir, params = _tiny()
        plan = build_plan(jir, params_to_pytree(params),
                          np.full(len(jir.blobs), 0.1, np.float32))
    kw = SHARD_CASES[kind]
    tp = kind == "tp2"
    frames = _frames(8, seed=6)
    jfn, jplace = jpar.build_sharded_pipeline(
        jir, jpar.make_mesh(**kw), 64, 64, dtype=jnp.float32,
        precision=HIGHEST, shard_filters=tp, quant=plan)
    want = jfn(jplace(params_to_pytree(params)), jnp.asarray(frames),
               jnp.zeros(3), jnp.full(3, 1 / 255.0))
    fn, place = tpar.build_sharded_pipeline(
        tir, tpar.make_mesh(_cpu(8), **kw), 64, 64, dtype=torch.float32,
        shard_filters=tp, quant=plan_from_numpy(plan))
    got = fn(place(params_from_numpy(params)), frames, MEAN, NORM)
    assert_same_detections(got, want)


# ------------------------------------------------------- DP over replicas
def _fast_net(mode="fast", topk=128):
    _, tir, params = _micro()
    return pt.Net(tir, params, mode=mode, topk=topk, device="cpu")


def test_dp_pipeline_equals_the_net_bit_for_bit():
    """Four replicas of a fast micro Net on CPU slots against the Net on
    the whole batch: bit for bit, since on the CPU every kernel's plain
    version computes each image alone, whatever the batch; and each
    replica shares the Net's params and plan."""
    net = _fast_net()
    frames = _frames(8, seed=7)
    mesh = tpar.make_mesh(_cpu(4))
    reps = tdp.dp_replicas(net, mesh)
    assert reps[0] is net and len({id(r) for r in reps}) == 4
    assert all(r.params[0]["weights"] is net.params[0]["weights"]
               and r._fused_runs == net._fused_runs for r in reps[1:])
    got = tpar.build_dp_pipeline(net, mesh, 64, 64, replicas=reps)(frames)
    want = net.detect_device(frames)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert int(want.count.sum()) > 0
    with pytest.raises(ValueError, match="multiple"):
        tpar.build_dp_pipeline(net, mesh, 64, 64, replicas=reps)(frames[:6])


@pytest.mark.filterwarnings("ignore:NMS top-k saturated")
def test_dpnet_pads_streams_and_dumps():
    """A batch that needs padding (7 over 4 slots), ``detect_stream`` and
    the single frame all give ``Net.detect``'s detections; ``dump`` adds
    JAX's mesh line."""
    net = _fast_net()
    dpn = tpar.DPNet(net, tpar.make_mesh(_cpu(4)))
    frames = _frames(7, seed=8)
    want = net.detect(frames)
    assert dpn.detect(frames) == want
    assert dpn.detect(frames[0]) == want[0]
    assert list(dpn.detect_stream([frames, frames[:3]], depth=2)) == \
        [want, want[:3]]
    assert dpn.dump() == net.dump() + ("dp mesh: {'data': 4, 'spatial': 1, "
                                       "'model': 1} (4-way data parallel)\n")
    assert dpn.ir is net.ir


def test_dpnet_grows_k_in_parity_and_warns_in_fast():
    """``finish``'s policy: parity grows K and re-dispatches (the same
    detections as ``Net.detect``, which grows K too); fast warns."""
    frames = _frames(4, seed=9)
    net = _fast_net("parity", topk=4)
    dpn = tpar.DPNet(net, tpar.make_mesh(_cpu(2)))
    assert bool(net.detect_device(frames).saturated.any())
    assert dpn.detect(frames) == net.detect(frames)
    assert {k[3] for r in dpn.replicas for k in r._pipelines} > {4}
    fast = tpar.DPNet(_fast_net("fast", topk=4), tpar.make_mesh(_cpu(2)))
    with pytest.warns(RuntimeWarning, match="saturated"):
        fast.detect(frames)


def test_dpnet_warmup_builds_every_replica_bucket():
    net = _fast_net("parity", topk=16)
    dpn = tpar.DPNet(net, tpar.make_mesh(_cpu(2)))
    dpn.warmup(batch_sizes=[1, 3], topk_ladder=True)
    ks = {16, 64}
    while max(ks) < net._max_candidates():
        ks.add(min(net._max_candidates(), max(ks) * 4))
    for r in dpn.replicas:
        assert {(k[0], k[1], k[3]) for k in r._pipelines} == \
            {(64, 64, k) for k in ks}


def test_dp_refusals_and_no_fallback():
    """Pure DP refuses TP/SP meshes with JAX's words; an int8 Net needs its
    plan; a CUDA mesh with no card raises (no shard runs on the CPU); a
    mesh mixing the CPU and a card is refused."""
    net = _fast_net()
    for kw in ({"model_parallel": 2}, {"spatial_parallel": 2}):
        with pytest.raises(ValueError, match="pure-DP"):
            tpar.build_dp_pipeline(net, tpar.make_mesh(_cpu(4), **kw), 64, 64)
    _, tir, params = _micro()
    with pytest.raises(ValueError, match="int8"):
        tpar.build_dp_pipeline(pt.Net(tir, params, mode="int8",
                                      device="cpu"),
                               tpar.make_mesh(_cpu(2)), 64, 64)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tpar.build_dp_pipeline(net, tpar.make_mesh(
                [torch.device("cuda", 0)] * 2), 64, 64)
    with pytest.raises(ValueError, match="mixes"):
        tdp.dp_replicas(net, tpar.make_mesh(
            [torch.device("cpu"), torch.device("cuda", 0)]))


# ------------------------------------------------------------------ PP
PP_CASES = {"pipe_only": (4, {"pipeline_parallel": 4}, 4, 8),
            "data_x_pipe": (8, {"pipeline_parallel": 4}, 2, 8),
            "more_microbatches": (2, {"pipeline_parallel": 2}, 6, 6)}


@pytest.mark.parametrize("case", sorted(PP_CASES) + ["random_graph"])
def test_pp_equals_jax(case):
    """GPipe over 2 or 4 stages on micro (a data x pipe mesh, more
    microbatches than stages) and over 2 stages on one random graph of
    tests/test_random_graphs.py, against JAX's ``build_pp_pipeline`` on
    the same mesh shape, float32, 96x80 frames."""
    if case == "random_graph":
        from test_random_graphs import SIZE, _gen_cfg
        seed = 23
        text = _gen_cfg(np.random.RandomState(seed))
        jir = jparse(text, SIZE, SIZE, is_path=False)
        tir = pt.parse_cfg(text, SIZE, SIZE, is_path=False)
        params, _ = load_weights(jir, synth_weights_bytes(
            jir, seed=seed, obj_bias=1.5))
        ndev, kw, nmb, n = 2, {"pipeline_parallel": 2}, 2, 4
        h = w = SIZE
    else:
        jir, tir, params = _micro()
        ndev, kw, nmb, n = PP_CASES[case]
        h, w = 96, 80
    frames = _frames(n, h, w, seed=11)
    jfn = jpar.build_pp_pipeline(
        jir, params_to_pytree(params), jpar.make_mesh(jax.devices()[:ndev],
                                                      **kw),
        h, w, n_microbatches=nmb, topk=64, precision=HIGHEST)
    want = jfn(jnp.asarray(frames))
    mesh = tpar.make_mesh(_cpu(ndev), **kw)
    fn = tpar.build_pp_pipeline(tir, params_from_numpy(params), mesh, h, w,
                                n_microbatches=nmb, topk=64)
    got = fn(frames)
    assert_same_detections(got, want)
    assert np.array_equal(_np(got)[4], np.asarray(want.saturated))


def test_pp_refusals():
    _, tir, params = _micro()
    p = params_from_numpy(params)
    with pytest.raises(ValueError, match="no 'pipe' axis"):
        tpar.build_pp_pipeline(tir, p, tpar.make_mesh(_cpu(2)), 64, 64,
                               n_microbatches=2)
    fn = tpar.build_pp_pipeline(
        tir, p, tpar.make_mesh(_cpu(2), pipeline_parallel=2), 64, 64,
        n_microbatches=2)
    with pytest.raises(ValueError, match="n_microbatches"):
        fn(_frames(3))


def test_the_import_scan_covers_the_package():
    """``tests/test_torch_host.py`` scans every port file's imports; the
    parallel package's files are among them."""
    import test_torch_host
    scanned = {os.path.relpath(p, REPO) for p in test_torch_host._port_files()}
    for name in ("__init__", "mesh", "dp", "pp", "multiprocess"):
        assert os.path.join("ffcnn_tpu_torch", "parallel",
                            name + ".py") in scanned
