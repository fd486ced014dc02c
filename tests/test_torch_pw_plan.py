"""The launch plan of P1/P2's streaming kernel (``kernels/pw_matmul.py``
``plan``), on the CPU: every row is covered exactly once, only the two
compiled shapes are taken, the shared memory fits an H100, and the plan
mirrors ``Shape<K, N>`` in ``csrc/pw_matmul.cu``."""

import os
import re

import numpy as np
import pytest
import torch

from ffcnn_tpu_torch.kernels import pw_matmul as pw
from ffcnn_tpu_torch.testing import cap_threads

cap_threads()

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "ffcnn_tpu_torch", "csrc", "pw_matmul.cu")
TOOL_M = {(8, 32): 256 * 80 * 80, (128, 512): 256 * 80 * 80 // 16}
H100_SMS = 132
SM_SMEM = 233472          # shared memory of an SM, 228 KB
SM_THREADS = 2048


@pytest.mark.parametrize("shape", list(pw.SHAPES), ids=["P1", "P2"])
@pytest.mark.parametrize("m", [0, 1, 15, 16, 17, 1000, "M-1", "M"])
def test_plan_covers_every_row_once(shape, m):
    m = {"M": TOOL_M[shape], "M-1": TOOL_M[shape] - 1}.get(m, m)
    k, n = shape
    p = pw.plan(m, k, n, H100_SMS)
    assert p.variant == pw.SHAPES[shape][0]
    assert p.ctas <= H100_SMS * p.per_sm
    seen = np.zeros(m, np.int32)
    for tiles in p.tiles(m):
        assert len(tiles) >= 1          # no CTA without work
        for t in tiles:
            seen[t * p.rows:min((t + 1) * p.rows, m)] += 1
    assert (seen == 1).all()
    assert p.ctas == (0 if m == 0 else len(p.tiles(m)))


@pytest.mark.parametrize("sms", [1, 114, 132])
def test_plan_fills_the_card_at_the_tools_size(sms):
    for (k, n), m in TOOL_M.items():
        p = pw.plan(m, k, n, sms)
        assert p.ctas == sms * p.per_sm


@pytest.mark.parametrize("shape", [(8, 64), (16, 32), (128, 256),
                                   (8, 512), (0, 0)])
def test_plan_refuses_other_shapes(shape):
    with pytest.raises(ValueError, match="compiled"):
        pw.plan(1000, *shape, H100_SMS)


@pytest.mark.parametrize("shape", list(pw.SHAPES), ids=["P1", "P2"])
def test_plan_fits_an_sm(shape):
    p = pw.plan(TOOL_M[shape], *shape, H100_SMS)
    assert p.smem <= pw.SMEM_LIMIT
    assert p.smem * p.per_sm <= SM_SMEM
    assert p.threads * p.per_sm <= SM_THREADS
    assert p.threads == 32 * (pw.CONSUMER_WARPS + 1)


def _shape_constants(src, k, n):
    """Shape<k, n>'s integer constants."""
    body = re.search(rf"struct Shape<{k}, {n}> {{(.*?)\n}};", src, re.S)
    return {name: eval(expr, {}) for name, expr in
            re.findall(r"(k\w+) = ([\d +*]+)[,;]", body.group(1))}


@pytest.mark.parametrize("shape", list(pw.SHAPES), ids=["P1", "P2"])
def test_plan_mirrors_the_source(shape):
    """SHAPES and the kernel's constants are the source's own."""
    src = open(SRC).read()
    assert f"constexpr int kConsumers = {pw.CONSUMER_WARPS};" in src
    assert f"constexpr int kBarBytes = {pw.BAR_BYTES};" in src
    c = _shape_constants(src, *shape)
    _, rows, stages, pitch, w_bytes, stg_bytes, per_sm = pw.SHAPES[shape]
    assert (c["kRows"], c["kStages"], c["kPitch"], c["kWBytes"],
            c["kStgBytes"], c["kPerSm"]) == (rows, stages, pitch, w_bytes,
                                             stg_bytes, per_sm)


def test_pw_matmul_refuses_a_shape_off_the_cpu_before_launching():
    """No fallback: tensors off the CPU that the kernel cannot take raise
    and count no launch."""
    pw.pw_matmul.launches = 0
    meta = dict(device="meta", dtype=torch.bfloat16)
    for xs, ws in (((1000, 8), (8, 64)), ((1000, 16), (16, 32)),
                   ((1000, 8), (16, 32))):
        with pytest.raises(ValueError):
            pw.pw_matmul(torch.empty(xs, **meta), torch.empty(ws, **meta))
    assert pw.pw_matmul.launches == 0


@pytest.mark.parametrize("shape", [(8, 64), (16, 32), (8, 32)])
def test_pw_matmul_on_the_cpu_is_the_plain_version(shape):
    """CPU tensors take ``pw_matmul_plain`` at any shape, and count no
    launch."""
    pw.pw_matmul.launches = 0
    rng = np.random.RandomState(3)
    x = torch.from_numpy(rng.randn(37, shape[0]).astype(np.float32)).to(
        torch.bfloat16)
    w = torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(
        torch.bfloat16)
    assert torch.equal(pw.pw_matmul(x, w), x.float() @ w.float())
    assert pw.pw_matmul.launches == 0
