"""The ``ffcnn::`` ops (``ffcnn_tpu_torch/kernels/ops.py``): every kernel a
``Net`` path launches is a ``torch.library`` op whose schema, fake
implementation and CPU implementation pass ``torch.library.opcheck`` on the
CPU, at micro's widths (8 and 16 channels, small maps).  The CPU
implementation is the kernel's plain version; the fake one must give the
plain output's exact shape, dtype and strides, which ``opcheck`` holds."""

import numpy as np
import pytest
import torch

from ffcnn_tpu_torch.kernels import block_fused as bf
from ffcnn_tpu_torch.kernels import conv0_fused as c0
from ffcnn_tpu_torch.kernels import conv_int8 as ci
from ffcnn_tpu_torch.kernels import head_fused as hf
from ffcnn_tpu_torch.kernels import nms
from ffcnn_tpu_torch.kernels import ops
from ffcnn_tpu_torch.testing import cap_threads

cap_threads()

RNG = np.random.RandomState(16)
# the wrapper whose ``launches`` each op's CUDA implementation counts
WRAPPERS = {"fused_block": bf.fused_block,
            "fused_down_block": bf.fused_down_block,
            "fused_cascade": bf.fused_cascade, "fused_mega": bf.fused_mega,
            "conv0_cs": c0.conv0_cs, "head_run": hf.apply_head_run,
            "nms_keep_mask": nms.nms_keep_mask, "conv_int8": ci.conv_int8}


def _t(*shape, scale=0.3):
    return torch.from_numpy((RNG.standard_normal(shape) * scale
                             ).astype(np.float32))


def _block(c, e, p, residual=False, acts=(2, 2, 0)):
    return bf.BlockParams(w1=_t(c, e), s1=_t(e) + 1, b1=_t(e), kdw=_t(e, 9),
                          s2=_t(e) + 1, b2=_t(e), w2=_t(e, p), s3=_t(p) + 1,
                          b3=_t(p), acts=acts, residual=residual,
                          res_act=2 if residual else 0)


def _x(n, h, w, c, dtype=torch.float32):
    return _t(n, h, w, c, scale=1.0).to(dtype)


def _codes(*shape):
    return torch.from_numpy(RNG.randint(-127, 128, shape).astype(np.int8))


def _cases():
    """(op name, args) pairs covering each op's modes at micro widths."""
    b1 = _block(8, 16, 8, residual=True)
    b2 = _block(8, 16, 8, residual=True, acts=(2, 2, 2))
    down = _block(8, 16, 16)
    out = []
    for dt in (torch.float32, torch.bfloat16):
        out.append(("fused_block", (_x(2, 8, 8, 8, dt), bf._tensors([b1]),
                                    bf._meta([b1]), dt, None, None)))
        out.append(("fused_down_block", (_x(2, 8, 8, 8, dt),
                                         bf._tensors([down]),
                                         bf._meta([down]), dt, None, None)))
        out.append(("fused_cascade", (_x(2, 8, 8, 8, dt),
                                      bf._tensors([b1, b2]),
                                      bf._meta([b1, b2]), dt, None, None)))
        out.append(("fused_mega", (_x(2, 8, 8, 8, dt), bf._tensors([b1, b2]),
                                   bf._meta([b1, b2]))))
    # an int8 plan's boundaries: codes in, codes out
    out.append(("fused_block", (_codes(2, 8, 8, 8), bf._tensors([b1]),
                                bf._meta([b1]), torch.bfloat16, 0.05, 0.04)))
    out.append(("fused_cascade", (_codes(2, 8, 8, 8), bf._tensors([b1, b2]),
                                  bf._meta([b1, b2]), torch.bfloat16, 0.05,
                                  None)))
    cp = c0.conv0_params_from(_t(8, 3, 3, 3), _t(8) + 1, _t(8), 2)
    x8 = torch.from_numpy(RNG.randint(0, 256, (2, 16, 16, 3)
                                      ).astype(np.uint8))
    for dt in (torch.float32, torch.bfloat16):
        out.append(("conv0_cs", (x8, cp.wm, cp.whi, cp.wlo, cp.scale,
                                 cp.bias, cp.act, dt)))
    hp = hf.HeadParams((hf.HeadStage("dw", 3, 2, _t(8, 9), _t(8) + 1, _t(8)),
                        hf.HeadStage("pw", 1, 0, _t(8, 12), _t(12) + 1,
                                     _t(12))), 4, 4)
    for dt in (torch.float32, torch.bfloat16):
        out.append(("head_run", (_x(2, 4, 4, 8, dt),
                                 [s.w for s in hp.stages],
                                 [s.scale for s in hp.stages],
                                 [s.bias for s in hp.stages], hf._meta(hp))))
    boxes = torch.sort(_t(2, 16, 4, scale=4.0), dim=-1).values
    scores = torch.sort(torch.rand(2, 16), dim=1, descending=True).values
    classes = torch.from_numpy(RNG.randint(0, 3, (2, 16)).astype(np.int32))
    for union in (False, True):
        out.append(("nms_keep_mask", (boxes, scores, classes, 0.45, union)))
    dense = ci.prepare(_codes(3, 3, 8, 16), 0.05, np.full(16, 0.01),
                       _t(16), stride=2, pad=1, groups=1, act=2,
                       out_scale=0.1)
    dw = ci.prepare(_codes(3, 3, 1, 8), 0.05, np.full(8, 0.01), _t(8),
                    stride=1, pad=1, groups=8, act=0)
    u8 = ci.prepare_conv0(_t(3, 3, 3, 8), _t(8) + 1, _t(8), h=16, w=16,
                          stride=2, pad=1, act=2)
    for x, cp_, raw in ((_codes(2, 8, 8, 8), dense, False),
                        (_codes(2, 8, 8, 8), dense, True),
                        (_codes(2, 8, 8, 8), dw, False), (x8, u8, False),
                        (x8, u8, True)):
        out.append(("conv_int8", (x, cp_.wq, cp_.wp, cp_.eff, cp_.bias,
                                  cp_.inv, cp_.m128, cp_.stride, cp_.pad,
                                  cp_.groups, cp_.act, cp_.kp,
                                  torch.bfloat16, raw)))
    return out


CASES = _cases()


def test_every_net_kernel_is_an_op():
    """The registry holds the eight launches a Net makes, each in the
    ffcnn namespace, each with a CPU, a CUDA and a fake implementation."""
    assert sorted(ops.OPS) == sorted(
        ["fused_block", "fused_down_block", "fused_cascade", "fused_mega",
         "conv0_cs", "head_run", "nms_keep_mask", "conv_int8"])
    for name, op in ops.OPS.items():
        assert op is getattr(torch.ops.ffcnn, name).default
        for key in ("CPU", "CUDA", "Meta"):
            assert torch._C._dispatch_has_kernel_for_dispatch_key(
                op.name(), key), (name, key)
        assert WRAPPERS[name].launches == 0
    assert {n for n, _ in CASES} == set(ops.OPS)


@pytest.mark.parametrize("name,args", CASES,
                         ids=[f"{n}-{i}" for i, (n, _) in enumerate(CASES)])
def test_opcheck(name, args):
    """Schema, fake implementation and dispatch of each op on the CPU."""
    torch.library.opcheck(ops.OPS[name], args)


@pytest.mark.parametrize("name,args", CASES[:4],
                         ids=[n for n, _ in CASES[:4]])
def test_op_equals_plain_version(name, args):
    """Through the op, a CPU tensor reaches the kernel's plain version and
    no launch is counted."""
    got = ops.OPS[name](*args)
    bps = bf._rebuild(args[1], args[2])
    x = args[0]
    want = {"fused_block": lambda: bf.block_plain(x, bps[0], args[3]),
            "fused_down_block": lambda: bf.block_down_plain(x, bps[0],
                                                            args[3]),
            "fused_cascade": lambda: bf.chain_plain(x, bps, args[3]),
            "fused_mega": lambda: bf.chain_plain(x, bps)}[name]()
    assert torch.equal(got, want)
    assert WRAPPERS[name].launches == 0


def test_meta_tensors_are_refused():
    """No fallback: a tensor neither on the CPU nor on the card raises, even
    where the fake implementation would give a shape."""
    x = torch.empty((1, 8, 8, 8), device="meta")
    b1 = _block(8, 16, 8)
    with pytest.raises(ValueError, match="takes CPU or CUDA"):
        bf.fused_block(x, b1)
