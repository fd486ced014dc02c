"""The two Pallas probes of the backend-bug sweep, ported: each runs its
kernel (``kernels/mosaic_probes.py``) on the sweep's input and reports
``agree`` or ``differ`` against its plain version, under the sweep's
registry names.  On the card (the default):

    python -m ffcnn_tpu_torch.retest_backend_bugs
    python -m ffcnn_tpu_torch.retest_backend_bugs --only mosaic_dynslice_carry
    python -m ffcnn_tpu_torch.retest_backend_bugs --list

and ``--device cpu`` runs the plain versions against themselves.

Only these two probes of ``tools/retest_backend_bugs.py`` hold a
``pallas_call``.  The rest of that sweep is TPU/XLA tooling and stays out:
the GSPMD windowed-conv miscompile, the Mosaic and XLA-TPU compiler probes
built on jax programs (``while_dot_general_wedge``, ``minc8_aot_death``,
``vmem_160_full_block``, ``dwonly_2d_gather``), the chip-livelock
reproducers, the subprocess timeouts and the TPU health wait.  Each of them
tests a jax or TPU toolchain, which the port does not use.
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Callable, List, Optional, Sequence

import torch

from .kernels import mosaic_probes as mp


@dataclasses.dataclass(frozen=True)
class Probe:
    name: str                    # the sweep's registry name
    kernel: str                  # P4 or P5
    note: str
    make_input: Callable[[torch.device], torch.Tensor]
    run: Callable[[torch.Tensor], torch.Tensor]
    plain: Callable[[torch.Tensor], torch.Tensor]


def _arange_16x128(dtype):
    """The sweep's input: ``arange(16 * 128)`` in float32, cast to
    ``dtype``, as (16, 128)."""
    return lambda device: torch.arange(
        16 * 128, dtype=torch.float32, device=device).to(dtype).reshape(
            16, 128)


PROBES: List[Probe] = [
    Probe("mosaic_strided_load_16bit", "P4",
          "y = x[::2, :] on a bf16 (16, 128) array (a strided 16-bit load)",
          _arange_16x128(torch.bfloat16), mp.strided_rows,
          mp.strided_rows_plain),
    Probe("mosaic_dynslice_carry", "P5",
          "fori_loop(0, 3) over acc = concat(acc[i:i+8], acc[i:i+8]) on an "
          "f32 (16, 128) array (a dynamic slice of a carried value)",
          _arange_16x128(torch.float32), mp.dynslice_carry,
          mp.dynslice_carry_plain),
]


def run_probe(probe: Probe, device) -> dict:
    """The probe's kernel and plain version on its input: ``agree`` where
    they are equal bit for bit, else ``differ``."""
    x = probe.make_input(device)
    got, want = probe.run(x), probe.plain(x)
    same = got.shape == want.shape and torch.equal(got, want)
    detail = f"{tuple(got.shape)} {got.dtype}: " + (
        "equal" if same else f"not the plain {tuple(want.shape)}")
    return {"probe": probe.name, "kernel": probe.kernel,
            "status": "agree" if same else "differ", "detail": detail}


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (plain versions)")
    ap.add_argument("--only", help="run a single probe by name")
    ap.add_argument("--list", action="store_true")
    args = ap.parse_args(argv)
    if args.list:
        for p in PROBES:
            print("%-34s %-3s %s" % (p.name, p.kernel, p.note))
        return 0
    sel = [p for p in PROBES if not args.only or p.name == args.only]
    if not sel:
        ap.error(f"no probe named {args.only!r} (--list names them)")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' but CUDA is not available")
    recs = []
    for p in sel:
        recs.append(run_probe(p, device))
        print("%-34s %-3s %-6s %s" % (p.name, p.kernel, recs[-1]["status"],
                                      recs[-1]["detail"]), flush=True)
    return 0 if all(r["status"] == "agree" for r in recs) else 1


if __name__ == "__main__":
    raise SystemExit(main())
