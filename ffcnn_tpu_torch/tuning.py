"""The perf knobs' resolution, the port's copy of ``ffcnn_tpu/tuning.py``'s
``get_flag``: an environment variable wins, else the code default.

The JAX package also reads a file of defaults tuned on the TPU
(``tuned_defaults.json``); a TPU's tuning says nothing about the card, so the
port reads none.
"""

from __future__ import annotations

import os


def get_flag(name: str, default: str) -> str:
    """Resolved value of a perf knob: the environment, else ``default``."""
    return os.environ.get(name, default)
