"""MoE routing: the top-1 gating rule.

Counterpart of ``top1_route`` in ``tenzing_tpu/models/moe.py`` (:71), the one
source of the routing rule for the MoE buffer builders and their expected
outputs.  The rest of that module is the multi-device expert-parallel layer,
which comes with the multi-device slice of the port.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def top1_route(x: np.ndarray, wg: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Top-1 gating in float64: (expert index, softmax gate weight) per
    token."""
    logits = x.astype(np.float64) @ wg.astype(np.float64)  # (T, E)
    expert = np.argmax(logits, axis=1)
    pz = np.exp(logits - logits.max(axis=1, keepdims=True))
    pz /= pz.sum(axis=1, keepdims=True)
    gate = pz[np.arange(len(x)), expert]
    return expert, gate
