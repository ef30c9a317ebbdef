"""Deterministic schedule featurization for the learned cost surrogate.

Counterpart of ``tenzing_tpu/learn/features.py``.  A schedule maps to a
fixed-length float vector whose coordinates are named by
:data:`FEATURE_NAMES`, the reference's list name for name and in order: a
model JSON carries the names and loading refuses a mismatch
(learn/model.py), so a model saved by either package loads in the other.

The families: op-kind counts (device ops, host data ops, each sync kind,
each transfer kind), lane occupancy (lanes used, the busiest lane's device
ops, the serial fraction), menu choices (``.pallas`` / ``.xla`` /
``.rdma`` / ``.host`` / ``bf16`` in op names), the bytes posted per engine,
the analytic makespan (bench/model.py, raw and log), and the searched
directives (chunk, fused tile and synthesized-collective directives).

On this machine ``ici_bytes`` counts the source bytes of the posts that move
data between ranks (the collectives, NCCL over NVLink between cards, and
the mesh shift over CUDA IPC between ranks sharing a card; ``ICI_KINDS``),
``pcie_bytes`` those of the pinned host spills and fetches
(``PCIE_KINDS``).  The makespan's defaults are the card's (``ModelEnv``);
a caller that passes the reference's ``ModelEnv`` values gets the
reference's vector.

Everything is a pure function of (sequence, nbytes map, ModelEnv): the
vectors computed at training time and at search time agree bit for bit.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

from tenzing_tpu_torch.bench.model import AnalyticBenchmarker, ModelEnv
from tenzing_tpu_torch.core.operation import BoundDeviceOp
from tenzing_tpu_torch.core.sequence import Sequence
from tenzing_tpu_torch.core.sync_ops import SyncOp
from tenzing_tpu_torch.ops.comm_ops import ICI_KINDS, PCIE_KINDS

# sync and transfer kinds counted one by one (an ordered vocabulary:
# appending here changes the feature contract)
_SYNC_KINDS = ("event_record", "wait_event", "event_sync", "lane_sync",
               "lane_wait")
_XFER_KINDS = ICI_KINDS + PCIE_KINDS + ("await_transfer", "multi_await")
# menu-choice markers in op names (what the searched ChoiceOps resolved to)
_CHOICE_MARKS = (".pallas", ".xla", ".rdma", ".host", "bf16")
# the searched-directive markers: copies of core/chunking.py CHUNK_MARK,
# runtime/fused.py TILE_PREFIX and collectives/synth.py SYNTH_MARK /
# SKETCHES, kept here so this module imports none of them
# (tests/test_torch_learn.py and tests/test_torch_collectives.py hold them
# equal)
_CHUNK_MARK = ".chunk.c"
_TILE_PREFIX = "fuse_tile.t"
_SYNTH_MARK = ".synth."
_SYNTH_SKETCHES = ("ring", "ringr", "rhd", "neighbor", "pipe")

FEATURE_NAMES: List[str] = (
    ["n_ops", "n_device", "n_host_data", "n_sync"]
    + [f"n_{k}" for k in _SYNC_KINDS]
    + [f"n_{k}" for k in _XFER_KINDS]
    + ["n_lanes", "lane_max_occ", "serial_frac"]
    + [f"n_choice_{m.lstrip('.')}" for m in _CHOICE_MARKS]
    + ["ici_bytes", "pcie_bytes", "analytic_makespan", "log_analytic"]
    # appended parts: the coordinates above keep their positions
    + ["n_chunk_dir", "sum_chunk_counts", "n_fuse_tile_dir",
       "sum_fuse_tiles"]
    + [f"n_synth_{s}" for s in ("dir",) + _SYNTH_SKETCHES]
    + ["sum_synth_chunks"]
)


def _reads(op) -> List[str]:
    fn = getattr(op, "reads", None)
    return list(fn()) if callable(fn) else []


def featurize(seq: Sequence, nbytes: Optional[Dict[str, int]] = None,
              env: Optional[ModelEnv] = None, cost_fn=None) -> List[float]:
    """The feature vector of ``seq``, aligned with :data:`FEATURE_NAMES`.

    ``nbytes`` (buffer name -> bytes) feeds the per-engine bytes and the
    analytic makespan; without it those fall back to per-op overheads.
    ``env`` / ``cost_fn`` configure the analytic model as
    :class:`AnalyticBenchmarker` takes them, and must be the same at
    training and at search time."""
    nbytes = nbytes if nbytes is not None else {}
    bench = AnalyticBenchmarker(nbytes, env=env, cost_fn=cost_fn)
    kind_counts: Dict[str, int] = {k: 0 for k in _SYNC_KINDS + _XFER_KINDS}
    n_device = n_host_data = n_sync = 0
    lane_occ: Dict[int, int] = {}
    choice_counts = {m: 0 for m in _CHOICE_MARKS}
    ici_bytes = pcie_bytes = 0.0
    n_chunk_dir = sum_chunks = n_tile_dir = sum_tiles = 0
    n_synth_dir = sum_synth_chunks = 0
    synth_sketch_counts = {s: 0 for s in _SYNTH_SKETCHES}
    for op in seq:
        kind = getattr(op, "KIND", "")
        if kind in kind_counts:
            kind_counts[kind] += 1
        if isinstance(op, SyncOp):
            n_sync += 1
        elif isinstance(op, BoundDeviceOp):
            n_device += 1
            lid = op.lane().id
            lane_occ[lid] = lane_occ.get(lid, 0) + 1
        elif _reads(op) or (getattr(op, "writes", None)
                            and callable(op.writes) and op.writes()):
            n_host_data += 1
        name = op.name()
        for m in _CHOICE_MARKS:
            if m in name:
                choice_counts[m] += 1
        # directives only: a chunk partial's name carries ".cNpJ", not the
        # directive mark, and a synth step "<base>.<sketch><K>.", not the
        # synth mark
        i = name.rfind(_CHUNK_MARK)
        if i >= 0:
            try:
                sum_chunks += max(1, int(name[i + len(_CHUNK_MARK):]))
                n_chunk_dir += 1
            except ValueError:
                pass
        elif name.startswith(_TILE_PREFIX):
            try:
                sum_tiles += max(1, int(name[len(_TILE_PREFIX):]))
                n_tile_dir += 1
            except ValueError:
                pass
        j = name.rfind(_SYNTH_MARK)
        if j >= 0:
            sketch, sep, cpart = name[j + len(_SYNTH_MARK):].rpartition(".c")
            if sep and sketch in synth_sketch_counts:
                try:
                    sum_synth_chunks += max(1, int(cpart))
                    synth_sketch_counts[sketch] += 1
                    n_synth_dir += 1
                except ValueError:
                    pass
        sz = float(sum(nbytes.get(n, 0) for n in _reads(op)))
        if kind in ICI_KINDS:
            ici_bytes += sz
        elif kind in PCIE_KINDS:
            pcie_bytes += sz
    makespan = bench.makespan(seq)
    lane_max = max(lane_occ.values(), default=0)
    out = [float(len(seq)), float(n_device), float(n_host_data),
           float(n_sync)]
    out += [float(kind_counts[k]) for k in _SYNC_KINDS]
    out += [float(kind_counts[k]) for k in _XFER_KINDS]
    out += [float(len(lane_occ)), float(lane_max),
            lane_max / n_device if n_device else 1.0]
    out += [float(choice_counts[m]) for m in _CHOICE_MARKS]
    out += [ici_bytes, pcie_bytes, makespan,
            math.log(max(makespan, 1e-12))]
    out += [float(n_chunk_dir), float(sum_chunks),
            float(n_tile_dir), float(sum_tiles)]
    out += [float(n_synth_dir)]
    out += [float(synth_sketch_counts[s]) for s in _SYNTH_SKETCHES]
    out += [float(sum_synth_chunks)]
    assert len(out) == len(FEATURE_NAMES)
    return out
