"""Analytic cost-model benchmarker: a schedule's modeled makespan, with no
device.

Counterpart of ``tenzing_tpu/bench/model.py``: a deterministic machine
model that maps a schedule to a modeled makespan, usable wherever a
benchmarker is (DFS, MCTS, the hill-climbs); the parallel dryrun scores the
multi-device schedules with it where wall clock over gloo means nothing.

Machine model (the stream executor's semantics, abstracted):

* each ``Lane`` is a serial queue with its own clock (one CUDA stream);
* a ``BoundDeviceOp`` starts at max(lane clock, readiness of every buffer it
  reads) and runs ``op_overhead`` plus its bytes moved over ``hbm_bw`` (plus
  ``cost_flops()`` over ``flops_peak`` when the op declares it); its writes
  are ready at its end;
* a transfer post occupies a serial *engine*: ``"ici"`` for the collectives
  and the shifts (``ICI_KINDS``: a hop's latency plus its source bytes over
  ``ici_bw``), ``"pcie"`` for the host spill and fetch (``PCIE_KINDS``); it
  starts at max(engine clock, source readiness) and blocks no lane;
* ``AwaitTransfer`` / ``MultiAwait`` join the host: every lane clock moves to
  the awaited buffer's readiness;
* the sync ops: ``EventRecord`` stamps, ``WaitEvent`` and ``LaneWait`` join
  lanes, ``LaneSync`` and ``EventSync`` join the host.

On this machine the "ici" engine is what moves data between ranks: NCCL
over NVLink between cards, and the CUDA-IPC shift (ops/rdma.py) between
ranks that share one card; "pcie" is the pinned host path.

The defaults (:class:`ModelEnv`) are the card's, each from one source: the
H100 SXM's HBM rate and dense bf16 peak (bench/roofline.py's data-sheet
constants); the pinned host copy rate and the per-op dispatch from the
chunk constants ``chip_smoke.py`` measured on the card (roofline.XFER_GBS
and CHUNK_DISPATCH_US: 44.54-48.70 GB/s and 23.70-25.12 µs over the
records, PERF.md); and the NVLink rate of the H100 SXM's data sheet
(roofline.EXCHANGE_GBS), which is not a measurement: every record has one
GPU.  A post's latency is the same per-op dispatch (a post is one host
dispatch on the stream executor).  None is a TPU figure.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional

from tenzing_tpu_torch.bench import roofline
from tenzing_tpu_torch.bench.benchmarker import BenchOpts, BenchResult
from tenzing_tpu_torch.core.operation import BoundDeviceOp
from tenzing_tpu_torch.core.sequence import Sequence
from tenzing_tpu_torch.core.sync_ops import (
    EventRecord,
    EventSync,
    LaneSync,
    LaneWait,
    WaitEvent,
)
from tenzing_tpu_torch.ops.comm_ops import ICI_KINDS, PCIE_KINDS


@dataclass(frozen=True)
class ModelEnv:
    """Machine parameters of the analytic model (seconds, bytes/s, FLOP/s;
    module docstring)."""

    # HBM3 of an H100 SXM (data sheet; bench/roofline.py)
    hbm_bw: float = roofline.H100_PEAK_HBM_BYTES
    # NVLink of an H100 SXM, each way per card (data sheet; not measured:
    # every record has one GPU)
    ici_bw: float = roofline.EXCHANGE_GBS * 1e9
    # a post is one host dispatch: the card's measured per-op dispatch
    ici_lat: float = roofline.CHUNK_DISPATCH_US * 1e-6
    # the pinned host <-> device copy rate measured on the card
    pcie_bw: float = roofline.XFER_GBS * 1e9
    # the card's measured per-op dispatch on the stream executor
    op_overhead: float = roofline.CHUNK_DISPATCH_US * 1e-6
    # dense bf16 tensor-core peak of an H100 SXM (data sheet)
    flops_peak: float = roofline.H100_PEAK_BF16_FLOPS


class AnalyticBenchmarker:
    """Deterministic modeled makespan of a schedule (a drop-in benchmarker).

    ``nbytes``: buffer name -> byte size.  ``cost_fn`` (optional):
    ``op -> seconds | None``, a duration overriding the roofline estimate of
    that op, or None to fall through."""

    def __init__(self, nbytes: Dict[str, int], env: Optional[ModelEnv] = None,
                 cost_fn: Optional[Callable] = None):
        self.nbytes = dict(nbytes)
        self.env = env if env is not None else ModelEnv()
        self.cost_fn = cost_fn

    # -- op classification ------------------------------------------------

    @staticmethod
    def _io(op, which: str):
        fn = getattr(op, which, None)
        return list(fn()) if callable(fn) else []

    def _bytes_of(self, names) -> float:
        return float(sum(self.nbytes.get(n, 0) for n in names))

    def _device_duration(self, op) -> float:
        if self.cost_fn is not None:
            got = self.cost_fn(op)
            if got is not None:
                return got
        env = self.env
        moved = self._bytes_of(self._io(op, "reads")) + self._bytes_of(
            self._io(op, "writes"))
        t = env.op_overhead + moved / env.hbm_bw
        flops = getattr(op, "cost_flops", None)
        if callable(flops):
            t += flops() / env.flops_peak
        return t

    def _transfer(self, op):
        """(engine, duration) of a transfer post, else None."""
        kind = getattr(op, "KIND", "")
        env = self.env
        size = self._bytes_of(self._io(op, "reads"))
        if kind in PCIE_KINDS:
            return "pcie", size / env.pcie_bw
        if kind in ICI_KINDS:
            # one modeled hop of the source bytes: simple and monotone
            return "ici", env.ici_lat + size / env.ici_bw
        return None

    # -- simulation -------------------------------------------------------

    def makespan(self, order: Sequence) -> float:
        lane_t: Dict[int, float] = {}
        event_t: Dict[int, float] = {}
        engine_t: Dict[str, float] = {}
        ready: Dict[str, float] = {}

        def all_join(t: float) -> None:
            for k in lane_t:
                lane_t[k] = max(lane_t[k], t)

        def readiness(op) -> float:
            return max((ready.get(n, 0.0) for n in self._io(op, "reads")),
                       default=0.0)

        host_t = 0.0
        for op in order:
            if isinstance(op, EventRecord):
                event_t[op.event().id] = lane_t.get(op.lane().id, 0.0)
            elif isinstance(op, WaitEvent):
                lid = op.lane().id
                lane_t[lid] = max(lane_t.get(lid, 0.0),
                                  event_t.get(op.event().id, 0.0))
            elif isinstance(op, LaneWait):
                w = op.waiter().id
                lane_t[w] = max(lane_t.get(w, 0.0),
                                lane_t.get(op.waitee().id, 0.0))
            elif isinstance(op, LaneSync):
                host_t = max(host_t, lane_t.get(op.lane().id, 0.0))
                all_join(host_t)
            elif isinstance(op, EventSync):
                host_t = max(host_t, event_t.get(op.event().id, 0.0))
                all_join(host_t)
            elif isinstance(op, BoundDeviceOp):
                lid = op.lane().id
                end = (max(lane_t.get(lid, 0.0), readiness(op))
                       + self._device_duration(op))
                lane_t[lid] = end
                for n in self._io(op, "writes"):
                    ready[n] = end
            else:
                kind = getattr(op, "KIND", "")
                xfer = self._transfer(op)
                if xfer is not None:
                    eng, dur = xfer
                    end = max(engine_t.get(eng, 0.0), readiness(op)) + dur
                    engine_t[eng] = end
                    for n in self._io(op, "writes"):
                        ready[n] = end
                elif kind in ("await_transfer", "multi_await"):
                    host_t = max(host_t, readiness(op))
                    all_join(host_t)
                elif kind not in ("start", "finish", "noop") and (
                        self._io(op, "reads") or self._io(op, "writes")):
                    # any other data-carrying host op: host-serial
                    host_t = (max(host_t, readiness(op))
                              + self._device_duration(op))
                    for n in self._io(op, "writes"):
                        ready[n] = host_t
                # Start, Finish, NoOp and ops without buffers cost nothing
        tail = [host_t]
        tail += list(lane_t.values())
        tail += list(engine_t.values())
        tail += list(ready.values())
        return max(tail)

    def benchmark(self, order: Sequence,
                  opts: Optional[BenchOpts] = None) -> BenchResult:
        return BenchResult.from_times([self.makespan(order)])
