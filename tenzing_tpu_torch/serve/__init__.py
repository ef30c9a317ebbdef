"""Schedule serving: the searched schedules as a queryable service.

Counterpart of ``tenzing_tpu/serve``:

* :mod:`~tenzing_tpu_torch.serve.fingerprint` — the stable workload
  fingerprint (workload, shape and its power-of-two bucket, lanes, engine
  kinds, and the platform the records are for) and the schedule key;
* :mod:`~tenzing_tpu_torch.serve.lease` — the lease-file protocol with
  epoch fencing;
* :mod:`~tenzing_tpu_torch.serve.store` — the schema-versioned store with a
  commutative, idempotent merge, and the checkpointed cold-request
  :class:`~tenzing_tpu_torch.serve.store.WorkQueue`;
* :mod:`~tenzing_tpu_torch.serve.resolver` — exact (from the store,
  verified, zero compiles and measurements), near (the learned surrogate
  under an uncertainty gate, ``was_predicted``) and cold (a work item);
* :mod:`~tenzing_tpu_torch.serve.service` — the in-process API and
  ``python -m tenzing_tpu_torch.serve`` (``warm`` / ``query`` / ``merge`` /
  ``stats``);
* :mod:`~tenzing_tpu_torch.serve.daemon` — the drain daemon
  (``python -m tenzing_tpu_torch.serve.daemon``), which runs cold items
  through the driver on the card and re-warms the store;
* :mod:`~tenzing_tpu_torch.serve.segments` — the segmented store (sealed
  segments per bucket, a manifest, the compactor), which ``open_store``
  opens for any path that is not ``*.json``;
* :mod:`~tenzing_tpu_torch.serve.dr` — backup, restore and fsck;
* :mod:`~tenzing_tpu_torch.serve.reqlog` — the request log and exemplars;
* :mod:`~tenzing_tpu_torch.serve.listen` — the long-lived listen loop
  (``serve listen``), the resolver's fast path's caller;
* :mod:`~tenzing_tpu_torch.serve.replay` — the trace replay of the uncached
  and the serving path (``python -m tenzing_tpu_torch.serve.replay
  --platform {cuda,cpu}``);
* :mod:`~tenzing_tpu_torch.serve.fleet` — N daemons work-stealing one queue
  (``python -m tenzing_tpu_torch.serve.fleet``): the launcher, the
  exactly-once audit and the drain-rate scaling harness;
* :mod:`~tenzing_tpu_torch.serve.supervisor` — the controller that owns the
  fleet (``python -m tenzing_tpu_torch.serve.supervisor``): restarts with
  backoff, crash-loop breakers, autoscaling, adoption, retention GC.
"""

from tenzing_tpu_torch.serve.daemon import DaemonOpts, DrainDaemon
from tenzing_tpu_torch.serve.fingerprint import (
    WorkloadFingerprint,
    fingerprint_of,
    schedule_key,
    shape_bucket,
)
from tenzing_tpu_torch.serve.fleet import FleetOpts, measure_scaling, run_fleet
from tenzing_tpu_torch.serve.resolver import Resolution, Resolver, fp_cache_key
from tenzing_tpu_torch.serve.service import ScheduleService
from tenzing_tpu_torch.serve.store import ScheduleStore, WorkQueue, merge_records

__all__ = [
    "DaemonOpts",
    "DrainDaemon",
    "FleetOpts",
    "Resolution",
    "Resolver",
    "fp_cache_key",
    "measure_scaling",
    "run_fleet",
    "ScheduleService",
    "ScheduleStore",
    "WorkQueue",
    "WorkloadFingerprint",
    "fingerprint_of",
    "merge_records",
    "schedule_key",
    "shape_bucket",
]
