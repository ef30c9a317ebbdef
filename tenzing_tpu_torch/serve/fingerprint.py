"""Stable workload fingerprints: the serving store's key space.

Counterpart of ``tenzing_tpu/serve/fingerprint.py``.  A serving key must be
**stable** — the same request yields the same bytes across restarts, hosts
and argument orders, so stores warmed apart merge instead of fragmenting —
and **bucketed** — nearby shapes share a neighbourhood, because a schedule
searched at ``n=512`` is a good warm answer for ``n=480`` (the schedule is a
structure; only its numbers are shape-specific).

The fingerprint is the reference's tuple plus the platform:

* **workload + variant** — ``halo`` / ``spmv`` / ``attn`` / ``moe``, smoke
  or full (they build different choice graphs);
* **shape** — the builders' resolved shape parameters
  (bench/driver.py ``workload_shape``) and their power-of-two **bucket**;
* **mesh** — the search platform's lane count (``search_lanes``);
* **engines** — ops/comm_ops.py's ``ICI_KINDS`` / ``PCIE_KINDS``, the
  transfer vocabulary the cost model and the surrogate's features share
  (equal to the reference's, name for name);
* **platform** — ``"cuda"`` or ``"cpu"``: the device the records under this
  key were measured on.  The reference's key has no such field, so a store
  warmed on one device would answer an exact hit on another with the first
  device's ``pct50_us`` (ROADMAP Queue 3 item 19).  The caller names the
  platform; the fingerprint never probes a device.

Two digests derive from it: ``exact_digest`` keys exact hits (the precise
shape), ``bucket_digest`` the near-miss neighbourhood (the bucketed shape).
Both are ``sha1`` short digests of sorted-key canonical JSON: no Python
``hash()``, no dict order, no ``PYTHONHASHSEED``.  With ``platform`` left
out of the canonical document the digests are the reference's.

Schedules key by ``canonical_key`` modulo redundant syncs
(:func:`schedule_key`), the equivalence every benchmark cache, verifier and
recorded database already matches on.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from functools import cached_property
from typing import Any, Dict, Tuple

from tenzing_tpu_torch.obs.tracer import short_digest
from tenzing_tpu_torch.ops.comm_ops import ICI_KINDS, PCIE_KINDS

FINGERPRINT_VERSION = 1
PLATFORMS = ("cuda", "cpu")


def shape_bucket(n: int) -> int:
    """The bucketing rule: the next power of two at or above ``n`` (0 for
    non-positive): 2^k maps to 2^k, 2^k + 1 to 2^(k+1)."""
    if n <= 0:
        return 0
    return 1 << (int(n) - 1).bit_length()


def _canonical(doc: Any) -> str:
    """The byte stream both digests hash: sorted keys, fixed separators."""
    return json.dumps(doc, sort_keys=True, separators=(",", ":"))


@dataclass(frozen=True)
class WorkloadFingerprint:
    """The serving key of one workload configuration on one platform
    (module docstring).  ``shape`` / ``bucket`` / ``mesh`` are sorted
    name/value tuples, so construction order never reaches a digest."""

    workload: str
    variant: str  # "smoke" | "full"
    shape: Tuple[Tuple[str, int], ...]
    bucket: Tuple[Tuple[str, int], ...]
    mesh: Tuple[Tuple[str, int], ...]
    engines: Tuple[Tuple[str, Tuple[str, ...]], ...]
    platform: str  # "cuda" | "cpu"

    def digest_doc(self, shape_field: Tuple) -> Dict[str, Any]:
        """The canonical document a digest hashes; less ``platform`` it is
        the reference's."""
        return {
            "v": FINGERPRINT_VERSION,
            "workload": self.workload,
            "variant": self.variant,
            "shape": [list(kv) for kv in shape_field],
            "mesh": [list(kv) for kv in self.mesh],
            "engines": [[k, list(v)] for k, v in self.engines],
            "platform": self.platform,
        }

    # cached: one resolution reads each digest several times, and each is a
    # canonical dump + sha1; the fingerprint is immutable
    @cached_property
    def exact_digest(self) -> str:
        """Keys exact hits: the precise shape."""
        return short_digest(_canonical(self.digest_doc(self.shape)))

    @cached_property
    def bucket_digest(self) -> str:
        """Keys the near-miss neighbourhood: the bucketed shape."""
        return short_digest(_canonical(self.digest_doc(self.bucket)))

    def to_json(self) -> Dict[str, Any]:
        return {
            "version": FINGERPRINT_VERSION,
            "workload": self.workload,
            "variant": self.variant,
            "shape": {k: v for k, v in self.shape},
            "bucket": {k: v for k, v in self.bucket},
            "mesh": {k: v for k, v in self.mesh},
            "engines": {k: list(v) for k, v in self.engines},
            "platform": self.platform,
            "exact": self.exact_digest,
            "bucket_digest": self.bucket_digest,
        }

    @classmethod
    def from_json(cls, j: Dict[str, Any]) -> "WorkloadFingerprint":
        return cls(
            workload=j["workload"],
            variant=j["variant"],
            shape=_sorted_items(j["shape"]),
            bucket=_sorted_items(j["bucket"]),
            mesh=_sorted_items(j["mesh"]),
            engines=tuple(sorted(
                (k, tuple(v)) for k, v in j["engines"].items())),
            platform=j["platform"],
        )


def _sorted_items(d: Dict[str, int]) -> Tuple[Tuple[str, int], ...]:
    return tuple(sorted((str(k), int(v)) for k, v in d.items()))


def fingerprint_of(req, platform: str = "cuda") -> WorkloadFingerprint:
    """The fingerprint of a :class:`~tenzing_tpu_torch.bench.driver.
    DriverRequest` for records measured on ``platform``: request
    arithmetic only, no buffers, no device."""
    from tenzing_tpu_torch.bench.driver import search_lanes, workload_shape

    if platform not in PLATFORMS:
        raise ValueError(f"platform {platform!r}: want one of {PLATFORMS}")
    shape = workload_shape(req)
    return WorkloadFingerprint(
        workload=req.workload,
        variant="smoke" if req.smoke else "full",
        shape=_sorted_items(shape),
        bucket=_sorted_items({k: shape_bucket(v) for k, v in shape.items()}),
        mesh=_sorted_items({"lanes": search_lanes(req)}),
        engines=tuple(sorted((("ici", tuple(ICI_KINDS)),
                              ("pcie", tuple(PCIE_KINDS))))),
        platform=platform,
    )


def schedule_key(seq) -> str:
    """The store's schedule key: a short digest of the canonical form modulo
    redundant syncs, so two spellings of one program share a slot."""
    from tenzing_tpu_torch.core.schedule import remove_redundant_syncs
    from tenzing_tpu_torch.core.sequence import canonical_key

    return short_digest(repr(canonical_key(remove_redundant_syncs(seq))))
