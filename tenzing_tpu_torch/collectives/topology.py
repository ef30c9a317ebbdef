"""The link graph the synthesized collectives are priced over.

Counterpart of ``tenzing_tpu/collectives/topology.py``.  ``bench/model.py``
classifies every transfer kind into an engine queue and carries each
engine's alpha-beta parameters in ``ModelEnv``; this module makes that an
explicit topology: named nodes per mesh axis, directed :class:`Link` edges
(a ring of ``"ici"`` links along each axis, a ``"pcie"`` link each way
between a device and its host) and a per-link cost in microseconds.  Sketch
instantiation (collectives/synth.py) prices every candidate over these
links before the roofline prune.

What each engine is on this machine:

* ``"ici"`` moves data between ranks: NCCL over NVLink between cards, and
  the CUDA-IPC shift (ops/rdma.py) between ranks that share one card.  At
  an axis of size 1 a post is a copy on the device.
* ``"pcie"`` is the pinned host round trip: a device-to-host copy into
  pinned memory and the copy back.

The parameters are read from the port's ``ModelEnv``, so by default they are
the card's (bench/model.py says where each comes from); a caller that passes
another ``ModelEnv`` (the reference's, in the parity tests) prices with it.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Mapping, Optional, Tuple

from tenzing_tpu_torch.bench.model import ModelEnv
from tenzing_tpu_torch.ops.comm_ops import ICI_KINDS, PCIE_KINDS

#: Engine labels, the queue names of bench/model.py.
ENGINES = ("ici", "pcie")

#: The node at the host end of a pcie link.
HOST_NODE = "host"


def engine_of_kind(kind: str) -> Optional[str]:
    """The engine queue of a transfer kind, or ``None``."""
    if kind in ICI_KINDS:
        return "ici"
    if kind in PCIE_KINDS:
        return "pcie"
    return None


@dataclass(frozen=True)
class Link:
    """One directed point-to-point link with an alpha-beta cost."""

    src: str
    dst: str
    engine: str  # "ici" | "pcie"
    alpha_us: float  # per-transfer post latency
    beta_us_per_byte: float  # inverse bandwidth

    def cost_us(self, nbytes: float) -> float:
        return self.alpha_us + float(nbytes) * self.beta_us_per_byte


def ici_link_params(env: Optional[ModelEnv] = None) -> Tuple[float, float]:
    """(alpha_us, beta_us_per_byte) of one ici hop, from ``ModelEnv``."""
    env = env or ModelEnv()
    return env.ici_lat * 1e6, 1e6 / env.ici_bw


def pcie_link_params(env: Optional[ModelEnv] = None) -> Tuple[float, float]:
    """(alpha_us, beta_us_per_byte) of the host staging path: the model's
    per-op overhead as the post latency (a staged pipeline pays a dispatch
    per chunk, as the executor does) and the pinned copy rate."""
    env = env or ModelEnv()
    return env.op_overhead * 1e6, 1e6 / env.pcie_bw


@dataclass(frozen=True)
class Topology:
    """A set of directed links."""

    links: Tuple[Link, ...] = field(default_factory=tuple)

    def nodes(self) -> List[str]:
        seen: Dict[str, None] = {}
        for lk in self.links:
            seen.setdefault(lk.src)
            seen.setdefault(lk.dst)
        return list(seen)

    def out_links(self, src: str) -> List[Link]:
        return [lk for lk in self.links if lk.src == src]

    def link(self, src: str, dst: str) -> Optional[Link]:
        for lk in self.links:
            if lk.src == src and lk.dst == dst:
                return lk
        return None

    def engines(self) -> List[str]:
        out = []
        for lk in self.links:
            if lk.engine not in out:
                out.append(lk.engine)
        return out

    def merged(self, other: "Topology") -> "Topology":
        return Topology(self.links + other.links)

    def min_hops(self, src: str, dst: str) -> int:
        """Breadth-first hop count between two nodes; -1 when unreachable."""
        if src == dst:
            return 0
        frontier, dist = [src], {src: 0}
        while frontier:
            nxt = []
            for node in frontier:
                for lk in self.out_links(node):
                    if lk.dst not in dist:
                        dist[lk.dst] = dist[node] + 1
                        if lk.dst == dst:
                            return dist[lk.dst]
                        nxt.append(lk.dst)
            frontier = nxt
        return -1


def _axis_node(axis: str, i: int) -> str:
    return f"{axis}{i}"


def ring_topology(axis: str, n: int, env: Optional[ModelEnv] = None) -> Topology:
    """A ring of ici links along one mesh axis, both directions (so the
    reverse-rotation ``ringr`` sketch prices as the forward one)."""
    alpha, beta = ici_link_params(env)
    links = []
    for i in range(max(1, n)):
        j = (i + 1) % max(1, n)
        if j == i:
            continue
        links.append(Link(_axis_node(axis, i), _axis_node(axis, j), "ici",
                          alpha, beta))
        links.append(Link(_axis_node(axis, j), _axis_node(axis, i), "ici",
                          alpha, beta))
    return Topology(tuple(links))


def host_topology(device: str = "d0", env: Optional[ModelEnv] = None) -> Topology:
    """The pcie staging links: device -> host (spill), host -> device
    (fetch)."""
    alpha, beta = pcie_link_params(env)
    return Topology((
        Link(device, HOST_NODE, "pcie", alpha, beta),
        Link(HOST_NODE, device, "pcie", alpha, beta),
    ))


def mesh_topology(axes: Mapping[str, int], host: bool = True,
                  env: Optional[ModelEnv] = None) -> Topology:
    """One ici ring per mesh axis of size > 1 (``axes``: axis name -> size,
    in order), and with ``host`` the pcie link of the first axis's device 0.
    A collective is synthesized along one axis at a time."""
    topo = Topology()
    for axis, n in axes.items():
        if n > 1:
            topo = topo.merged(ring_topology(axis, n, env))
    if host:
        first = next(iter(axes), "d")
        topo = topo.merged(host_topology(_axis_node(first, 0), env))
    return topo
