"""Synthesized collectives: chunk-routed point-to-point decompositions as
searchable alternatives.

Counterpart of ``tenzing_tpu/collectives/``.  A fixed engine runs a
collective in one post (``PsumStart``, ``AllToAllStart``, a shift, the host
round trip); this package decomposes the collective itself into chunked
point-to-point steps over an explicit link graph
(:mod:`~tenzing_tpu_torch.collectives.topology`) and offers each
decomposition as an ordinary choice alternative
(:mod:`~tenzing_tpu_torch.collectives.synth`), which MCTS, DFS and the
hill-climb search with no solver change.  Each instantiation is priced
alpha-beta over the links and ``bench/roofline.prune_sketches`` drops those
that cannot beat the fixed engine's floor.
"""

from tenzing_tpu_torch.collectives.synth import (  # noqa: F401
    SKETCHES,
    SYNTH_MARK,
    FixedCollective,
    SynthCollectiveChoice,
    SynthCollectiveOp,
    SynthDirective,
    SynthPlan,
    plan_host_pipe,
    plan_neighbor_shift,
    plan_rhd_all_reduce,
    plan_ring_all_reduce,
    plan_ring_all_to_all,
    sketch_menu,
    synth_hidden_comm_measured_us,
    synth_menus,
    synths_of,
)
from tenzing_tpu_torch.collectives.topology import (  # noqa: F401
    Link,
    Topology,
    engine_of_kind,
    host_topology,
    mesh_topology,
    ring_topology,
)
