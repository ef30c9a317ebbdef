"""Greedy phase-ordered incumbent schedules.

The reference hard-codes one overlap discipline into its halo graph —
every-post-before-any-wait edges (ops_halo_exchange.cu:249-256).  This
framework's graphs deliberately leave that order free for the solver, and
:func:`greedy_phase_order` reconstructs the discipline as a *schedule* instead
of a graph constraint: ops execute in phase order (all packs, then all posts,
then all awaits, ...), round-robined across lanes, with the SDP machinery
inserting exactly the sync ops the solver would.  Anytime searches
(bench.py) seed their incumbent set with it so the directed search starts
from the domain heuristic rather than from naive.
"""

from __future__ import annotations

from typing import Sequence as Seq

from tenzing_tpu_torch.core.graph import Graph
from tenzing_tpu_torch.core.sequence import Sequence


def greedy_phase_order(graph: Graph, platform, phases: Seq[str]) -> Sequence:
    """A complete schedule of ``graph`` executing ops in ``phases`` order.

    ``phases`` is a tuple of op-name prefixes, earliest first (must cover
    every op in the graph, including "start"/"finish"); an op's phase is the
    first prefix its name starts with.  Device ops round-robin across
    ``platform.lanes``; a later-phase op never runs while an earlier-phase op
    anywhere in the graph is unexecuted (the required sync is placed
    instead), so every phase-``k`` op happens before any phase-``k+1`` op on
    *all* lanes.  One implementation of the discipline: this is
    ``solve.local.drive`` under ``solve.local.phase_policy`` (which also
    resolves ChoiceOps and expands compounds for choice graphs)."""
    from tenzing_tpu_torch.solve.local import drive, phase_policy

    seq, _ = drive(graph, platform, phase_policy(platform, phases))
    return seq
