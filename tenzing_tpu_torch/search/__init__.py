"""The search fleet: solver worker processes over one measurement owner.

Counterpart of ``tenzing_tpu/search``.  ``search.fleet`` spreads the search
itself: N worker processes run hill-climbs (or MCTS / DFS shards over
disjoint subtrees) and send their candidates to one measurement owner, which
fuses up to K of them into one device round
(``EmpiricalBenchmarker.benchmark_batch_times`` with ``group_seeds``).  The
driver runs it behind ``--search-workers N --measure-batch K``.
"""
