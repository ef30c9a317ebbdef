"""The fused-region tile pruning: ``Cost`` and ``prune_tilings``.

Counterpart of ``tenzing_tpu/bench/roofline.py:117-158`` (the rest of that
module, the per-workload cost models against the card's peaks, comes later).
The function is the reference's without its working-set ceiling.

On the card a fused region's tile is the row share of one group of thread
blocks (csrc/fused_region.cu), and every group is resident at once: the
region's working set is the whole region's at every tile count, so no
ceiling on a tile's working set (the TPU's VMEM budget) can tell two counts
apart.  What a tile count changes is how many blocks each group barrier
spans and which block sums which rows.
"""

from __future__ import annotations

from dataclasses import dataclass

# The floor on a tile's share of the region's tiled traffic: none.  The tile
# sweep of chip_smoke.py (phase ``fused_sweep``: every structurally valid tile
# count of the spmv naive order's regions at m=150000 and m=8192, on an H100
# SXM) read every count within 5% of one tile, at tile shares down to 24 KB
# (PERF.md), so no share is small enough to prune.
MIN_TILE_BYTES = 0


@dataclass(frozen=True)
class Cost:
    """Arithmetic and device-memory traffic of one unit of work
    (``hbm_bytes``: reads plus writes of its live buffers)."""

    flops: float
    hbm_bytes: float


def prune_tilings(cost: Cost, tile_counts, min_tile_bytes: float = MIN_TILE_BYTES,
                  full_bytes: float = 0.0):
    """Tile counts of a fused region (runtime/fused.py) that could possibly
    help, from the structurally valid candidates ``tile_counts``:

    * ``t == 1`` always survives: every region admits the one-tile kernel;
    * ``t > 1`` is dropped when the per-tile share of the TILED traffic falls
      under ``min_tile_bytes``.

    ``full_bytes`` is the traffic of the region's full-view buffers (the
    ``fuse_tiling`` entries declared ``None``, e.g. a gathered x): every
    group reads them whole, so they do not count toward a tile's share."""
    full = min(max(0.0, float(full_bytes)), cost.hbm_bytes)
    tiled_total = cost.hbm_bytes - full
    out = []
    for t in sorted({int(t) for t in tile_counts}):
        if t < 1:
            continue
        if t == 1 or tiled_total / t >= min_tile_bytes:
            out.append(t)
    return out or [1]
