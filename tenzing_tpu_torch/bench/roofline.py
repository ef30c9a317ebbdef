"""Roofline costs: the per-workload cost models, and the pruning of the
fused-region tile menus and the chunk menus.

Counterpart of ``tenzing_tpu/bench/roofline.py``: ``Cost`` and its
fraction-of-peak report (``Cost.utilization``), the per-workload cost models
(``attention_cost``, ``moe_cost``, ``halo_cost``, ``spmv_cost``: the
reference's FLOP and byte counts, one iteration each), ``prune_tilings``
(the reference's without its working-set ceiling), and the chunk-menu
sketch constraint ``op_roofline_us``, ``hidden_comm_bound_us``,
``prune_chunkings`` and ``chunk_menu``, and the synthesized collectives'
``prune_sketches`` (collectives/synth.py).

On the card a fused region's tile is the row share of one group of thread
blocks (csrc/fused_region.cu), and every group is resident at once: the
region's working set is the whole region's at every tile count, so no
ceiling on a tile's working set (the TPU's VMEM budget) can tell two counts
apart.  What a tile count changes is how many blocks each group barrier
spans and which block sums which rows.

The reference's constants are a TPU v5e's; none carries over.  Here each one
is the H100's data sheet (the peaks), a reading of the card taken by
``chip_smoke.py`` (phase ``chunk``; PERF.md has the readings with the card's
name and power limit), or the reference's rule kept where nothing on the card
measures it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

# H100 SXM peaks (NVIDIA data sheet, 700 W): float32 outside the tensor cores
# (the port's .xla folds and expert MLPs run in full f32, no TF32), dense bf16
# on the tensor cores, and HBM3
H100_PEAK_F32_FLOPS = 67e12
H100_PEAK_BF16_FLOPS = 989e12
H100_PEAK_HBM_BYTES = 3.35e12

# The floor on a tile's share of the region's tiled traffic: none.  The tile
# sweep of chip_smoke.py (phase ``fused_sweep``: every structurally valid tile
# count of the spmv naive order's regions at m=150000 and m=8192, on an H100
# SXM) read every count within 5% of one tile, at tile shares down to 24 KB,
# for the first kernel.  For the slab-ring kernel one count lost more (region
# 0 at 2 tiles, a 16.2 MB share: 1.028-1.062 of one tile over three runs)
# while every smaller share, 9.15 MB down to 24 KB, read within 5% (PERF.md):
# the loss does not grow as a share shrinks, so a floor would prune counts
# that are as fast, and none is set.
MIN_TILE_BYTES = 0


@dataclass(frozen=True)
class Cost:
    """Arithmetic and memory traffic of one unit of work: ``hbm_bytes``
    counts the reads and writes of its live device buffers, ``xfer_bytes``
    the bytes through the host staging path (PCIe), which has its own
    rate."""

    flops: float
    hbm_bytes: float
    xfer_bytes: float = 0.0

    def utilization(self, seconds: float) -> Dict[str, float]:
        """Achieved rates and fractions of the H100's peaks for one
        iteration of ``seconds`` (the reference's report, with the card's
        peaks: f32 outside the tensor cores and dense bf16 on them)."""
        return {
            "seconds": seconds,
            "tflops": self.flops / seconds / 1e12,
            "f32_frac": self.flops / seconds / H100_PEAK_F32_FLOPS,
            "bf16_frac": self.flops / seconds / H100_PEAK_BF16_FLOPS,
            "hbm_gbs": self.hbm_bytes / seconds / 1e9,
            "hbm_frac": self.hbm_bytes / seconds / H100_PEAK_HBM_BYTES,
            "xfer_gbs": self.xfer_bytes / seconds / 1e9,
        }


def attention_cost(batch: int, seq: int, head_dim: int,
                   bytes_per_el: int = 4) -> Cost:
    """Dense softmax attention, one head group: QK^T and PV are each
    2*b*n^2*d FLOPs (the softmax's O(b*n^2) is left out).  Traffic: read Q,
    K, V and write O."""
    flops = 4.0 * batch * seq * seq * head_dim
    hbm = 4.0 * batch * seq * head_dim * bytes_per_el
    return Cost(flops=flops, hbm_bytes=hbm)


def moe_cost(tokens: int, d_model: int, d_ff: int, bytes_per_el: int = 4,
             staged: bool = False, n_experts: int = 8) -> Cost:
    """Top-1 routed MoE layer: every token through one gelu MLP, 2*t*d*dff
    FLOPs up and as many down.  Traffic: read X and every expert's weights
    once, write Y; ``staged`` adds the dispatch and combine round trips
    through the staging path (4 crossings of the slot table)."""
    flops = 4.0 * tokens * d_model * d_ff
    weights = 2.0 * n_experts * d_model * d_ff * bytes_per_el
    hbm = (2.0 * tokens * d_model) * bytes_per_el + weights
    xfer = 4.0 * tokens * d_model * bytes_per_el if staged else 0.0
    return Cost(flops=flops, hbm_bytes=hbm, xfer_bytes=xfer)


def halo_cost(nq: int, lx: int, ly: int, lz: int, radius: int,
              bytes_per_el: int = 4, staged: bool = True) -> Cost:
    """The 6-face halo exchange, one iteration: no FLOPs.  Per face: pack
    (read the face, write the buffer) and unpack (read the buffer, write the
    shell), 4 face-bytes of traffic; host staging adds 2 crossings (spill
    and fetch)."""
    faces = 2 * (lx * ly + ly * lz + lx * lz) * radius * nq
    face_bytes = float(faces) * bytes_per_el
    return Cost(flops=0.0, hbm_bytes=4.0 * face_bytes,
                xfer_bytes=(2.0 * face_bytes if staged else 0.0))


def spmv_cost(m: int, nnz: int, bytes_per_el: int = 4) -> Cost:
    """CSR y = A x: 2 FLOPs a stored element; traffic: the value, the column
    index and the gathered x of each stored element, and a row's y write and
    4-byte row offset."""
    flops = 2.0 * nnz
    hbm = float(nnz) * (2 * bytes_per_el + 4) + float(m) * (bytes_per_el + 4)
    return Cost(flops=flops, hbm_bytes=hbm)


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


# -- chunk menus (core/chunking.py) -----------------------------------------

# The host time one more op adds to a schedule on the stream executor: the
# median per-op wall time of a one-lane chain of 200 small device ops run
# back to back, 25.12 µs on an H100 SXM (chip_smoke.py, phase ``chunk``;
# PERF.md).  Splitting an op in n adds n - 1 such dispatches.
CHUNK_DISPATCH_US = 25.1
# The pinned host <-> device copy rate the staged transfers run at: the mean
# of the two directions' rates for one full-size MoE slot table (4.98 MB),
# 48.70 GB/s on an H100 SXM (chip_smoke.py, phase ``chunk``; PERF.md).  It
# prices the neighbouring transfer a chunking could hide.
XFER_GBS = 48.7
# The rate an expert-parallel all-to-all moves a rank's slot table at (the MoE
# layer's combine exchange, models/moe.py ``ffn_chunk_menu``; the reference
# priced it at a v5e's ICI rate, which does not carry over): the H100's
# NVLink, 450 GB/s each way per card (NVIDIA data sheet: 900 GB/s
# bidirectional).  Unmeasured across cards: every record shows one card, where
# the exchange is a self-copy.
EXCHANGE_GBS = 450.0
# Menu cap on chunk counts: the reference's rule (beyond 4 partials the added
# dispatches dominate), not measured on the card.
MENU_CHUNK_CAP = 4


def op_roofline_us(cost: Cost, peak_flops: float = H100_PEAK_F32_FLOPS,
                   hbm_bytes_per_s: float = H100_PEAK_HBM_BYTES) -> float:
    """The least time one op could take: the larger of its operations over
    ``peak_flops`` and its bytes over the memory rate."""
    return max(cost.flops / peak_flops, cost.hbm_bytes / hbm_bytes_per_s) * 1e6


def hidden_comm_bound_us(cost: Cost, chunks: int, comm_us: float,
                         peak_flops: float = H100_PEAK_F32_FLOPS,
                         hbm_bytes_per_s: float = H100_PEAK_HBM_BYTES) -> float:
    """Upper bound on the transfer time an ``n``-way chunking of an op can
    newly hide: a transfer may start after the first chunk instead of after
    the whole op, so at most ``(n-1)/n`` of the op's least time, and never
    more than the transfer itself (``comm_us``)."""
    if chunks <= 1:
        return 0.0
    return min(float(comm_us),
               op_roofline_us(cost, peak_flops, hbm_bytes_per_s)
               * (chunks - 1) / chunks)


def prune_chunkings(cost: Cost, chunk_counts, comm_us=None,
                    combine_bytes: float = 0.0,
                    dispatch_us: float = CHUNK_DISPATCH_US,
                    min_chunk_bytes: float = MIN_TILE_BYTES,
                    peak_flops: float = H100_PEAK_F32_FLOPS,
                    hbm_bytes_per_s: float = H100_PEAK_HBM_BYTES):
    """Chunk counts of an audited op that could possibly help, from the
    structurally valid ``chunk_counts`` (the reference's sketch constraint):

    * ``n == 1`` always survives: it is the op itself;
    * ``n > 1`` is dropped when a chunk's share of the op's traffic falls
      under ``min_chunk_bytes`` (the reference's rule: the tile floor, 0 on
      the card); and
    * with ``comm_us`` (the neighbouring transfer's time) given, ``n`` is
      dropped unless the hidden-comm bound beats the added cost: ``n-1``
      extra dispatches plus ``n-1`` extra passes over ``combine_bytes`` (the
      output every partial's read-modify-write re-presents).  ``comm_us``
      None skips this rule.

    ``cost`` is the chunked op's own cost."""
    out = []
    for n in sorted({int(n) for n in chunk_counts}):
        if n < 1:
            continue
        if n == 1:
            out.append(1)
            continue
        if cost.hbm_bytes / n < min_chunk_bytes:
            continue
        if comm_us is not None:
            added = (n - 1) * (float(dispatch_us) + float(combine_bytes)
                               / hbm_bytes_per_s * 1e6)
            if hidden_comm_bound_us(cost, n, comm_us, peak_flops,
                                    hbm_bytes_per_s) <= added:
                continue
        out.append(n)
    return out or [1]


def chunk_menu(counts, cost: Cost, comm_us=None, combine_bytes: float = 0.0,
               relax: bool = False, cap: int = MENU_CHUNK_CAP):
    """The models' chunk-menu scaffold: ``counts`` capped at ``cap``; with
    ``relax`` (tests, the smoke) every one kept unpriced, else pruned by
    :func:`prune_chunkings` and each surviving ``n > 1`` priced by
    :func:`hidden_comm_bound_us`.  Returns ``(pruned counts, {count: est
    hidden µs})``."""
    counts = [int(c) for c in counts if int(c) <= cap]
    if relax:
        return list(counts), {}
    pruned = prune_chunkings(cost, counts, comm_us=comm_us,
                             combine_bytes=combine_bytes)
    est = {n: hidden_comm_bound_us(cost, n, comm_us or 0.0)
           for n in pruned if n > 1}
    return pruned, est


def prune_sketches(cands: Dict[str, Dict], fixed_floor_us: float,
                   overlap_us: float = 0.0,
                   dispatch_us: float = CHUNK_DISPATCH_US):
    """The sketch instantiations of a synthesized collective
    (collectives/synth.py) that could beat the fixed collective, from the
    priced candidates ``cands`` (the reference's rule,
    tenzing_tpu/bench/roofline.py:250-292).

    ``cands`` maps a label (``"ring.c2"``) to its alpha-beta census:
    ``est_us`` (the serial wire cost over the topology's links), ``steps``
    (separately posted transfers) and ``chunks``.  ``fixed_floor_us`` is
    the fixed engine's one-post floor for the same payload; ``overlap_us``
    the neighbouring work a pipelined decomposition could hide under.

    Each post after the first pays a dispatch (``dispatch_us``, by default
    the card's measured per-op dispatch, :data:`CHUNK_DISPATCH_US`), and a
    ``k``-chunk pipeline earns back at most ``min(overlap_us, est_us *
    (k-1)/k)``.  An instantiation survives iff that effective cost beats
    ``fixed_floor_us``.  Returns ``(kept labels, {label: prune reason})``.
    """
    kept, pruned = [], {}
    for label, c in cands.items():
        est = float(c.get("est_us", 0.0))
        steps = max(1, int(c.get("steps", 1)))
        k = max(1, int(c.get("chunks", 1)))
        credit = min(float(overlap_us), est * (k - 1) / k)
        eff = est + (steps - 1) * float(dispatch_us) - credit
        if eff < float(fixed_floor_us):
            kept.append(label)
        else:
            pruned[label] = (
                f"effective {eff:.1f}us (wire {est:.1f} + "
                f"{steps - 1} extra dispatch @ {dispatch_us:.0f} - "
                f"overlap credit {credit:.1f}) cannot beat the fixed "
                f"one-post floor {float(fixed_floor_us):.1f}us")
    return kept, pruned
