#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one GPU: ``python3 chip_smoke.py``.

Phases, each printing one JSON line (details also go to
``chiprun_out/chip_smoke.jsonl``); any failure raises and exits non-zero
before the last line:

1. device   — ``nvidia-smi`` name and power limit, torch and CUDA versions;
2. build    — builds the hand-written CUDA kernels from ``tenzing_tpu_torch/csrc``
              (ops/kernel_lib.py) and reports the build time;
3. kernels  — at the 512^3 flagship shapes, for each of the six faces and each
              kernel slot on its menu, ``halo_pack`` and ``halo_unpack`` against
              their plain PyTorch versions, and ``device_copy`` against
              ``copy_``: bit-exact (tolerance 0, pure data movement), with the
              kernel's, the plain version's and the library call's times and
              the bytes bound (z faces also the sector bound); each halo row
              names the body the library plans (TMA for the x and y
              unpacks, SIMT for the rest) and holds its plan against
              ``halo_launch_plan``, runs the SIMT body forced on the unpacks
              TMA takes (bit-exact, timed as ``simt_ms``), and after each
              unpack U outside the cut must be unchanged;
4. executor — the naive, greedy host/rdma/mixed, alias and all-kernel orders on
              8 lanes through ``StreamExecutor``: the final grid must be
              bit-identical to the same order run with every kernel replaced by
              its plain version on the card, and to the expected grid; timed
              runs must leave every buffer's ``data_ptr`` unchanged;
5. driver   — ``tenzing_tpu_torch.bench.driver.run`` at ``halo_n=512`` with a
              small budget; ``verified`` must be true and each halo kernel's
              launch count over this run must be > 0, for each body; the
              run warm-starts from the committed databases (at least one
              recorded row measured, the recorded climb spent budget; the
              ``recorded`` block printed), dumps its own database
              (``chiprun_out/halo_driver.csv``) and runs with
              ``profile_winner``, ``trace_out`` and ``metrics_json`` under
              ``chiprun_out/``: the ``attrib`` block must be complete with
              ``sum_of_parts_us >= critical_path_us > 0``, and
              ``explain.json``, the trace (JSONL and Chrome) and the
              metrics must parse;
6. attn kernels  — first each kernel's ``ptxas -v`` report (registers,
              spills), its launch constants against
              ``ops/attention_kernels.f32_launch_plan`` /
              ``bf16_launch_plan`` and the stress cases of
              ``bench/attn_f32.py`` (with a fused-region fold at a key
              offset) and ``bench/attn_bf16.py`` (ragged n and nkv, several
              kv blocks, strided views, q scaled by 8) at ``F32_STATE_TOL`` /
              ``BF16_STATE_TOL``; then at
              the full-width attention shapes (batch 4, 8192
              queries, head dim 128): ``attn_block`` (f32 and bf16 inputs) on a
              1024-key block from the initial state and from the state after
              three folds, ``attn_fused`` (f32 and bf16) over all 8192 keys,
              and a ragged block (1 x 1000 queries): each against its plain
              PyTorch version on the card, as m, l and acc / l, at
              ``F32_STATE_TOL`` / ``BF16_STATE_TOL`` (ops/attention_kernels.py);
              every bf16 row also holds three deliberately faulty plain folds
              (p left unrounded, V truncated, nothing rounded) against the
              same plain version and fails if the tolerance accepts any of
              them, every f32 row a plain fold with one TF32 pass per product
              instead of the split's three; the fused rows hold O = acc / l
              against the dense float64
              attention (``F32_O_TOL`` / ``BF16_O_TOL``; the controls' O is
              reported beside it).  Each row carries the kernel's, the plain
              version's and (fused) ``scaled_dot_product_attention``'s times
              and the bound (f32: the split's three TF32 products at 495
              TFLOP/s, the SIMT bound beside it) and its achieved TFLOP/s (on
              4 b n nkv d); each bf16 row also the two-pass design's bound and
              the time of the wrapper's K/V casts (inside the kernel's time);
7. attn executor — the naive (all ``.xla``), ``.pallas`` on 2 lanes,
              ``.pallas_bf16``, ``.fused``, ``.fused_bf16`` and a mixed order
              at full width through ``StreamExecutor``, each against the same
              order with plain kernels and against the dense float64 expected
              O (the same tolerances); each bf16 order's O with a bias of
              ``O_BIAS_CONTROL`` in every element (under ``BF16_O_TOL``'s
              largest error, over its relative rms) must fail; timed runs
              must keep every ``data_ptr``;
8. attn driver   — ``run`` with ``workload="attn"`` at full width and a small
              budget: the metric must be ``attn_blockwise_pct50_searched_n8192``,
              both attention kernels must launch > 0 times (both bf16 ones,
              which the incumbents run, each), and the result
              must be verified: the integrity gate holds the winner's and
              naive's O to the dense float64 attention at ``F32_O_TOL`` /
              ``BF16_O_TOL`` by the precision each ran (bench/gate.py); its
              ``gate`` block (largest error, relative rms, limit) is printed;
9.  moe kernels  — ``ffn_batched`` (split-TF32 ``wgmma``,
              csrc/ffn_tile.cuh) at the main path's shapes (chunk 0's slot
              table of the full-width pipeline: 8 experts x 304 slots, d 512,
              d_ff 2048) and at ragged ones (1, 257 and 305 slots, d_ff 520)
              against its plain version on the card at ``FFN_TOL``; the erf
              gelu control must be rejected, a second launch must give the
              same bits; at the main shape a plain emulation of the kernel's
              three TF32 passes must pass and one with a single pass (the
              single-TF32 control) must fail, and the library's launch
              constants and tiling must equal ``ffn_launch_plan``; the
              kernel's, the plain version's and the ``bmm -> gelu -> bmm``
              three-call times beside the split bound (the SIMT bound
              beside it);
10. moe executor — naive, the four greedy incumbents and two all-``.pallas``
              completions of the choice graph (f32 and bf16 device-copy
              staging) at full width on 2 lanes through ``StreamExecutor``: Y
              against the same order with plain kernels and against the
              float64 dense expected output (``F32_Y_TOL``, or
              ``BF16_Y_TOL`` for bf16 staging, which must reject a control
              with one expert's gate weights dropped); timed runs keep every
              ``data_ptr`` and allocate nothing;
11. moe driver   — ``run`` with ``workload="moe"`` at full width and a small
              budget with climbs: the metric must be
              ``moe_pipe_pct50_searched_t8192``, ``ffn_batched`` and
              ``device_copy`` must launch > 0 times, the climb must have
              spent budget, and the result must be verified (the gate holds
              Y and each Y_c to the float64 routed result at ``F32_Y_TOL`` /
              ``BF16_Y_TOL``; its ``gate`` block printed); the warm start
              checked as in phase 5;
12. spmv kernels — ``ell_spmv`` at the ``--m 8192`` path's ``spmv_remote``
              shapes (a (8192, 22) slab, x of 4093) and at ragged ones (m not
              a multiple of a warp's 32 rows, w = 1, n = 1, n = 4096, w above
              a warp, a slab view 104 bytes off 16) against the float64
              product within the rounding bound of the kernel's order
              (signed rows cancel, so two float32 orders may differ by more
              than ``ELL_TOL``'s atol; the main slab also against its plain
              version at ``ELL_TOL``); a control with one slab column
              dropped must be rejected by both, a second launch must give
              the same bits; the kernel's, the plain version's, cuSPARSE's
              (``torch.sparse_csr_tensor @ x``) and an empty launch of the
              kernel's grid's (the floor) times beside the bound, and the
              kernel's warm time;
13. spmv executor — naive, the 2-lane overlap order and the all-kernel
              order at m=8192, naive and the overlap order at m=150000,
              through ``StreamExecutor``: y against the same order with plain
              kernels and against the float64 product, ``data_ptr``s kept, no
              allocation in timed runs;
13a. graphs — every fixed schedule of ``bench/breakdown.py`` (halo,
              attn, moe, spmv, the fused one-tile orders among them) on an
              executor that replays CUDA graphs and on one with
              ``graphs=False``, over the same buffers: both walls per
              iteration, one run's outputs compared (bit for bit for halo
              and spmv; attention and moe within ``GRAPH_ATTN_TOL`` /
              ``GRAPH_MOE_TOL``), segments and graphs per schedule, and the
              schedules slower with graphs listed;
14. fused   — every tile count on the pruned menu of the naive and overlap
              orders at m=150000 (the host exchange: two regions), and the
              examples' local-exchange graph (one five-member region with a
              grid-wide barrier), through ``FusedExecutor`` with the
              ``fused_region`` kernel against the plain region at
              ``REGION_TOL`` and against the float64 product; a control with
              one remote slab column dropped must be rejected; each region's
              kernel, plain and stepped-members times beside the bound
              (``vs_bound``); every SpMV region's instantiation as the
              library reports it must be the slab-ring one (160 threads,
              98,448 bytes of shared memory); it fails when the host
              exchange's two regions sum to more than 3% above their recorded
              time (``SPMV_REGION_RECORDED_MS``);
15. fused sweep — every structurally valid tile count of the naive
              order's regions at m=150000 and m=8192: the fused
              order against plain regions and the float64 product, and each
              region's kernel time beside its tile's share of the traffic
              (the rows ``bench/roofline.MIN_TILE_BYTES`` is set from);
16. spmv driver — ``run`` with ``workload="spmv"`` at m=150000 with
              ``fuse_winner`` and ``fuse_search_tiles``, its climbs through
              the search fleet (``search_workers=2, measure_batch=4,
              climb_budget=8``: two worker processes, this one the
              measurement owner): verified, the fused
              program verified with at least one region, its dispatch
              overhead and stepped sum of parts before and after fusing
              present, ``fused_region`` launched > 0 times; the
              ``perf.distributed`` block with 2 workers, no failed job, at
              least one fused round, an occupancy in (0, 1], the candidates
              the jobs' sum, no restart and no worker with a CUDA context
              (its longest round under the workers' 60 s heartbeat limit);
              then at ``m=8192``: verified, ``ell_spmv`` launched > 0 times;
17. dfs example — ``python -m tenzing_tpu_torch.examples.spmv_dfs`` at
              ``--matrix-m 150000`` with a cap of 12 schedules and
              ``TENZING_TPU_NATIVE=1``: it must measure at least one and
              print ``best:``; the terminals the native enumerator gives at
              the cap must equal the Python path's (``TENZING_TPU_NATIVE=0``),
              both enumerations timed (host time on the card's machine), and
              whether the halo search graph's root state lowers is recorded;
18. examples — ``moe_mcts`` at full width with ``--dump-tree`` (its
              ``mcts_tree_*.dot`` dumps under ``chiprun_out/examples_tree/``
              must exist and hold the tree), ``halo_mcts`` at the flagship
              width on a world-size-1 NCCL group and on two ranks sharing
              the card (every exchange ``.rdma``), each with a small budget:
              CSV rows, ``best:`` and the reproduce stamp on stderr; then
              ``mcts_replay`` over phase 5's database: a line per strategy.

Run after the attn driver (phase 8):

8a. attn fused — the attention members of ``fused_region`` at full width:
              the naive ``.xla`` order (one region: 8 folds + finalize), a
              2-lane order, and the naive order with every fold chunked 2
              and 4 ways, at every tile count of their menus, against the
              plain region (m, l, acc / l and O at ``F32_STATE_TOL``) and
              the dense expected O (``F32_O_TOL``); two launches must be
              bitwise equal, and a fold member whose key offset is one block
              off must be rejected; each naive region's kernel time at every
              tile count, and each region's at one tile beside the stepped
              members, the plain region and the operations bound (the
              split's, the SIMT one beside it), with one f32
              ``scaled_dot_product_attention`` as the yardstick; every
              region's instantiation (threads, shared memory) as the library
              reports it must be the attention one, and every SpMV region's
              (phase 14) the slab-ring one;
8b. attn fused driver — ``run`` with ``workload="attn"``,
              ``fuse_winner`` and ``fuse_search_tiles``: ``perf.fused`` and
              a planted ``perf.fuse_search_tiles``, ``fused_region``
              launched > 0 times; the fused block verified, or reported as
              diverged by the reference's gate (the run raises if the fused
              outputs fail the members' own tolerance); the result verified
              or demoted as in phase 8.

Run after the moe driver (phase 11):

11a. chunk  — at full width, the chunked orders against the unchunked ones
              at every valid count: attention's naive order with sub-folds
              (``F32_STATE_TOL``, O against the expected), the moe orders
              with expert partials under f32 and bf16 staging (Y within one
              f32 / bf16 ulp of the unchunked Y and within ``F32_Y_TOL`` /
              ``BF16_Y_TOL`` of the expected), each verified; then the
              full-size pruned menus and the card's chunk constants of
              ``bench/roofline.py`` measured: the stream executor's per-op
              host dispatch and the pinned host <-> device copy rate;
11b. host syncs — the moe pipeline's chunked and unchunked orders (f32 chains
              on the host and on the device copy) and attention's naive
              order with its folds unchunked and chunked 2 and 4 ways, each
              with every EventSync blocking the host and with the host syncs
              deferred (runtime/executor.py): outputs bit-equal, in turns
              each one's wall, ``breakdown.py``'s idle share and the host
              blocks per iteration;
11c. chunk driver — ``run`` with ``chunk`` on attn and moe: a
              ``perf.chunked`` block with menus and the measured hidden comm,
              verified or demoted as the plain runs may be;
11d. moe layer kernels — ``ffn_rows`` at one chunk of the expert-parallel
              MoE layer at world size 1 (n 2048, d 512, d_ff 2048) and at
              ragged n (2047, 37) against its plain version at ``FFN_TOL``,
              the erf control and (at the chunk) the single-TF32-pass
              emulation rejected, two launches bit-equal; the same in bf16
              at ``FFN_BF16_TOL`` (also n 1, d_ff 2040 and 8) with a
              skipped-hidden-tile control, and the bf16 body's SASS (HGMMA
              in each instantiation, no ``mma.sync``, no spills); the
              kernel's, the plain version's and the three-call times
              beside the bound, f32 and bf16;
11e. moe layer — the layer (models/moe.py) at full width on a world-size-1
              NCCL group made here: the dryrun's agreement protocol
              (parallel/dryrun.py; an all-``.xla``, an all-``.pallas`` and a
              mixed schedule within ``rtol=2e-4, atol=2e-5`` of the float64
              Y, ``ffn_rows`` launched, the layer's all-to-alls posted
              through the NCCL group), a dropped-expert control that must
              be rejected, the self all-to-all's time per chunk, and a
              12-iteration ``explore`` through ``DistControlPlane``; then
              the same layer in bf16: the agreement within
              ``dryrun.Y_TOL_BF16`` of the float64 Y cast to bf16, the bf16
              ``ffn_rows`` launched, the dropped-expert control rejected
              (11d also holds the bf16 ``ffn_rows`` against its plain
              version at ``FFN_BF16_TOL``, with a skipped-hidden-tile
              control, and times it);
11f. mesh halo — the mesh halo exchange (models/halo.py) at the flagship
              width per rank (nQ 3, 512^3, radius 3) on a world-size-1 NCCL
              group and a 1x1x1 mesh: the dryrun's agreement (three
              ``HaloExchange`` schedules, then the engine menu's all-``.xla``,
              all-``.rdma`` and mixed orders), U bit-exact against
              ``make_halo_buffers``' expected array, then a 12-iteration
              MCTS on the engine menu; the engines explored and each
              iteration's time;
11g. mesh halo shared — two ranks on GPU 0 over gloo (parallel/launch.py
              ``shared_card``), a 2x1x1 mesh, every exchange ``.rdma``: the
              x faces through the ``rdma_shift_post`` / ``rdma_shift_wait``
              kernels (CUDA IPC between the two processes), y and z through
              the loopback; each rank's U bit-exact, both kernels launched
              on both ranks (each rank zeroes its counts before the run and
              reads them after), the write-after-read probe (three runs back
              to back, the interior bumped each run and a delay before each
              unpack) exact, and one x face's shift timed (post, wait, both,
              the barrier alone, the copy kernel alone, for the kept
              hand-off, CUDA stream memory operations, and the spin
              kernels', in turns; the plain host-staged shift) and held
              against ``torch.roll`` of the gathered faces;
11h. irregular spmv shared — ``IrregularSpMV(impl_choice=True)`` on the spmv
              workload's band matrix (m 150000, half-bandwidth 18750, 1.5M
              nonzeros, batch 1) on 2 and on 4 ranks sharing GPU 0 (steps
              [1] and [1, 3]; the 2 ranks are 11g's, after its halo), and
              on a uniform random matrix of the same size on the same 4
              ranks (steps [1, 2, 3], one launch with the 4-rank band):
              only the ``exchange.rdma`` schedules (up to 3 each), Y on
              every rank within the reference dryrun's ``rtol=2e-3`` of the
              host product, both
              shift kernels launched on every rank once per distance and
              schedule, and each distance's shift timed alone per rank;
11i. models — at world size 1 over NCCL and the repo's widths: the
              distributed SpMV (150000 rows of 10 nonzeros; both exchanges
              zero fills), the ring (4 x 8192 x 128: one step folds all
              8192 keys; every step on ``.xla``, on ``.pallas`` and on
              ``.pallas_bf16``, O against the dense float64 O at
              ``F32_O_TOL`` / ``BF16_O_TOL``, ``attn_block`` and
              ``attn_block_bf16`` launched), the TP MLP (the MoE layer's
              widths: 4 chunks of 2048 rows, d 512, d_ff 2048; up to 3 DFS
              schedules and one with every layer split in 2), the pipeline
              and its training step (8 microbatches of 2048 rows, d 512, 2
              chains), each held to its float64 result at the reference
              dryrun's tolerance (dW at ``dryrun.train_tol``, which two
              wrong dW, one microbatch dropped and float16-rounded, must
              fail); then the ring step's fold kernel on the
              8192-key block (f32 and bf16 inputs) against its plain
              version, timed beside its bound.

Every executor captures its schedules as CUDA graphs (runtime/graphs.py),
except the mesh phases' (11e-11i, parallel/dryrun.py builds them with
``graphs=False``: a collective or the mesh shift waits from the host).  The
driver phases run with the default ``--prefetch-compiles 2``; the halo
driver's ``perf.prefetch`` must show hits > 0 and its captures counted
(``compiled_programs``), and the attn driver's row carries the peak device
memory of its run.  Every driver phase runs with no fault flag, so none of
its measurements may fail: its verdict must have no ``fault`` block (which
would count a failure the solvers searched past).
Then the synthesized collectives and the learned screen: ``synth_spmv``
(the spmv driver at m=150000 with ``--synth-collectives``, verified, its
``synth`` block listing the exchange's menu and each instantiation the
card's constants prune with its reason; then at m=150000 and 8192 through
the stream executor with graphs the fixed host round trip and the pipe in
2 and 4 chunks: every pipe schedule's y and x_remote bit-identical to the
fixed one's, y within ``ELL_TOL`` of the float64 product, ``ell_spmv``
launched on every m=8192 schedule, each schedule's graph wall and segment
count), ``synth_halo`` (the mesh halo at world size 1 built with
``synth=True``: all-``.xla``, all-``neighbor.c1`` and a mix with the
``.rdma`` engine at nQ 3, all-``.xla`` and all-``neighbor.c2`` at nQ 2, U
bit-exact on each, ``device_copy`` launched under the ``.rdma`` faces) and
``learn`` (``--learn-train`` on the halo driver phase's own database and
trace, a screened full-size halo search (its screen answers and
escalations, the climbs' prescreen prunes, the model's predictions)
verified, then the same search with an injected device loss: the degraded
verdict, no launch after the loss).
Then ``serve``, the serving plane's core loop (tenzing_tpu_torch/serve/) in
fresh directories under ``chiprun_out/serve/``: (1) ``serve warm --platform
cuda`` of the full-width halo request from the halo driver phase's database
(at least one record admitted verified, every record's source that CSV) and
(2) cold queries of the full-width halo request and the spmv ``--m 8192``
one against fresh stores and queues (tier ``cold``, one work item each,
the item's envelope carrying the query's trace id), both in a child process
that never initializes CUDA (``--serve-child``), traced into
``serve_child.jsonl``;
(3) the halo item drained in this process through ``DrainDaemon`` with
``in_process=True, device="cuda"`` and the cut budget as overrides, into a
segmented store directory (``halo/store.d``; spmv's store stays the
monolithic ``store.json``, so both backends run): the item,
its lease and any ``fail-`` / ``poison-`` file gone, the verdict verified,
records carrying the card's name, ``halo_pack``, ``halo_unpack`` and
``device_copy`` launched, the drain traced by a tracer of its own into
``daemon_halo.jsonl``; (4) after it, the card to itself, the spmv item
drained through ``python -m tenzing_tpu_torch.serve.supervisor
--min-daemons 1 --max-daemons 1 --drain-exit`` (0.2 s tick, compaction and
GC off), whose one member, ``--member-argv``, is ``python -m
tenzing_tpu_torch.serve.daemon --idle-exit 1 --trace-out`` (its subprocess
runner; the ``--exec-item`` child archives its own bundle): the
supervisor's exit 0, reason ``drained``, no restart, no double run, a
complete audit naming the member, ``status-supervisor.json`` written and
CUDA never initialized in the supervisor; the member's status one
completion, the item gone, the child's verdict verified with ``ell_spmv``
among the launches it counted, the store's records what ``scored_rows``
admits from the drain's own database (0 is allowed); (5) both requests re-queried: for each non-empty store the tier is
``exact``, not predicted, verified, with no compile and no measurement, and
the answer, deserialized against the driver's graph, runs on the card
through the stream executor with graphs beside naive on the same buffers
(halo's U bit-exact with naive's, spmv's y within ``ELL_TOL`` of the
float64 product); (6) disaster recovery through ``python -m
tenzing_tpu_torch.serve``: ``merge`` of the spmv store into the halo
directory, ``compact``, ``backup``, the directory's ``segments/`` and
``manifest.json`` deleted, ``restore`` from the generation, ``fsck``: exit
0 with no checksum failure, orphan or missing segment, the same
``record_digest`` set as before the loss, every record's ``device`` the
card; (7) ``serve listen --platform cuda --record DIR --trace-out F`` on the
restored directory and a fresh queue, in a child process that never
initializes CUDA (``--listen-child``), spoken to over stdin and stdout:
``ping``; the halo query twice, both ``exact`` with step 5's schedule, the
second through the fast path (``serve.fp_cache.hits`` up by one in the
``metrics`` verb's registry, and the trace's ``serve.query`` span of its
trace id marked ``fast_path``); a ``batch`` of halo and spmv, both exact; an
spmv ``--m 4096`` request, ``cold``, its work item queued and not drained;
a burst of repeats; ``stats`` and ``metrics`` (the ``slo`` block's exact
count and ``pct99_us``); then EOF: the status document ``stopped``, the
request log one checksum-valid record per admitted request; (8) the halo
and spmv schedules the loop answered, run on the card beside naive through
``_serve_run`` (U bit-exact, y within ``ELL_TOL``), each answer's launches
counted apart from naive's: an answer launches exactly the kernels its menu
slots pick (``halo_pack`` only where a pack sits on a kernel slot), and
``halo_unpack``, ``device_copy`` and ``ell_spmv`` are each launched; (9) in a
child that never initializes CUDA (``--obs-child``): the bundles stitched
(``obs.export``) and analyzed (``obs.causal``): each drained item's trace
spans two or more processes, has ``search``, ``measure`` and ``merge`` above
0 µs and its segments plus ``unattributed`` equal its window within 1 µs;
``obs.alerts check`` on the restored halo directory (which holds the listen
loop's status, snapshots and request log) and the listen queue fires none
of ``stale_heartbeat``, ``poison``, ``store_unwritable``,
``store_damage_rate`` and exits 1 exactly when a rule fires, and with
``--set queue_age.max_s=0`` exits 1 with ``queue_age`` on the undrained cold
item, in a ledger that loads as an ``AlertBook``; ``obs.report`` over the
halo driver phase's database, verdict, trace and metrics, the spmv drain's
database, both stores, the listen queue and the bundles (exit 0, every
section present, ``chiprun_out/report.md``); ``--check`` of the halo
verdict against itself ``ok``, and of the learn phase's screened verdict
against it (printed, exit 2 fails); ``serve.replay --platform cuda
--from-recorded`` of the listen loop's log: ``platform`` ``cuda``, a
``host_noise`` block, every recorded halo request exact on the serving path
(each one's tier read from the path's own request log, ``--record``) with no
verifier call, the spmv requests' tiers printed, the document ``ok`` against
itself; one ``obs.report --follow`` render of step 4's queue, which must
show the supervisor ``stopped``, its member and no breaker, and ``obs.alerts
check`` over that queue, where ``supervisor_crash_loop`` must not fire.
Last, the ``fault`` phase (the fault layer on the ``--m 8192`` spmv path,
``ell_spmv`` launched), each step in fresh processes, the chains run side
by side: (1) a chaos run (``--checkpoint``, ``--inject-faults`` with all four
kinds the driver splits, ``--measure-timeout T``, a hang longer than T)
must be verified with transient, deterministic and corrupt faults injected,
a quarantine, and no quarantined (mutated) schedule among the journal's
measured rows; (2) its ``--resume`` must restore every journaled row,
append no measured line and report the same schedule and value; (3) a
clean checkpointed run is sent SIGINT once its journal holds 5 lines
(``state.json`` must read ``interrupted``), and its ``--resume`` finishes
verified without measuring any schedule journaled before the kill, and
with no failed measurement in either run; (4) a
checkpointed MCTS through the library whose inner benchmarker indexes a
CUDA tensor out of range at its k-th measurement (a device-side assert,
this script's ``--sticky-child``): the resilient layer must classify it
``device_lost`` and ``DeviceLostError`` must leave the search with k-1
measured rows journaled, and a fresh child resumes and finishes without
measuring them again; (5) the serving plane's hostile-filesystem drill,
``python -m tenzing_tpu_torch.fault.fschaos --quick --device cuda --seed
777``: the supervisor and two members drain one halo smoke item on the
card under the seeded fsinject spec (the drill's items there: the attn
smoke items have no kernel at their head dimension, and naive would win),
a member's process group is SIGKILLed mid-drain (no process of it may
outlive the kill), then the ``store_unwritable`` drill: exit 0, every
invariant true, at least one restart, at least one stored record and every
record the drain acknowledged, every stored record naming the card, the
drain child's verdict naming the card, its launches printed.
The halo and attn driver phases run with ``climb_budget=4`` (the halo climbs
run; the reference runs none for attn).  Each driver and example phase sets
every kernel's launch count to 0 just before it and reads the counts just
after.  Then the ``{"kernels": [...]}`` line, the
``nvidia-smi`` line, and last ``{"ok": true, "device": {...}}``.  Without a
CUDA device it prints nothing and exits 2.  Times are CUDA-event times on the
card this runs on.
"""

import contextlib
import json
import os
import subprocess
import sys
import time
from dataclasses import asdict

REPO = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(REPO, "chiprun_out")
PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
PEAK_F32_FLOPS = 67e12  # f32 outside the tensor cores (data sheet)
PEAK_BF16_FLOPS = 989e12  # dense bf16 tensor cores (data sheet)
PEAK_TF32_FLOPS = 495e12  # dense TF32 tensor cores (data sheet)
# the f32 fold and the fused region's attention members compute each
# product as three TF32 products (hi hi + hi lo + lo hi): their bound is
# that count at the TF32 rate; the SIMT bound (PEAK_F32_FLOPS) is reported
# beside it as bound_simt_ms
TF32_SPLIT = 3
# the SpMV regions' fused_region time recorded in PERF.md (the kernel table,
# row 16: the slab-ring instantiation) on an H100 80GB HBM3 at 700 W: the
# fused phase fails when this run's sum of the two regions is more than
# SPMV_REGION_SLACK above it
SPMV_REGION_RECORDED_MS = 0.0620
SPMV_REGION_SLACK = 0.03
# O against the dense float64 attention (F32_O_TOL / BF16_O_TOL) and Y of
# the MoE pipeline against the float64 routed result (F32_Y_TOL /
# BF16_Y_TOL) are the package's limits, which the driver's integrity gate
# uses too (ops/attention_kernels.py, ops/ffn_kernels.py), and ``within``
# (bench/gate.py) is its check; main() imports them before any phase runs.
# A bf16 O with a bias of O_BIAS_CONTROL in every element: under
# BF16_O_TOL's largest-error limit, over its relative rms one, so the
# attention executor phase holds it as the control that must fail.
O_BIAS_CONTROL = 2e-4
# Y of one order with kernels against the same order with plain kernels:
# f32 at the kernel's tolerance; bf16 within one bf16 ulp of the expert
# outputs (an f32 summation difference can flip an output's rounding)
F32_PLAIN_Y_TOL = dict(rtol=1e-4, atol=1e-5)
BF16_PLAIN_Y_TOL = dict(rtol=2.0 ** -7, atol=1e-5)
# The expert-parallel MoE layer's configuration on one card (models/moe.py):
# the width of the repo's MoE model (MoEPipeArgs: d_model 512, d_ff 2048,
# 8192 tokens, 4 chunks) at world size 1, where every token routes to the one
# expert and each chunk's expert MLP is ffn_rows at n = 2048
MOE_LAYER = dict(n_ep=1, tokens_per_shard=8192, d_model=512, d_ff=2048,
                 n_chunks=4)  # parallel/dryrun.py FULL_ARGS at n_ep 1
MOE_LAYER_ITERS = 12  # the layer's explore through DistControlPlane
MESH_HALO_ITERS = 12  # the mesh halo's MCTS on the engine menu
HOST_SYNC_ITERS = 8  # iterations per measurement of the host_syncs phase
# the MCTS depth of every driver run and serve drain the smoke drives (the
# fault chains keep their own budget); 8 since the spmv driver's climbs
# went through the search fleet, to keep the smoke inside its time limit
DRIVER_MCTS_ITERS = 8
HALO_PROFILE_REPEATS = 3  # the halo driver phase's --profile-repeats
FLUSH_BYTES = 128 << 20  # > the 50 MB L2: each timed launch starts cold
REPS = 15

_log = None


def emit(obj) -> None:
    line = json.dumps(obj)
    print(line, flush=True)
    _log.write(line + "\n")
    _log.flush()


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


class Timer:
    """Median CUDA-event time of single launches, each after an L2 flush.

    A spin kernel ahead of each timed launch keeps the card busy while the
    host enqueues the flush, the events and the launch, so the interval
    between the two events holds the launch's device time and not the
    host's Python overhead of issuing it."""

    SPIN_CYCLES = 2_000_000  # ~1 ms at the H100's clock: longer than enqueueing

    def __init__(self, torch, device):
        self.torch = torch
        self.flush_buf = torch.empty(FLUSH_BYTES // 4, device=device)

    def ms(self, fn, reps: int = REPS, clean: bool = False) -> float:
        """``clean``: flush with a read (``sum``) instead of a write, which
        leaves the L2 clean rather than full of dirty lines that the call's
        own traffic must write back."""
        torch = self.torch
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            torch.cuda._sleep(self.SPIN_CYCLES)
            if clean:
                self.flush_buf.sum()
            else:
                self.flush_buf.fill_(1.0)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        times.sort()
        return times[len(times) // 2]


def bound_ms(nbytes: int) -> float:
    return nbytes / PEAK_BYTES_PER_S * 1e3


def attn_bound(nbytes: float, flops: float, bf16: bool):
    """(bound ms, what bounds it): the larger of the bytes over the memory
    rate and the operations over the peak rate of their type: bf16 on the
    tensor cores, or f32 as the split's TF32_SPLIT TF32 products."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = (flops / PEAK_BF16_FLOPS if bf16
             else TF32_SPLIT * flops / PEAK_TF32_FLOPS) * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def region_instantiation(table):
    """The library's answer for the instantiation that runs ``table`` (an
    ops/fused_region.RegionTable): threads and shared memory of its first
    descriptor table, beside the Python mirror's (fr.instantiation)."""
    import ctypes

    from tenzing_tpu_torch.ops import fused_region as fr
    from tenzing_tpu_torch.ops import kernel_lib

    lib = kernel_lib.lib()
    got = {"threads": int(lib.tz_fused_region_threads(
               ctypes.addressof(table.tables[0]))),
           "smem_bytes": int(lib.tz_fused_region_smem(
               ctypes.addressof(table.tables[0])))}
    want = fr.instantiation(table.members)
    return got, {k: want[k] for k in got}


def _launch_counts():
    from tenzing_tpu_torch.ops import attention_kernels as ak
    from tenzing_tpu_torch.ops import ffn_kernels as fk
    from tenzing_tpu_torch.ops import fused_region as fr
    from tenzing_tpu_torch.ops import halo_kernels as hk
    from tenzing_tpu_torch.ops import rdma
    from tenzing_tpu_torch.ops import spmv_kernels as sk

    return (hk.LAUNCHES, rdma.LAUNCHES, ak.LAUNCHES, fk.LAUNCHES, sk.LAUNCHES,
            fr.LAUNCHES)


def reset_launches():
    for counts in _launch_counts():
        for k in counts:
            counts[k] = 0


def all_launches():
    out = {}
    for counts in _launch_counts():
        out.update(counts)
    return out


def outside_same(torch, got, before, starts, sizes, what: str) -> None:
    """Raise unless ``got`` equals ``before`` everywhere outside the cut."""
    from tenzing_tpu_torch.models.halo import face_view

    probe = got.clone()
    face_view(probe, starts, sizes).copy_(face_view(before, starts, sizes))
    same = torch.equal(probe, before)
    del probe
    if not same:
        raise AssertionError(f"{what}: wrote outside its cut")


def halo_bodies(torch, hk, kind, u, face, want, starts, sizes, rpb, timer):
    """The body the library plans for this call (``tz_halo_plan``) against
    ``halo_launch_plan``, and, where that is TMA (the x and y unpacks), the
    SIMT body forced through ``launch_body``: bit-exact against ``want``
    (the plain version's U) and timed.  ``face`` is the call's face buffer."""
    pack = kind == "pack"
    plan = hk.library_plan(u, face, starts, sizes, pack)
    mirror = hk.halo_launch_plan(u.shape, starts, sizes, pack, face.data_ptr(),
                                 sms=torch.cuda.get_device_properties(
                                     u.device).multi_processor_count)
    if plan != {k: mirror[k] for k in hk.PLAN_FIELDS}:
        raise AssertionError(f"halo_{kind} plan {plan} != mirror {mirror}")
    out = {"body": plan["body"], "plan": plan}
    if plan["body"] != "tma":
        return out
    dst = u.clone()
    hk.launch_body("unpack", dst, face, starts, sizes, rpb, "simt")
    torch.cuda.synchronize()
    if not torch.equal(dst, want):
        raise AssertionError(f"halo_{kind} with the SIMT body forced differs "
                             "from its plain version")
    out["simt_ms"] = timer.ms(lambda: hk.launch_body(
        "unpack", dst, face, starts, sizes, rpb, "simt"))
    del dst
    return out


def capture_perf(verdict) -> dict:
    """A driver JSON's capture provenance: the schedules it captured as CUDA
    graphs, the capture wall, the prefetch pipeline's tallies and the graph
    cache."""
    perf = verdict.get("perf") or {}
    return {k: perf.get(k) for k in ("compiled_programs", "compile_secs",
                                     "prefetch", "graphs")}


def check_prefetch(verdict, phase: str) -> None:
    """The driver ran with the default ``--prefetch-compiles 2``: the
    pipeline must have captured schedules the foreground then measured."""
    perf = capture_perf(verdict)
    pf = perf["prefetch"] or {}
    if pf.get("workers") != 2 or pf.get("hits", 0) <= 0:
        raise AssertionError(f"{phase}: no prefetch hit: {perf}")
    if not perf["compiled_programs"] or perf["compiled_programs"] <= 0:
        raise AssertionError(f"{phase}: nothing was captured: {perf}")


# captured replay against eager on the fixed schedules: bit for bit where
# the schedule only moves data or runs the same kernels in the same order
# (halo, spmv); attention and moe within these (PyTorch may pick another
# GEMM algorithm for a captured .xla op)
GRAPH_ATTN_TOL = 1e-4  # max |O, acc, m, l diff|: far below F32_STATE_TOL
GRAPH_MOE_TOL = 1e-4  # max |Y diff| (Y is O(1))


def phase_graphs(torch, device):
    """Each fixed schedule of bench/breakdown.py (halo, attn, moe, spmv) on
    an executor that replays CUDA graphs and on one that dispatches every op
    (``graphs=False``), over the same buffers: the wall per iteration of
    each, one run's outputs compared, the schedule's segments and graphs.
    Fails when an output differs (beyond the stated tolerance for attention
    and moe) or when a schedule has no graph.  (The launch counts under
    replay are the driver phases' checks: every executor there captures.)"""
    from tenzing_tpu_torch.bench import breakdown

    rows = []

    def sink(row):
        row = {"phase": "graphs", **row}
        emit(row)
        rows.append(row)

    opts = breakdown.Opts(iters=20, profile=False, attrib=False, emit=sink)
    for w in ("halo", "attn", "moe", "spmv"):
        breakdown.WORKLOADS[w](device, opts)
        torch.cuda.empty_cache()
    for r in rows:
        exact = not r["workload"].startswith(("attn", "moe"))
        tol = 0.0 if exact else (GRAPH_ATTN_TOL if r["workload"] == "attn"
                                 else GRAPH_MOE_TOL)
        if (r["outputs_max_abs_diff"] > tol
                or (exact and not r["outputs_equal"])):
            raise AssertionError(f"graphs: replay differs from eager: {r}")
        if r["graphs"] <= 0:
            raise AssertionError(f"graphs: nothing captured: {r}")
    return rows


def phase_kernels(torch, device, timer):
    """Every kernel slot at the flagship shapes against its plain version."""
    from tenzing_tpu_torch.models.halo import (
        DIRECTIONS,
        HaloArgs,
        _face_slices,
        dir_name,
        face_view,
    )
    from tenzing_tpu_torch.bench import halo_kernels as halo_bench
    from tenzing_tpu_torch.models.halo_pipeline import _padded_shape
    from tenzing_tpu_torch.ops import halo_kernels as hk
    from tenzing_tpu_torch.ops import rdma

    args = HaloArgs(nq=3, lx=512, ly=512, lz=512, radius=3)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    u = torch.rand(_padded_shape(args.local_shape()), device=device,
                   generator=gen)
    summary = {"halo_pack": [], "halo_unpack": [], "device_copy": []}
    slots = {".pallas": (False, False), ".pallasb": (True, False),
             ".pallasf": (True, True)}  # suffix -> (batched, flat)
    for d in DIRECTIONS:
        name = dir_name(d)
        starts, sizes = _face_slices(args, d, "pack")
        ustarts, _ = _face_slices(args, d, "unpack")
        n = int(sizes[0] * sizes[1] * sizes[2] * sizes[3])
        rows = -(-n // 128)
        pack_menu = [c.name()[len(f"pack_{name}"):]
                     for c in hk.PackChoice(args, d).choices()]
        unpack_menu = [c.name()[len(f"unpack_{name}"):]
                       for c in hk.UnpackChoice(args, d).choices()]
        face_bytes = 2 * n * 4
        recv = None
        for suffix in pack_menu:
            if suffix not in slots:
                continue
            batched, flat = slots[suffix]
            rpb = hk._rows_per_block(u, starts, sizes) if batched else 1
            shape = (rows, 128) if flat else tuple(sizes)
            got = torch.zeros(shape, device=device)
            want = torch.zeros(shape, device=device)
            hk.halo_pack(u, got, starts, sizes, rpb)
            hk.halo_pack_plain(u, want, starts, sizes)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            if not torch.equal(got, want):
                raise AssertionError(f"halo_pack{suffix} {name}: differs from "
                                     f"its plain version (max abs err {err})")
            uview = face_view(u, starts, sizes)
            face4d = want.view(-1)[:n].view(tuple(sizes))
            row = {"kernel": "halo_pack", "face": name, "slot": suffix,
                   "rows_per_block": rpb, "shape": list(sizes), "exact": True,
                   "max_abs_err": err,
                   **halo_bodies(torch, hk, "pack", u, got, want, starts,
                                 sizes, rpb, timer),
                   "ms": timer.ms(lambda: hk.halo_pack(u, got, starts, sizes, rpb)),
                   "plain_ms": timer.ms(
                       lambda: hk.halo_pack_plain(u, want, starts, sizes)),
                   "library_ms": timer.ms(lambda: face4d.copy_(uview)),
                   "bound_ms": bound_ms(face_bytes)}
            if d[2]:
                row["sector_bound_ms"] = bound_ms(
                    halo_bench.sector_bytes(u.shape, starts, sizes))
            emit(row)
            summary["halo_pack"].append(row)
            recv = want.view(-1)[:n].clone()
        staging = torch.zeros(rows * 128, device=device)
        staging[:n] = recv
        for suffix in unpack_menu:
            if suffix not in slots:
                continue
            batched, _ = slots[suffix]
            rpb = hk._rows_per_block(u, ustarts, sizes) if batched else 1
            ug, uw = u.clone(), u.clone()
            hk.halo_unpack(ug, staging, ustarts, sizes, rpb)
            hk.halo_unpack_plain(uw, staging, ustarts, sizes)
            torch.cuda.synchronize()
            same = torch.equal(ug, uw)
            err = float((face_view(ug, ustarts, sizes)
                         - face_view(uw, ustarts, sizes)).abs().max())
            if not same:
                raise AssertionError(f"halo_unpack{suffix} {name}: differs "
                                     f"from its plain version (max abs err {err})")
            outside_same(torch, ug, u, ustarts, sizes, f"halo_unpack{suffix} {name}")
            bodies = halo_bodies(torch, hk, "unpack", u, staging, uw, ustarts,
                                 sizes, rpb, timer)
            del uw
            uview = face_view(ug, ustarts, sizes)
            face4d = staging[:n].view(tuple(sizes))
            row = {"kernel": "halo_unpack", "face": name, "slot": suffix,
                   "rows_per_block": rpb, "shape": list(sizes), "exact": True,
                   "max_abs_err": err, "outside_cut_untouched": True, **bodies,
                   "ms": timer.ms(
                       lambda: hk.halo_unpack(ug, staging, ustarts, sizes, rpb)),
                   "plain_ms": timer.ms(
                       lambda: hk.halo_unpack_plain(ug, staging, ustarts, sizes)),
                   "library_ms": timer.ms(lambda: uview.copy_(face4d)),
                   "bound_ms": bound_ms(face_bytes)}
            if d[2]:
                row["sector_bound_ms"] = bound_ms(
                    halo_bench.sector_bytes(u.shape, ustarts, sizes))
            emit(row)
            summary["halo_unpack"].append(row)
            del ug
        src = staging.view(rows, 128)
        dst = torch.zeros_like(src)
        rdma.device_copy(src, dst)
        ref = torch.zeros_like(src)
        rdma.device_copy_plain(src, ref)
        torch.cuda.synchronize()
        err = float((dst - ref).abs().max())
        if not torch.equal(dst, ref):
            raise AssertionError(f"device_copy {name}: differs from copy_")
        row = {"kernel": "device_copy", "face": name, "slot": ".rdma",
               "shape": [rows, 128], "exact": True, "max_abs_err": err,
               "ms": timer.ms(lambda: rdma.device_copy(src, dst)),
               "clean_ms": timer.ms(lambda: rdma.device_copy(src, dst),
                                    clean=True),
               "plain_ms": timer.ms(lambda: rdma.device_copy_plain(src, ref)),
               "library_ms": timer.ms(lambda: dst.copy_(src)),
               "library_clean_ms": timer.ms(lambda: dst.copy_(src), clean=True),
               "bound_ms": bound_ms(2 * rows * 128 * 4)}
        emit(row)
        summary["device_copy"].append(row)
    del u
    torch.cuda.empty_cache()
    return summary


def phase_executor(torch, device):
    """Whole schedules through the stream executor, kernels vs plain."""
    from tenzing_tpu_torch.bench.driver import halo_alias_prefer
    from tenzing_tpu_torch.core.platform import Platform
    from tenzing_tpu_torch.models.halo import HaloArgs
    from tenzing_tpu_torch.models.halo_pipeline import (
        HALO_PHASES,
        build_graph,
        greedy_overlap_order,
        host_buffer_names,
        make_pipeline_buffers,
        naive_order,
    )
    from tenzing_tpu_torch.runtime.executor import StreamExecutor, buffers_from_numpy
    from tenzing_tpu_torch.solve.local import drive, phase_policy
    from tenzing_tpu_torch.verify import ScheduleVerifier

    args = HaloArgs(nq=3, lx=512, ly=512, lz=512, radius=3)
    t0 = time.time()
    bufs, want = make_pipeline_buffers(args, seed=0, with_expected=True)
    want_dev = torch.from_numpy(want).to(device)
    del want
    tbufs = buffers_from_numpy(bufs, device, host_buffer_names())
    del bufs
    setup_s = time.time() - t0
    plat = Platform.make_n_lanes(8)
    kern = StreamExecutor(plat, tbufs, device="cuda")
    plain = StreamExecutor(plat, tbufs, device="cuda", plain_kernels=True)
    choice_g = build_graph(args, impl_choice=True, xfer_choice=True)

    def prefer_kernels(op_name, choices):
        if op_name.startswith("xfer_"):
            return next(c for c in choices if c.endswith(".rdma"))
        for suffix in (".pallasf", ".pallasb", ".pallas"):
            hit = next((c for c in choices if c.endswith(suffix)), None)
            if hit is not None:
                return hit
        return None

    orders = {
        "naive": (naive_order(args, plat), build_graph(args)),
        "greedy-host-8l": (greedy_overlap_order(args, plat, "host"),
                           build_graph(args, engine="host")),
        "greedy-rdma-8l": (greedy_overlap_order(args, plat, "rdma"),
                           build_graph(args, engine="rdma")),
        "greedy-mixed-8l": (greedy_overlap_order(args, plat, "mixed"),
                            build_graph(args, engine="mixed")),
        "alias-8l": (drive(choice_g, plat, phase_policy(
            plat, HALO_PHASES, halo_alias_prefer))[0], choice_g),
        "kernels-8l": (drive(choice_g, plat, phase_policy(
            plat, HALO_PHASES, prefer_kernels))[0], choice_g),
    }
    rows = []
    for label, (order, graph) in orders.items():
        if not ScheduleVerifier(graph)(order).ok:
            raise AssertionError(f"executor phase: {label} is not sound")
        t0 = time.time()
        out_k = kern.run(order)
        out_p = plain.run(order)
        same_plain = all(torch.equal(out_k[k], out_p[k]) for k in out_k)
        same_want = torch.equal(out_k["U"], want_dev)
        del out_k, out_p
        ptrs = {k: v.data_ptr() for k, v in kern.init_bufs.items()}
        kern.prepare_n(order)(3)
        ptrs_ok = ptrs == {k: v.data_ptr() for k, v in kern.init_bufs.items()}
        timed_ok = torch.equal(kern.init_bufs["U"], want_dev)
        row = {"phase": "executor", "order": label, "ops": len(order),
               "equal_plain": same_plain, "equal_expected": same_want,
               "data_ptr_unchanged": ptrs_ok, "timed_runs_expected": timed_ok,
               "wall_s": round(time.time() - t0, 3)}
        emit(row)
        rows.append(row)
        if not (same_plain and same_want and ptrs_ok and timed_ok):
            raise AssertionError(f"executor phase failed on {label}: {row}")
    del kern, plain, tbufs, want_dev
    torch.cuda.empty_cache()
    return {"setup_s": round(setup_s, 3), "orders": len(rows)}


def attn_full_args():
    from tenzing_tpu_torch.bench.driver import DriverRequest, attn_args

    return attn_args(DriverRequest(workload="attn"))


def dense_o(torch, q, k, v, scale):
    """The dense float64 attention the driver's gate holds O to
    (bench/gate.py ``dense_attention64``), as float32."""
    from tenzing_tpu_torch.bench.gate import dense_attention64

    return dense_attention64(q, k, v, scale).float()


CONTROLS = ("p_unrounded", "v_truncated", "f32")


def control_fold(torch, ak, q, k, v, state, scale, bkv, fault):
    """The plain bf16 fold of q/k/v into ``state`` (in place, ``bkv`` keys at
    a time) with one deliberate fault, a control that the bf16 tolerance
    must reject: ``p_unrounded`` keeps p in f32 for p v, ``v_truncated``
    rounds V toward zero instead of to nearest, ``f32`` rounds nothing."""
    if fault != "f32":
        q, k = (t.to(torch.bfloat16).float() for t in (q, k))
        v = ((v.view(torch.int32) & -65536).view(torch.float32)
             if fault == "v_truncated" else v.to(torch.bfloat16).float())
    b, n, d = q.shape
    for j in range(0, k.shape[1], bkv):
        kb, vb = k[:, j:j + bkv], v[:, j:j + bkv]
        work = [torch.empty(shape, device=q.device) for shape, _ in
                ak.fold_scratch(b, n, kb.shape[1], d).values()]
        ak.fold_into(q, kb, vb, *state, scale, *work,
                     bf16_p=fault == "v_truncated")


def phase_attn_kernels(torch, device, timer):
    """Both attention kernels at the full-width shapes against their plain
    versions, with controls, times and bounds; first the bf16 kernel's
    build report, launch constants and stress cases."""
    import torch.nn.functional as F

    from tenzing_tpu_torch.bench import attn_bf16, attn_f32
    from tenzing_tpu_torch.ops import attention_kernels as ak
    from tenzing_tpu_torch.ops import kernel_lib

    a = attn_full_args()
    ptxas_text = str(kernel_lib.build_info.get("ptxas", ""))
    ptxas = attn_bf16.ptxas_report(ptxas_text)
    ptxas_f32 = attn_f32.ptxas_reports(ptxas_text)
    mismatch_f32 = attn_f32.config_mismatch(a.batch, a.n_devices * a.seq_local,
                                            a.n_devices * a.seq_local)
    stress_f32 = {}
    for name in attn_f32.STRESS_CASES:
        ok, info = attn_f32.run_case(torch, device, name)
        stress_f32[name] = {"ok": ok, **info}
    ok, info = attn_f32.run_region_case(torch, device)
    stress_f32["region-key-off"] = {"ok": ok, **info}
    emit({"phase": "attn_f32_checks", "ptxas": ptxas_f32,
          "config": attn_f32.library_config(),
          "config_mismatch": mismatch_f32, "stress": stress_f32})
    bad = [k for k, r in stress_f32.items() if not r["ok"]]
    if mismatch_f32 or bad:
        raise AssertionError(f"attn_fold_f32: launch constants {mismatch_f32}, "
                             f"stress cases failed {bad}")
    mismatch = attn_bf16.config_mismatch(a.batch, a.n_devices * a.seq_local,
                                         a.n_devices * a.seq_local,
                                         a.seq_local)
    stress = {}
    for name in attn_bf16.STRESS_CASES:
        ok, info = attn_bf16.run_case(torch, device, name)
        stress[name] = {"ok": ok, **info}
    emit({"phase": "attn_bf16_checks", "ptxas": ptxas,
          "config": attn_bf16.library_config(), "config_mismatch": mismatch,
          "stress": stress})
    bad = [k for k, r in stress.items() if not r["ok"]]
    if mismatch or bad:
        raise AssertionError(f"attn_fold_bf16: launch constants {mismatch}, "
                             f"stress cases failed {bad}")
    b, n, d, blk = a.batch, a.n_devices * a.seq_local, a.head_dim, a.seq_local
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    q, k, v = (torch.randn(b, n, d, device=device, generator=gen)
               for _ in range(3))
    want_o = dense_o(torch, q, k, v, a.scale)

    def init_state(bb, nn):
        return [torch.zeros(bb, nn, d, device=device),
                torch.full((bb, nn, d), -1e30, device=device),
                torch.zeros(bb, nn, d, device=device)]

    mid = init_state(b, n)  # the state after three f32 folds
    for s in range(3):
        ak.attn_block_plain(q, k[:, s * blk:(s + 1) * blk],
                            v[:, s * blk:(s + 1) * blk], *mid, a.scale)
    cases = []  # (label, kernel, bf16, q, k, v, state, library call)
    for bf16 in (False, True):
        tag = "bf16" if bf16 else "f32"
        cases.append((f"block-{tag}-init", "attn_block", bf16, q,
                      k[:, :blk], v[:, :blk], init_state(b, n), None))
        cases.append((f"block-{tag}-after3", "attn_block", bf16, q,
                      k[:, 3 * blk:4 * blk], v[:, 3 * blk:4 * blk],
                      [t.clone() for t in mid], None))
        # the library yardstick: one scaled_dot_product_attention call over
        # (batch, 1 head, n, d) views, in the inputs' type
        lq, lk, lv = ((t.to(torch.bfloat16) if bf16 else t).unsqueeze(1)
                      for t in (q, k, v))
        cases.append((f"fused-{tag}", "attn_fused", bf16, q, k, v,
                      init_state(b, n),
                      lambda lq=lq, lk=lk, lv=lv:
                      F.scaled_dot_product_attention(lq, lk, lv)))
        cases.append((f"block-{tag}-ragged", "attn_block", bf16,
                      q[:1, :1000], k[:1, :blk], v[:1, :blk],
                      init_state(1, 1000), None))
    rows, failed = [], []
    for label, kernel, bf16, cq, ck, cv, st, library in cases:
        kern = getattr(ak, kernel)
        plain = getattr(ak, kernel + "_plain")
        kw = {"bkv": blk} if kernel == "attn_fused" else {}
        got, want = [t.clone() for t in st], [t.clone() for t in st]
        kern(cq, ck, cv, *got, a.scale, bf16_inputs=bf16, **kw)
        plain(cq, ck, cv, *want, a.scale, bf16_inputs=bf16, **kw)
        torch.cuda.synchronize()
        tol = ak.BF16_STATE_TOL if bf16 else ak.F32_STATE_TOL
        o_tol = BF16_O_TOL if bf16 else F32_O_TOL
        ok, errs = ak.state_check(got, want, tol)
        finite = all(bool(torch.isfinite(t).all()) for t in got)
        nb, nq, nkv = cq.shape[0], cq.shape[1], ck.shape[1]
        bound, bound_by = attn_bound(ak.fold_bytes(nb, nq, nkv, d),
                                     ak.attention_flops(nb, nq, nkv, d), bf16)
        row = {"phase": "attn_kernels", "case": label, "kernel": kernel,
               "bf16_inputs": bf16, "shape": [nb, nq, nkv, d],
               "max_abs_err": max(e["max_abs"] for e in errs.values()),
               "errors": errs, "within_tol": ok, "finite": finite,
               "tolerance": tol}
        states = {"kernel": got, "plain": want}
        row["controls"] = {}
        for fault in (CONTROLS if bf16 else ("tf32_single_pass",)):
            ctl = [t.clone() for t in st]
            if bf16:
                control_fold(torch, ak, cq, ck, cv, ctl, a.scale,
                             ck.shape[1] if kernel == "attn_block" else blk,
                             fault)
            else:  # one TF32 pass per product instead of the split's three
                attn_f32.tf32_fold_plain(torch, cq, ck, cv, ctl, a.scale,
                                         passes=1)
            c_ok, c_errs = ak.state_check(ctl, want, tol)
            row["controls"][fault] = {"errors": c_errs, "within_tol": c_ok}
            states[fault] = ctl
        row["controls_rejected"] = not any(
            c["within_tol"] for c in row["controls"].values())
        if kernel == "attn_fused":  # from the initial state: O = acc / l
            row["o_vs_expected"] = {}
            for who, (acc, _, l) in states.items():
                o_ok, o_errs = within(acc / l, want_o, o_tol)
                row["o_vs_expected"][who] = {**o_errs, "within_tol": o_ok}
            row["o_tolerance"] = o_tol
        del states
        row.update({
            "ms": timer.ms(lambda: kern(cq, ck, cv, *got, a.scale,
                                        bf16_inputs=bf16, **kw)),
            "plain_ms": timer.ms(lambda: plain(cq, ck, cv, *want, a.scale,
                                               bf16_inputs=bf16, **kw)),
            "library_ms": timer.ms(library) if library else None,
            "bound_ms": bound, "bound_by": bound_by})
        flops = ak.attention_flops(nb, nq, nkv, d)
        row["tflops"] = flops / (row["ms"] * 1e-3) / 1e12
        if bf16:  # the wrapper's time includes its K/V casts
            row.update({
                "bound_two_pass_ms": 1.5 * flops / PEAK_BF16_FLOPS * 1e3,
                "cast_ms": timer.ms(lambda: ak.cast_kv_bf16(ck, cv)),
                "ptxas": ptxas})
        else:
            row.update({"bound_simt_ms": flops / PEAK_F32_FLOPS * 1e3,
                        "ptxas": ptxas_f32})
        emit(row)
        rows.append(row)
        o_ok = row.get("o_vs_expected", {}).get("kernel", {}).get("within_tol",
                                                                   True)
        if not (ok and finite and o_ok and row["controls_rejected"]):
            failed.append(label)
        del got, want
    del q, k, v, mid, cases, want_o
    torch.cuda.empty_cache()
    if failed:
        raise AssertionError(f"attn kernels phase failed on {failed}")
    return rows


def phase_attn_executor(torch, device):
    """The fixed attention orders through the stream executor at full width,
    kernels vs plain kernels vs the dense expected O."""
    from tenzing_tpu_torch.bench.driver import attn_graph
    from tenzing_tpu_torch.core.platform import Platform
    from tenzing_tpu_torch.models.ring_attention import (
        fixed_orders,
        make_blocked_buffers,
    )
    from tenzing_tpu_torch.ops import attention_kernels as ak
    from tenzing_tpu_torch.runtime.executor import StreamExecutor, buffers_from_numpy
    from tenzing_tpu_torch.verify import ScheduleVerifier

    a = attn_full_args()
    t0 = time.time()
    bufs, _ = make_blocked_buffers(a, seed=0, with_expected=False)
    tbufs = buffers_from_numpy(bufs, device)
    del bufs
    want_o = dense_o(torch, tbufs["Q"], tbufs["K"], tbufs["V"], a.scale)
    setup_s = time.time() - t0
    plat = Platform.make_n_lanes(2)
    kern = StreamExecutor(plat, tbufs, device="cuda")
    plain = StreamExecutor(plat, tbufs, device="cuda", plain_kernels=True)
    g = attn_graph(a)
    rows, failed = [], []
    for label, order in fixed_orders(g, a.n_devices).items():
        if not ScheduleVerifier(g)(order).ok:
            raise AssertionError(f"attn executor phase: {label} is not sound")
        t0 = time.time()
        f32 = label in ("naive", "pallas-2l", "fused")
        tol = ak.F32_STATE_TOL if f32 else ak.BF16_STATE_TOL
        o_tol = F32_O_TOL if f32 else BF16_O_TOL
        out_k = kern.run(order)
        out_p = plain.run(order)
        names = ("acc", "m_run", "l_run")
        ok_plain, errs = ak.state_check([out_k[x] for x in names],
                                        [out_p[x] for x in names], tol)
        ok_plain = ok_plain and torch.allclose(out_k["O"], out_p["O"],
                                               **tol["acc/l"])
        ok_want, o_errs = within(out_k["O"], want_o, o_tol)
        control = None
        if not f32:  # a bias spread thin: only the relative rms catches it
            c_ok, c_errs = within(out_k["O"] + O_BIAS_CONTROL, want_o, o_tol)
            control = {"bias": O_BIAS_CONTROL, "errors": c_errs,
                       "within_tol": c_ok,
                       "under_max_abs": c_errs["max_abs"] <= o_tol["max_abs"]}
            ok_want = ok_want and not c_ok
        del out_k, out_p
        ptrs = {k: v.data_ptr() for k, v in kern.init_bufs.items()}
        run_n = kern.prepare_n(order)
        run_n(1)
        allocs0 = torch.cuda.memory_stats(device)["allocation.all.allocated"]
        run_n(3)
        allocs = (torch.cuda.memory_stats(device)["allocation.all.allocated"]
                  - allocs0)
        ptrs_ok = ptrs == {k: v.data_ptr() for k, v in kern.init_bufs.items()}
        row = {"phase": "attn_executor", "order": label, "ops": len(order),
               "tolerance": tol, "vs_plain": errs, "within_tol_plain": ok_plain,
               "o_tolerance": o_tol, "o_vs_expected": o_errs,
               "bias_control": control, "within_tol_expected": ok_want,
               "data_ptr_unchanged": ptrs_ok,
               "allocations_in_3_timed_runs": allocs,
               "wall_s": round(time.time() - t0, 3)}
        emit(row)
        rows.append(row)
        if not (ok_plain and ok_want and ptrs_ok):
            failed.append(label)
    del kern, plain, tbufs
    torch.cuda.empty_cache()
    if failed:
        raise AssertionError(f"attn executor phase failed on {failed}")
    return want_o, {"setup_s": round(setup_s, 3), "orders": len(rows)}


def check_no_failures(verdict, phase: str) -> None:
    """A driver run with no fault flag: every measurement must have
    succeeded, so the verdict has no ``fault`` block (it would count the
    failures the solvers searched past, bench/driver.py
    ``FAILURE_COUNTERS``)."""
    if "fault" in verdict:
        raise AssertionError(f"{phase}: a measurement failed in a run with no "
                             f"fault flag: {verdict['fault']}")


def phase_attn_driver(torch, device, want_o):
    """The attention search at full width; returns the launch counts.  The
    result must be verified: the gate holds O to the dense float64
    attention at the precision each run took (bench/gate.py)."""
    from tenzing_tpu_torch.bench import driver

    t0 = time.time()
    req = driver.DriverRequest(workload="attn", mcts_iters=DRIVER_MCTS_ITERS,
                               iters=3, search_iters=2, climb_budget=4)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    reset_launches()
    result = driver.run(req, device="cuda")
    launches = all_launches()
    verdict = result.verdict
    print(result.to_json_line(), flush=True)
    row = {"phase": "attn_driver", "launches": launches,
           "verified": verdict.get("verified"),
           "value": verdict.get("value"),
           "vs_baseline": verdict.get("vs_baseline"),
           "winner_label": verdict.get("winner_label"),
           "diverged": verdict.get("diverged"),
           "demoted_label": verdict.get("demoted_label"),
           "gate": verdict.get("gate"),
           "perf": capture_perf(verdict),
           "peak_allocated_gib": round(
               torch.cuda.max_memory_allocated(device) / 2 ** 30, 3),
           "peak_reserved_gib": round(
               torch.cuda.max_memory_reserved(device) / 2 ** 30, 3),
           "wall_s": round(time.time() - t0, 3)}
    emit(row)
    if verdict.get("metric") != "attn_blockwise_pct50_searched_n8192":
        raise AssertionError(f"attn driver metric {verdict.get('metric')!r}")
    # the bf16 incumbents run both bf16 kernels; the search, the f32 ones
    missing = [k for k in ("attn_block_bf16", "attn_fused_bf16")
               if launches[k] <= 0]
    missing += [k for k in ("attn_block", "attn_fused")
                if launches[k] + launches[k + "_bf16"] <= 0]
    if missing:
        raise AssertionError(f"the attn path never launched {missing}")
    check_no_failures(verdict, "attn driver")
    if verdict.get("verified") is not True or not verdict.get("gate"):
        raise AssertionError(f"attn driver result not verified: {verdict}")
    torch.cuda.empty_cache()
    return launches


def moe_full():
    """(MoEPipeArgs, numpy buffers with both staging sets, capacity) of the
    full-width pipeline (the driver's moe configuration)."""
    from tenzing_tpu_torch.bench.driver import DriverRequest, moe_args
    from tenzing_tpu_torch.models.moe_pipeline import make_pipe_buffers

    a = moe_args(DriverRequest(workload="moe"))
    bufs, _, cap = make_pipe_buffers(a, seed=0, with_expected=False,
                                     staging="choice")
    return a, bufs, cap


def dense_moe_y(torch, bufs, a):
    """The dense routed evaluation in float64 on the card (the reference's
    expected Y, moe_pipeline.py:570-580): every routed token through its
    expert's tanh-gelu MLP, scaled by its gate weight.  The routing comes from
    the slot tables (idx_c, w_c), whose gate weights are float32."""
    w1, w2 = bufs["W1"].double(), bufs["W2"].double()
    tc = a.chunk_tokens
    want = torch.zeros(a.tokens, a.d_model, dtype=torch.float64,
                       device=w1.device)
    for c in range(a.n_chunks):
        xc = bufs["X"][c * tc:(c + 1) * tc].double()
        idx, w = bufs[f"idx_{c}"].long(), bufs[f"w_{c}"].double()
        for e in range(a.n_experts):
            real = w[e] > 0
            rows = idx[e][real]
            h = xc[rows] @ w1[e]
            h = 0.5 * h * (1.0 + torch.tanh((2.0 / torch.pi) ** 0.5
                                            * (h + 0.044715 * h ** 3)))
            want[c * tc + rows] = w[e][real, None] * (h @ w2[e])
    return want


def dropped_expert(bufs, y, a, expert: int = 0):
    """The control: Y with every token routed to ``expert`` zeroed, as if
    that expert's gate weights were dropped."""
    out = y.clone()
    tc = a.chunk_tokens
    for c in range(a.n_chunks):
        w = bufs[f"w_{c}"][expert]
        out[c * tc + bufs[f"idx_{c}"][expert][w > 0].long()] = 0.0
    return out


def split_controls(torch, x, w1, w2, want, tol) -> dict:
    """The f32 FFN kernel's arithmetic emulated in plain PyTorch with three
    TF32 passes per product (must pass ``tol`` against the plain version)
    and with one (the single-TF32 control: must fail it)."""
    from tenzing_tpu_torch.bench import ffn_f32

    out = {}
    for passes in (3, 1):
        emu = ffn_f32.tf32_ffn_plain(torch, x, w1, w2, passes)
        out[f"tf32_{passes}pass_max_abs_err"] = float((emu - want).abs().max())
        out[f"tf32_{passes}pass_within_tol"] = bool(torch.allclose(emu, want,
                                                                   **tol))
        del emu
    out["split_controls_ok"] = (out["tf32_3pass_within_tol"]
                                and not out["tf32_1pass_within_tol"])
    return out


def phase_moe_kernels(torch, device, timer):
    """``ffn_batched`` at the main path's shapes and at ragged ones against
    its plain version, with the erf control, times and the bound."""
    import torch.nn.functional as F

    from tenzing_tpu_torch.bench import attn_common, ffn_f32
    from tenzing_tpu_torch.ops import ffn_kernels as fk
    from tenzing_tpu_torch.ops import kernel_lib

    a, bufs, cap = moe_full()
    # the main path's launch: chunk 0's slot table through the experts
    x_tok = torch.from_numpy(bufs["X"][:a.chunk_tokens]).to(device)
    idx = torch.from_numpy(bufs["idx_0"]).to(device).long().view(-1)
    x0 = x_tok[idx].view(a.n_experts, cap, a.d_model).contiguous()
    w1 = torch.from_numpy(bufs["W1"]).to(device)
    w2 = torch.from_numpy(bufs["W2"]).to(device)
    del bufs, x_tok
    gen = torch.Generator(device=device)
    gen.manual_seed(0)

    def rand_case(e, c, dff):
        d = a.d_model
        return (torch.randn(e, c, d, device=device, generator=gen),
                torch.randn(e, d, dff, device=device, generator=gen) / d ** 0.5,
                torch.randn(e, dff, d, device=device, generator=gen) / dff ** 0.5)

    cases = [("full", (x0, w1, w2)),
             ("ragged-c1", rand_case(a.n_experts, 1, a.d_ff)),
             ("ragged-c257", rand_case(a.n_experts, 257, a.d_ff)),
             ("ragged-c305", rand_case(a.n_experts, 305, a.d_ff)),
             ("ragged-dff520", rand_case(a.n_experts, cap, 520))]
    rows, failed = [], []
    for label, (x, cw1, cw2) in cases:
        e, c, d = x.shape
        dff = cw1.shape[2]
        got = fk.ffn_batched(x, cw1, cw2)
        again = fk.ffn_batched(x, cw1, cw2)
        want = fk.ffn_batched_plain(x, cw1, cw2)
        ctl = fk.ffn_batched_plain(x, cw1, cw2, approximate="none")
        torch.cuda.synchronize()
        flops, nbytes = fk.ffn_flops(e, c, d, dff), fk.ffn_bytes(e, c, d, dff)
        bound, bound_by = attn_bound(nbytes, flops, bf16=False)
        row = {"phase": "moe_kernels", "case": label, "kernel": "ffn_batched",
               "shape": [e, c, d, dff], "tolerance": fk.FFN_TOL,
               "max_abs_err": float((got - want).abs().max()),
               "within_tol": bool(torch.allclose(got, want, **fk.FFN_TOL)),
               "deterministic": bool(torch.equal(got, again)),
               "finite": bool(torch.isfinite(got).all()),
               "erf_control_max_abs_err": float((ctl - want).abs().max()),
               "erf_control_rejected": not torch.allclose(ctl, want,
                                                           **fk.FFN_TOL),
               "y_max_abs": float(want.abs().max()),
               "flops": flops, "bytes": nbytes,
               "bound_ms": bound, "bound_by": bound_by,
               "bound_simt_ms": flops / PEAK_F32_FLOPS * 1e3}
        del again, ctl
        if label == "full":
            row.update(split_controls(torch, x, cw1, cw2, want, fk.FFN_TOL))
            row["plan"] = ffn_f32.library_plan(e, c, dff)
            row["plan_mismatch"] = ffn_f32.plan_mismatch()
            row["ptxas"] = attn_common.ptxas_report(
                str(kernel_lib.build_info.get("ptxas", "")), "ffn_expert_kernel")
            work = torch.empty(e, c, dff, device=device)
            row.update({
                "ms": timer.ms(lambda: fk.ffn_batched(x, cw1, cw2, out=got,
                                                      work=work)),
                "plain_ms": timer.ms(lambda: fk.ffn_batched_plain(x, cw1, cw2)),
                # no single PyTorch call computes the function: three calls
                "library_calls_ms": timer.ms(lambda: torch.bmm(F.gelu(
                    torch.bmm(x, cw1), approximate="tanh"), cw2)),
                "library_calls": "torch.bmm -> gelu(tanh) -> torch.bmm"})
        emit(row)
        rows.append(row)
        if not (row["within_tol"] and row["deterministic"] and row["finite"]
                and row["erf_control_rejected"]
                and row.get("split_controls_ok", True)
                and not row.get("plan_mismatch")):
            failed.append(label)
        del got, want
    del cases, x0, w1, w2
    torch.cuda.empty_cache()
    if failed:
        raise AssertionError(f"moe kernels phase failed on {failed}")
    return rows


def phase_moe_executor(torch, device):
    """The fixed moe orders through the stream executor at full width:
    kernels vs plain kernels vs the float64 expected Y."""
    from tenzing_tpu_torch.core.platform import Platform
    from tenzing_tpu_torch.models.moe_pipeline import fixed_orders, host_buffer_names
    from tenzing_tpu_torch.runtime.executor import StreamExecutor, buffers_from_numpy
    from tenzing_tpu_torch.verify import ScheduleVerifier

    t0 = time.time()
    a, bufs, cap = moe_full()
    tbufs = buffers_from_numpy(bufs, device, host_buffer_names(a, "choice"))
    del bufs
    want = dense_moe_y(torch, tbufs, a)
    setup_s = time.time() - t0
    plat = Platform.make_n_lanes(2)
    kern = StreamExecutor(plat, tbufs, device="cuda")
    plain = StreamExecutor(plat, tbufs, device="cuda", plain_kernels=True)
    rows, failed = [], []
    for label, (order, graph) in fixed_orders(a, cap).items():
        if not ScheduleVerifier(graph)(order).ok:
            raise AssertionError(f"moe executor phase: {label} is not sound")
        t0 = time.time()
        bf16 = "bf16" in label
        out_k = kern.run(order)
        out_p = plain.run(order)
        tol = BF16_PLAIN_Y_TOL if bf16 else F32_PLAIN_Y_TOL
        ok_plain = all(torch.allclose(out_k[n], out_p[n], **tol)
                       for n in ["Y"] + [f"Y_{c}" for c in range(a.n_chunks)])
        err_plain = float((out_k["Y"] - out_p["Y"]).abs().max())
        y_tol = BF16_Y_TOL if bf16 else F32_Y_TOL
        ok_want, errs = within(out_k["Y"], want, y_tol)
        row = {"phase": "moe_executor", "order": label, "ops": len(order),
               "bf16_staging": bf16, "plain_tolerance": tol,
               "vs_plain_max_abs_err": err_plain, "within_tol_plain": ok_plain,
               "y_tolerance": y_tol,
               "vs_expected": errs, "within_tol_expected": ok_want}
        if bf16:  # the tolerance must reject one expert's tokens dropped
            c_ok, c_errs = within(dropped_expert(tbufs, out_k["Y"], a), want,
                                  y_tol)
            row["dropped_expert_control"] = {"errors": c_errs,
                                             "within_tol": c_ok}
            ok_want = ok_want and not c_ok
        del out_k, out_p
        ptrs = {k: v.data_ptr() for k, v in kern.init_bufs.items()}
        run_n = kern.prepare_n(order)
        run_n(1)
        allocs0 = torch.cuda.memory_stats(device)["allocation.all.allocated"]
        run_n(3)
        allocs = (torch.cuda.memory_stats(device)["allocation.all.allocated"]
                  - allocs0)
        ptrs_ok = ptrs == {k: v.data_ptr() for k, v in kern.init_bufs.items()}
        timed_ok, _ = within(kern.init_bufs["Y"], want, y_tol)
        row.update({"data_ptr_unchanged": ptrs_ok,
                    "allocations_in_3_timed_runs": allocs,
                    "timed_runs_within_tol": timed_ok,
                    "wall_s": round(time.time() - t0, 3)})
        emit(row)
        rows.append(row)
        if not (ok_plain and ok_want and ptrs_ok and allocs == 0 and timed_ok):
            failed.append(label)
    del kern, plain, tbufs
    torch.cuda.empty_cache()
    if failed:
        raise AssertionError(f"moe executor phase failed on {failed}")
    return want, {"setup_s": round(setup_s, 3), "orders": len(rows)}


def phase_moe_driver(torch, device, want_y):
    """The MoE search at full width with climbs; returns the launch counts.
    The result must be verified: the gate holds Y and each Y_c to the
    float64 routed result at the precision each run staged through."""
    from tenzing_tpu_torch.bench import driver

    t0 = time.time()
    req = driver.DriverRequest(workload="moe", mcts_iters=DRIVER_MCTS_ITERS,
                               iters=3, search_iters=2, climb_budget=4)
    reset_launches()
    result = driver.run(req, device="cuda")
    launches = all_launches()
    verdict = result.verdict
    print(result.to_json_line(), flush=True)
    row = {"phase": "moe_driver", "launches": launches,
           "verified": verdict.get("verified"),
           "value": verdict.get("value"),
           "vs_baseline": verdict.get("vs_baseline"),
           "winner_label": verdict.get("winner_label"),
           "climbs": verdict.get("climbs"),
           "perf": capture_perf(verdict),
           "diverged": verdict.get("diverged"),
           "demoted_label": verdict.get("demoted_label"),
           "gate": verdict.get("gate"),
           "wall_s": round(time.time() - t0, 3)}
    emit(row)
    if verdict.get("metric") != "moe_pipe_pct50_searched_t8192":
        raise AssertionError(f"moe driver metric {verdict.get('metric')!r}")
    missing = [k for k in ("ffn_batched", "device_copy") if launches[k] <= 0]
    if missing:
        raise AssertionError(f"the moe path never launched {missing}")
    if not verdict.get("climbs") or verdict["climbs"][0]["spent"] <= 0:
        raise AssertionError(f"the moe climb did not run: {verdict}")
    check_warm_start(verdict, "moe_driver")
    check_no_failures(verdict, "moe driver")
    if verdict.get("verified") is not True or not verdict.get("gate"):
        raise AssertionError(f"moe driver result not verified: {verdict}")
    torch.cuda.empty_cache()
    return launches


def spmv_setup(torch, device, m: int, exchange: str = "host",
               synth: bool = False):
    """(graph, placed buffers, float64 expected y on the card) of the spmv
    iteration at m rows: the driver's graph (``exchange="host"``, kernel
    menu; with ``synth`` the exchange's pipe menu, every instantiation kept)
    or the examples' (``exchange="local"``, no menu)."""
    import numpy as np

    from tenzing_tpu_torch.bench import driver
    from tenzing_tpu_torch.core.graph import Graph
    from tenzing_tpu_torch.models import spmv
    from tenzing_tpu_torch.runtime.executor import buffers_from_numpy

    if exchange == "host":
        # smoke=True only keeps every pipe instantiation (synth_relax)
        g, tbufs, _, _ = driver.build_spmv(
            driver.DriverRequest(workload="spmv", m=m, smoke=synth,
                                 synth_collectives=synth), device)
    else:
        bufs, _ = spmv.make_spmv_buffers(m=m, nnz_per_row=10, seed=0)
        tbufs = buffers_from_numpy(bufs, device)
        g = Graph()
        g.start_then(spmv.SpMVCompound())
        g.then_finish(spmv.SpMVCompound())
    a = spmv.random_band_matrix(m, max(1, m // 8), 10 * m, seed=0)
    x = tbufs["x_local"].cpu().numpy().astype(np.float64)
    rows = np.repeat(np.arange(m), a.row_widths())
    want = np.bincount(rows, weights=a.vals.astype(np.float64) * x[a.cols],
                       minlength=m)
    return g, tbufs, torch.from_numpy(want).to(device)


def y_close(torch, got, want, tol) -> bool:
    return bool(torch.allclose(got.double(), want.double(), **tol))


def phase_spmv_kernels(torch, device, timer):
    """``ell_spmv`` at the main path's shapes and ragged ones: y against the
    float64 product within the rounding bound of the kernel's order, and the
    main slab also against its plain version at ``ELL_TOL``; the
    dropped-column control, two launches bit for bit; the kernel's, the
    plain version's, cuSPARSE's and an empty launch of the kernel's grid's
    (the floor) times beside the bound (bench/ell_spmv.py's inputs and
    checks)."""
    from tenzing_tpu_torch.bench import ell_spmv as eb
    from tenzing_tpu_torch.ops import spmv_kernels as sk

    vals, cols, x, csr = eb.main_slab(torch, device)
    cases = [("m8192-spmv_remote", vals, cols, x)]
    cases += [(f"ragged-m{mm}-w{w}-n{n}" + (f"-off{o}" if o else ""),
               *eb.case_inputs(torch, device, mm, w, n, o)) for mm, w, n, o in
              ((1000, 23, 4093, 0), (37, 5, 300, 0), (64, 1, 50, 0),
               (50, 7, 1, 0), (513, 12, 4096, 0), (9, 40, 128, 0),
               (1001, 22, 4093, 0), (1000, 26, 4093, 26))]
    rows, failed = [], []
    for label, v, c, xx in cases:
        mm, w = v.shape
        nbytes, flops = sk.ell_bytes(mm, w, xx.shape[0]), sk.ell_flops(mm, w)
        bound, bound_by = attn_bound(nbytes, flops, bf16=False)
        row = {"phase": "spmv_kernels", "kernel": "ell_spmv",
               **eb.check_case(torch, None, label, v, c, xx),
               "tolerance": sk.ELL_TOL, "bytes": nbytes, "flops": flops,
               "bound_ms": bound, "bound_by": bound_by}
        main = label.startswith("m8192")
        if main:
            got = torch.empty(mm, device=device)
            lib_y = csr.matmul(xx)
            torch.cuda.synchronize()
            row.update({
                "ms": timer.ms(lambda: sk.ell_spmv(v, c, xx, out=got)),
                "plain_ms": timer.ms(lambda: sk.ell_spmv_plain(v, c, xx)),
                # the library yardstick: cuSPARSE SpMV of the same matrix
                "library_ms": timer.ms(lambda: csr.matmul(xx)),
                "library_call": "torch.sparse_csr_tensor(...).matmul(x) (cuSPARSE)",
                "library_max_abs_err": float(
                    (lib_y - sk.ell_spmv_plain(v, c, xx)).abs().max()),
                # an empty launch of the kernel's grid, and the kernel with
                # its inputs still in L2
                "floor_ms": timer.ms(lambda: sk.ell_floor(mm, device)),
                "warm_ms": eb.warm_ms(torch, lambda: sk.ell_spmv(v, c, xx,
                                                                 out=got))})
            row["above_floor_ms"] = row["ms"] - row["floor_ms"]
        emit(row)
        rows.append(row)
        if not (row["within_f64_bound"] and row["deterministic"]
                and row["finite"] and row["control_rejected"]
                and (row["within_ell_tol"] or not main)):
            failed.append(label)
    torch.cuda.empty_cache()
    if failed:
        raise AssertionError(f"spmv kernels phase failed on {failed}")
    return rows


def phase_spmv_executor(torch, device):
    """The fixed spmv orders through the stream executor at m=8192 and
    m=150000: kernels vs plain kernels vs the float64 product."""
    from tenzing_tpu_torch.core.platform import Platform
    from tenzing_tpu_torch.models.spmv import fixed_orders
    from tenzing_tpu_torch.ops.spmv_kernels import ELL_TOL
    from tenzing_tpu_torch.runtime.executor import StreamExecutor
    from tenzing_tpu_torch.verify import ScheduleVerifier

    rows, failed = [], []
    for m, labels in ((8192, ("naive", "overlap-2l", "pallas-2l")),
                      (150_000, ("naive", "overlap-2l"))):
        g, tbufs, want = spmv_setup(torch, device, m)
        plat = Platform.make_n_lanes(2)
        kern = StreamExecutor(plat, tbufs, device="cuda")
        plain = StreamExecutor(plat, tbufs, device="cuda", plain_kernels=True)
        orders = fixed_orders(g)
        for label in labels:
            order = orders[label]
            if not ScheduleVerifier(g)(order).ok:
                raise AssertionError(f"spmv executor phase: {label} is not sound")
            t0 = time.time()
            out_k, out_p = kern.run(order), plain.run(order)
            ok_plain = all(torch.allclose(out_k[n], out_p[n], **ELL_TOL)
                           for n in ("y", "y_local", "y_remote", "x_remote"))
            ok_want = y_close(torch, out_k["y"], want, ELL_TOL)
            err = float((out_k["y"].double() - want).abs().max())
            del out_k, out_p
            ptrs = {k: v.data_ptr() for k, v in kern.init_bufs.items()}
            run_n = kern.prepare_n(order)
            run_n(1)
            allocs0 = torch.cuda.memory_stats(device)["allocation.all.allocated"]
            run_n(3)
            allocs = (torch.cuda.memory_stats(device)["allocation.all.allocated"]
                      - allocs0)
            ptrs_ok = ptrs == {k: v.data_ptr() for k, v in kern.init_bufs.items()}
            timed_ok = y_close(torch, kern.init_bufs["y"], want, ELL_TOL)
            row = {"phase": "spmv_executor", "m": m, "order": label,
                   "ops": len(order), "kernels": sum(
                       op.name().endswith(".pallas") for op in order.vector()),
                   "tolerance": ELL_TOL, "within_tol_plain": ok_plain,
                   "vs_float64_max_abs_err": err, "within_tol_expected": ok_want,
                   "data_ptr_unchanged": ptrs_ok,
                   "allocations_in_3_timed_runs": allocs,
                   "timed_runs_within_tol": timed_ok,
                   "wall_s": round(time.time() - t0, 3)}
            emit(row)
            rows.append(row)
            if not (ok_plain and ok_want and ptrs_ok and allocs == 0 and timed_ok):
                failed.append(f"m{m}/{label}")
        del kern, plain, tbufs
        torch.cuda.empty_cache()
    if failed:
        raise AssertionError(f"spmv executor phase failed on {failed}")
    return {"orders": len(rows)}


def phase_fused(torch, device, timer):
    """Every tile count on the menu through the ``fused_region`` kernel
    against the plain region and the float64 product, the dropped-column
    control, and each region's times beside its bound."""
    from tenzing_tpu_torch.core.platform import Platform
    from tenzing_tpu_torch.models.spmv import fixed_orders
    from tenzing_tpu_torch.ops import fused_region as fr
    from tenzing_tpu_torch.ops.spmv_kernels import ell_spmv_plain
    from tenzing_tpu_torch.runtime.executor import StreamExecutor
    from tenzing_tpu_torch.runtime.fused import (
        FusedExecutor,
        FusedRegionOp,
        region_bytes,
        partition_regions,
    )
    from tenzing_tpu_torch.solve.local import first_decision_order

    m = 150_000
    rows, failed, timing = [], [], []
    for exchange in ("host", "local"):
        g, tbufs, want = spmv_setup(torch, device, m, exchange)
        plat = Platform.make_n_lanes(2)
        kern = StreamExecutor(plat, tbufs, device="cuda")
        plain = StreamExecutor(plat, tbufs, device="cuda", plain_kernels=True)
        if exchange == "host":
            orders = {k: v for k, v in fixed_orders(g).items() if k != "pallas-2l"}
        else:  # the examples' graph: one five-member region, menu [1]
            orders = {"naive": first_decision_order(g, Platform.make_n_lanes(1))}
        # the control: y with spmv_remote's last slab column dropped
        ctl = (ell_spmv_plain(tbufs["A_rem_vals"][:, :-1].contiguous(),
                              tbufs["A_rem_cols"][:, :-1].contiguous(),
                              tbufs["x_local"][tbufs["send_idx"].long()])
               + ell_spmv_plain(tbufs["A_loc_vals"], tbufs["A_loc_cols"],
                                tbufs["x_local"]))
        for label, seq in orders.items():
            menu = FusedExecutor(kern).plan(seq).tile_menu
            for t in menu:
                t0 = time.time()
                fk_ex = FusedExecutor(kern, tiles=t)
                plan = fk_ex.plan(seq)
                out_k = fk_ex.run(seq)
                again = fk_ex.run(seq)["y"]
                out_p = FusedExecutor(plain, tiles=t).run(seq)
                names = ("y", "y_local", "y_remote", "x_remote", "send_buf")
                errs = {n: float((out_k[n] - out_p[n]).abs().max()) for n in names}
                ok_plain = all(torch.allclose(out_k[n], out_p[n], **fr.REGION_TOL)
                               for n in names)
                ok_want = y_close(torch, out_k["y"], want, fr.REGION_TOL)
                ctl_rejected = not torch.allclose(ctl, out_k["y"], **fr.REGION_TOL)
                row = {"phase": "fused", "exchange": exchange, "order": label,
                       "tiles": t, "menu": menu,
                       "regions": [r.members for r in plan.regions],
                       "region_tiles": [r.tiles for r in plan.regions],
                       "tolerance": fr.REGION_TOL, "vs_plain": errs,
                       "within_tol_plain": ok_plain,
                       "vs_float64_max_abs_err": float(
                           (out_k["y"].double() - want).abs().max()),
                       "within_tol_expected": ok_want,
                       "deterministic": bool(torch.equal(out_k["y"], again)),
                       "control_rejected": ctl_rejected,
                       "wall_s": round(time.time() - t0, 3)}
                del out_k, out_p, again
                emit(row)
                rows.append(row)
                if not (ok_plain and ok_want and ctl_rejected
                        and row["deterministic"] and plan.regions):
                    failed.append(f"{exchange}/{label}/t{t}")
            if exchange == "host" and label != "naive":
                continue
            # each region of the naive order at one tile: kernel, plain
            # region and the stepped members, beside the bytes bound
            fex = FusedExecutor(kern, tiles=1)
            fseq = fex.fused_order(seq)
            kern.precompile(fseq)
            kern.precompile(seq)  # the members' own scratch, for stepping
            segs = [s for k, s in partition_regions(seq.vector(),
                                                    kern.host_names) if k == "region"]
            nbytes = {k: v.numel() * v.element_size()
                      for k, v in kern.init_bufs.items()}
            bufs, ctx = kern.init_bufs, kern.ctx
            for op, region in zip([o for o in fseq if isinstance(o, FusedRegionOp)],
                                  segs):
                k = op.unbound()
                members = region.members
                nb = region_bytes(region, nbytes)
                k.apply(bufs, ctx)  # binds the table
                inst, inst_want = region_instantiation(k.table)
                if inst != inst_want or inst != {"threads": 160,
                                                 "smem_bytes": 98_448}:
                    failed.append(f"{exchange}: SpMV region instantiation {inst}")
                trow = {"phase": "fused_timing", "exchange": exchange,
                        "instantiation": inst,
                        "members": [mm.name() for mm in members], "tiles": 1,
                        "ms": timer.ms(lambda: k.apply(bufs, ctx)),
                        "plain_ms": timer.ms(
                            lambda: fr.region_plain(k.bodies(), bufs, 1)),
                        "stepped_ms": timer.ms(
                            lambda: [mm.apply(bufs, ctx) for mm in members]),
                        "bytes": nb, "bound_ms": bound_ms(nb), "bound_by": "bytes"}
                trow["vs_bound"] = trow["ms"] / trow["bound_ms"]
                emit(trow)
                timing.append(trow)
        del kern, plain, tbufs, ctl
        torch.cuda.empty_cache()
    # the SpMV instantiation is not to slow down beside its recorded time
    host_ms = sum(r["ms"] for r in timing if r["exchange"] == "host")
    vs = {"phase": "fused_timing_vs_recorded", "exchange": "host",
          "ms": host_ms, "recorded_ms": SPMV_REGION_RECORDED_MS,
          "ratio": host_ms / SPMV_REGION_RECORDED_MS,
          "limit": 1 + SPMV_REGION_SLACK}
    vs["within_limit"] = vs["ratio"] <= vs["limit"]
    emit(vs)
    if not vs["within_limit"]:
        failed.append(f"SpMV regions {host_ms:.4f} ms, more than "
                      f"{SPMV_REGION_SLACK:.0%} above {SPMV_REGION_RECORDED_MS}")
    if failed:
        raise AssertionError(f"fused phase failed on {failed}")
    return rows, timing


def phase_fused_sweep(torch, device, timer):
    """Every structurally valid tile count of the spmv naive order's regions
    at m=150000 and m=8192: each region's kernel time
    beside its tile's share of the tiled traffic and its time at one tile,
    and the fused order against the same order with plain regions.  The
    pruning floor ``bench/roofline.MIN_TILE_BYTES`` is read from these rows."""
    from tenzing_tpu_torch.core.platform import Platform
    from tenzing_tpu_torch.models.spmv import fixed_orders
    from tenzing_tpu_torch.ops import fused_region as fr
    from tenzing_tpu_torch.runtime.executor import StreamExecutor
    from tenzing_tpu_torch.runtime.fused import (
        FusedExecutor,
        FusedRegionOp,
        partition_regions,
        region_bytes,
        region_full_bytes,
        region_tile_counts,
    )

    rows, failed = [], []
    for m in (150_000, 8192):
        g, tbufs, want = spmv_setup(torch, device, m)
        plat = Platform.make_n_lanes(2)
        kern = StreamExecutor(plat, tbufs, device="cuda")
        plain = StreamExecutor(plat, tbufs, device="cuda", plain_kernels=True)
        seq = fixed_orders(g)["naive"]
        shapes = {k: tuple(v.shape) for k, v in kern.init_bufs.items()}
        nbytes = {k: v.numel() * v.element_size() for k, v in kern.init_bufs.items()}
        regions = [s for k, s in partition_regions(seq.vector(), kern.host_names)
                   if k == "region"]
        counts = sorted({t for r in regions for t in region_tile_counts(r, shapes)})
        at_one, seen = {}, set()
        for t in counts:
            fex = FusedExecutor(kern, tiles=t)
            plan = fex.plan(seq)
            out_k = fex.run(seq)
            out_p = FusedExecutor(plain, tiles=t).run(seq)
            ok = all(torch.allclose(out_k[n], out_p[n], **fr.REGION_TOL)
                     for n in ("y", "y_local", "y_remote", "x_remote", "send_buf"))
            ok = ok and y_close(torch, out_k["y"], want, fr.REGION_TOL)
            del out_k, out_p
            ops = [o for o in plan.fused_order if isinstance(o, FusedRegionOp)]
            for k, (op, region, info) in enumerate(zip(ops, regions, plan.regions)):
                if (k, info.tiles) in seen:  # a region whose menu stops short
                    continue
                seen.add((k, info.tiles))
                ker = op.unbound()
                tiled = region_bytes(region, nbytes) - region_full_bytes(region, nbytes)
                ms = timer.ms(lambda: ker.apply(kern.init_bufs, kern.ctx))
                at_one.setdefault(k, ms)
                row = {"phase": "fused_sweep", "m": m, "region": k,
                       "members": info.members, "tiles": info.tiles,
                       "valid_tiles": info.valid_tiles,
                       "tile_tiled_bytes": tiled / info.tiles,
                       "blocks_per_group": ker.table.blocks_per_group,
                       "ms": ms, "vs_one_tile": ms / at_one[k],
                       "within_tol": ok}
                emit(row)
                rows.append(row)
            if not ok:
                failed.append(f"m{m}/t{t}")
        del kern, plain, tbufs
        torch.cuda.empty_cache()
    if failed:
        raise AssertionError(f"fused sweep failed on {failed}")
    return rows


def phase_spmv_driver(torch, device):
    """The spmv search at m=150000 with the fused regions, then at m=8192;
    returns the launch counts of each run."""
    from tenzing_tpu_torch.bench import driver

    runs = {}
    for m, flags in ((150_000, dict(fuse_winner=True, fuse_search_tiles=True,
                                    search_workers=2, measure_batch=4,
                                    climb_budget=8)),
                     (8192, {})):
        t0 = time.time()
        req = driver.DriverRequest(workload="spmv", m=m,
                                   mcts_iters=DRIVER_MCTS_ITERS, iters=3,
                                   search_iters=2, **flags)
        reset_launches()
        result = driver.run(req, device="cuda")
        launches = all_launches()
        verdict = result.verdict
        print(result.to_json_line(), flush=True)
        fused = verdict.get("perf", {}).get("fused")
        row = {"phase": "spmv_driver", "m": m, "launches": launches,
               "verified": verdict.get("verified"),
               "winner_label": verdict.get("winner_label"),
               "vs_baseline": verdict.get("vs_baseline"),
               "fused": fused, "fuse_search_tiles": verdict.get(
                   "perf", {}).get("fuse_search_tiles"),
               "wall_s": round(time.time() - t0, 3)}
        dist = verdict.get("perf", {}).get("distributed")
        if flags:
            row["distributed"] = dist
            row["card"] = nvidia_smi()
        emit(row)
        if verdict.get("metric") != f"spmv_iter_pct50_searched_m{m}":
            raise AssertionError(f"spmv driver metric {verdict.get('metric')!r}")
        if flags:
            check_fleet(dist)
        check_no_failures(verdict, f"spmv driver m={m}")
        if verdict.get("verified") is not True:
            raise AssertionError(f"spmv driver result not verified: {verdict}")
        if flags:
            if not fused or fused["verified"] is not True or fused["regions"] < 1:
                raise AssertionError(f"the fused spmv program failed: {fused}")
            measured = [fused.get(k, {}).get(w) for k in (
                "dispatch_overhead_us", "sum_of_parts_us")
                for w in ("before", "after")]
            if not all(isinstance(v, float) and v >= 0 for v in measured) \
                    or fused["sum_of_parts_us"]["before"] <= 0:
                raise AssertionError(f"perf.fused lacks its measured "
                                     f"attribution fields: {fused}")
            if launches["fused_region"] <= 0:
                raise AssertionError("the fused spmv path never launched fused_region")
        elif launches["ell_spmv"] <= 0:
            raise AssertionError("the m=8192 spmv path never launched ell_spmv")
        runs[m] = launches
        torch.cuda.empty_cache()
    return runs


def check_fleet(dist) -> None:
    """The spmv driver's search fleet: two workers, every job done, fused
    rounds that fit the workers' heartbeat limit, no worker on the card."""
    if not dist:
        raise AssertionError("the spmv driver ran no search fleet")
    problems = []
    if dist["workers"] != 2 or dist["failed_jobs"] != 0 or dist["rounds"] < 1:
        problems.append("workers, failed jobs or rounds")
    if not 0 < (dist["batch_occupancy"] or 0) <= 1:
        problems.append("batch occupancy")
    if dist["candidates"] != sum(dist["job_candidates"]) or \
            not all(n > 0 for n in dist["job_candidates"]):
        problems.append("candidates against the jobs' sims")
    if dist["worker_restarts"] != 0:
        problems.append("worker restarts")
    if dist["worker_cuda_initialized"] != {"0": False, "1": False}:
        problems.append("a worker with a CUDA context (or no exit report)")
    if not dist["longest_round_s"] < 60.0:
        problems.append("a round past the workers' heartbeat limit")
    if problems:
        raise AssertionError(f"the search fleet failed ({problems}): {dist}")


def phase_attn_fused(torch, device, timer, want_o):
    """The attention members of ``fused_region`` at full width: the naive
    ``.xla`` order, a 2-lane order and the naive order with every fold chunked
    2 and 4 ways, at every tile count of their menus, against the plain
    region (the state at ``F32_STATE_TOL``, O beside it) and the dense
    expected O; two launches bitwise equal; a fold member whose key offset is
    one block off must be rejected.  Times each region of the naive order
    (every tile count) and of the chunked orders (one tile) beside the
    stepped members, the plain region and the operations bound."""
    import dataclasses

    from tenzing_tpu_torch.bench.driver import attn_graph
    from tenzing_tpu_torch.core.platform import Platform
    from tenzing_tpu_torch.models.ring_attention import (
        fixed_order,
        make_blocked_buffers,
    )
    from tenzing_tpu_torch.ops import attention_kernels as ak
    from tenzing_tpu_torch.ops import fused_region as fr
    from tenzing_tpu_torch.runtime.executor import StreamExecutor, buffers_from_numpy
    from tenzing_tpu_torch.runtime.fused import FusedExecutor, FusedRegionOp
    from tenzing_tpu_torch.verify import ScheduleVerifier

    a = attn_full_args()
    bufs, _ = make_blocked_buffers(a, seed=0, with_expected=False)
    tbufs = buffers_from_numpy(bufs, device)
    del bufs
    names = ("acc", "m_run", "l_run")
    one, two = Platform.make_n_lanes(1), Platform.make_n_lanes(2)
    kern = StreamExecutor(two, tbufs, device="cuda")
    plain = StreamExecutor(two, tbufs, device="cuda", plain_kernels=True)
    g, gc = attn_graph(a), attn_graph(a, chunk=True, chunk_relax=True)
    orders = {
        "naive": (fixed_order(g, one), g),
        "2-lane": (fixed_order(g, two, lane_of=lambda s: s // 4), g),
        "naive-c2": (fixed_order(gc, one, kernel_of=lambda s: ".xla.chunked.c2"), gc),
        "naive-c4": (fixed_order(gc, one, kernel_of=lambda s: ".xla.chunked.c4"), gc),
    }
    rows, timing, failed = [], [], []
    for label, (seq, graph) in orders.items():
        if not ScheduleVerifier(graph)(seq).ok:
            raise AssertionError(f"attn fused phase: {label} is not sound")
        menu = FusedExecutor(kern).plan(seq).tile_menu
        for t in menu:
            t0 = time.time()
            fex = FusedExecutor(kern, tiles=t)
            plan = fex.plan(seq)
            out_k = fex.run(seq)
            again = fex.run(seq)
            out_p = FusedExecutor(plain, tiles=t).run(seq)
            ok_plain, errs = ak.state_check([out_k[n] for n in names],
                                            [out_p[n] for n in names],
                                            ak.F32_STATE_TOL)
            err_o = float((out_k["O"] - out_p["O"]).abs().max())
            ok_plain = ok_plain and torch.allclose(out_k["O"], out_p["O"],
                                                   **ak.F32_STATE_TOL["acc/l"])
            ok_want = torch.allclose(out_k["O"], want_o, **F32_O_TOL)
            same = all(torch.equal(out_k[n], again[n]) for n in names + ("O",))
            row = {"phase": "attn_fused", "order": label, "tiles": t,
                   "menu": menu, "regions": [r.members for r in plan.regions],
                   "region_tiles": [r.tiles for r in plan.regions],
                   "tolerance": ak.F32_STATE_TOL, "vs_plain": errs,
                   "o_vs_plain_max_abs_err": err_o, "within_tol_plain": ok_plain,
                   "o_vs_expected_max_abs_err": float(
                       (out_k["O"] - want_o).abs().max()),
                   "within_tol_expected": ok_want, "deterministic": same}
            if label == "naive" and t == 1:
                # the control: the first fold reads the next block's keys
                k = next(o for o in plan.fused_order
                         if isinstance(o, FusedRegionOp)).unbound()
                span = a.n_devices * a.seq_local
                bad = [dataclasses.replace(b, key_off=(b.key_off + a.seq_local) % span)
                       if i == 0 else b for i, b in enumerate(k.bodies())]
                cbufs = {n: v.clone() for n, v in kern.init_bufs.items()}
                for n in names:
                    cbufs[n].copy_(kern._initial[n])
                fr.fused_region(fr.RegionTable(bad, 1), cbufs,
                                torch.zeros(2, dtype=torch.int32, device=device))
                c_ok, c_errs = ak.state_check([cbufs[n] for n in names],
                                              [out_p[n] for n in names],
                                              ak.F32_STATE_TOL)
                row["key_offset_control"] = {"errors": c_errs, "within_tol": c_ok}
                ok_plain = ok_plain and not c_ok
                del cbufs
            row["wall_s"] = round(time.time() - t0, 3)
            emit(row)
            rows.append(row)
            del out_k, out_p, again
            if not (ok_plain and ok_want and same and plan.regions):
                failed.append(f"{label}/t{t}")
        if label == "2-lane":
            continue
        # each region's kernel beside the plain region and the stepped
        # members: every tile count of the naive order, one tile otherwise
        kern.precompile(seq)  # the members' own scratch, for stepping
        bufs_, ctx = kern.init_bufs, kern.ctx
        for t in (menu if label == "naive" else [1]):
            fex = FusedExecutor(kern, tiles=t)
            fseq = fex.fused_order(seq)
            kern.precompile(fseq)
            regs = [o for o in fseq if isinstance(o, FusedRegionOp)]
            for op, info in zip(regs, fex.plan(seq).regions):
                k = op.unbound()
                members = k._members
                ms = timer.ms(lambda: k.apply(bufs_, ctx))  # binds the table
                inst, inst_want = region_instantiation(k.table)
                trow = {"phase": "attn_fused_timing", "order": label,
                        "members": info.members, "tiles": t,
                        "blocks_per_group": k.table.blocks_per_group, "ms": ms,
                        "instantiation": inst}
                if inst != inst_want:
                    failed.append(f"{label}/t{t}: instantiation {inst}, "
                                  f"want {inst_want}")
                if t == 1:
                    trow["plain_ms"] = timer.ms(
                        lambda: fr.region_plain(k.bodies(), bufs_, 1))
                    trow["stepped_ms"] = timer.ms(
                        lambda: [mm.apply(bufs_, ctx) for mm in members])
                keys = sum(b.nkv for b in k.bodies() if b.body == "attn_fold")
                ops = 4.0 * a.batch * a.n_devices * a.seq_local * keys * a.head_dim
                trow["bound_ms"] = TF32_SPLIT * ops / PEAK_TF32_FLOPS * 1e3
                trow["bound_by"] = "operations"
                trow["bound_simt_ms"] = ops / PEAK_F32_FLOPS * 1e3
                trow["tflops"] = ops / (ms * 1e-3) / 1e12
                emit(trow)
                timing.append(trow)
    # the library yardstick: one f32 scaled_dot_product_attention call over
    # (batch, 1 head, n, d) views, as the attn kernels phase times it
    import torch.nn.functional as F

    q, kk, v = (kern.init_bufs[n].unsqueeze(1) for n in ("Q", "K", "V"))
    sdpa_ms = timer.ms(lambda: F.scaled_dot_product_attention(q, kk, v))
    emit({"phase": "attn_fused_library", "sdpa_f32_ms": sdpa_ms})
    del kern, plain, tbufs, q, kk, v
    torch.cuda.empty_cache()
    if failed:
        raise AssertionError(f"attn fused phase failed on {failed}")
    return rows, timing, sdpa_ms


def phase_attn_fused_driver(torch, device):
    """``--workload attn --fuse-winner --fuse-search-tiles`` at full width
    with the cut budget; returns the launch counts."""
    from tenzing_tpu_torch.bench import driver

    t0 = time.time()
    req = driver.DriverRequest(workload="attn", fuse_winner=True,
                               fuse_search_tiles=True,
                               mcts_iters=DRIVER_MCTS_ITERS, iters=3,
                               search_iters=2)
    reset_launches()
    result = driver.run(req, device="cuda")
    launches = all_launches()
    verdict = result.verdict
    print(result.to_json_line(), flush=True)
    perf = verdict.get("perf", {})
    row = {"phase": "attn_fused_driver", "launches": launches,
           "verified": verdict.get("verified"), "diverged": verdict.get("diverged"),
           "winner_label": verdict.get("winner_label"),
           "vs_baseline": verdict.get("vs_baseline"),
           "fused": perf.get("fused"),
           "fuse_search_tiles": perf.get("fuse_search_tiles"),
           "wall_s": round(time.time() - t0, 3)}
    emit(row)
    if verdict.get("metric") != "attn_blockwise_pct50_searched_n8192":
        raise AssertionError(f"attn fused driver metric {verdict.get('metric')!r}")
    fused, tiles = perf.get("fused"), perf.get("fuse_search_tiles")
    if not fused or not tiles or not tiles.get("planted"):
        raise AssertionError(f"attn fused driver: no perf.fused / planted "
                             f"tile menu: {perf}")
    # the reference's gate may report the fused program as diverged (the
    # fused fold sums in another order); the members' own tolerance raised
    # inside the run if the kernel were wrong
    if fused.get("verified") is not True and not fused.get("diverged"):
        raise AssertionError(f"attn fused driver: fused block not verified "
                             f"and no divergence reported: {fused}")
    check_no_failures(verdict, "attn fused driver")
    if verdict.get("verified") is not True or not verdict.get("gate"):
        raise AssertionError(f"attn fused driver not verified: {verdict}")
    if launches["fused_region"] <= 0:
        raise AssertionError("the fused attn path never launched fused_region")
    torch.cuda.empty_cache()
    return launches


def drive_to(g, plat, picks):
    """A complete schedule of ``g`` on ``plat`` taking, at every choice, the
    alternative whose name ends with ``picks(op_name)`` (None: the first
    offered), every other decision the phase policy's."""
    from tenzing_tpu_torch.models.moe_pipeline import PHASES
    from tenzing_tpu_torch.solve.local import drive, phase_policy

    def prefer(op_name, choices):
        want = picks(op_name)
        return next((c for c in choices if want and c.endswith(want)), None)

    return drive(g, plat, phase_policy(plat, PHASES, prefer))[0]


def phase_chunk(torch, device, timer, want_o, want_y):
    """The chunked orders at full width against the unchunked ones at every
    structurally valid count: attention's naive order with every fold split
    into sub-folds (``F32_STATE_TOL``), the moe greedy orders with every
    expert MLP split into expert partials, f32 and bf16 staging (one f32 /
    bf16 ulp from the unchunked Y; Y against the float64 expected).  Then the
    full-size pruned menus, and the two card constants of
    ``bench/roofline.py`` measured: the stream executor's per-op host
    dispatch and the pinned host <-> device copy rate."""
    from tenzing_tpu_torch.bench import roofline
    from tenzing_tpu_torch.bench.driver import attn_graph
    from tenzing_tpu_torch.core.chunking import chunks_of
    from tenzing_tpu_torch.core.operation import Finish, Start
    from tenzing_tpu_torch.core.platform import Platform
    from tenzing_tpu_torch.core.sequence import Sequence
    from tenzing_tpu_torch.models.moe_pipeline import (
        build_graph,
        ffn_chunk_menu,
        host_buffer_names,
    )
    from tenzing_tpu_torch.models.ring_attention import (
        fixed_order,
        fold_chunk_menu,
        make_blocked_buffers,
    )
    from tenzing_tpu_torch.models.spmv import VectorAdd
    from tenzing_tpu_torch.ops import attention_kernels as ak
    from tenzing_tpu_torch.runtime.executor import StreamExecutor, buffers_from_numpy
    from tenzing_tpu_torch.verify import ScheduleVerifier

    rows, failed = [], []
    a = attn_full_args()
    bufs, _ = make_blocked_buffers(a, seed=0, with_expected=False)
    tbufs = buffers_from_numpy(bufs, device)
    del bufs
    one = Platform.make_n_lanes(1)
    ex = StreamExecutor(one, tbufs, device="cuda")
    gc = attn_graph(a, chunk=True, chunk_relax=True)
    names = ("acc", "m_run", "l_run")
    base = ex.run(fixed_order(gc, one))
    for n in [c for c in fold_chunk_menu(a, relax=True)[0] if c > 1]:
        seq = fixed_order(gc, one, kernel_of=lambda s: f".xla.chunked.c{n}")
        out = ex.run(seq)
        ok, errs = ak.state_check([out[x] for x in names], [base[x] for x in names],
                                  ak.F32_STATE_TOL)
        ok = ok and torch.allclose(out["O"], base["O"], **ak.F32_STATE_TOL["acc/l"])
        ok_want = torch.allclose(out["O"], want_o, **F32_O_TOL)
        verified = ScheduleVerifier(gc)(seq).ok
        row = {"phase": "chunk", "workload": "attn", "chunks": n,
               "chosen": sorted(set(chunks_of(seq.vector()).values())),
               "vs_unchunked": errs, "within_tol": ok,
               "o_vs_expected_max_abs_err": float((out["O"] - want_o).abs().max()),
               "within_tol_expected": ok_want, "verified": verified}
        emit(row)
        rows.append(row)
        if not (ok and ok_want and verified):
            failed.append(f"attn/c{n}")
        del out
    del ex, tbufs, base
    torch.cuda.empty_cache()

    m, mbufs, cap = moe_full()
    tb = buffers_from_numpy(mbufs, device, host_buffer_names(m, "choice"))
    del mbufs
    two = Platform.make_n_lanes(2)
    ex = StreamExecutor(two, tb, device="cuda")
    gm = build_graph(m, cap, impl_choice=True, staging="choice", chunk=True,
                     chunk_relax=True)
    counts = [c for c in ffn_chunk_menu(m, cap, relax=True)[0] if c > 1]
    for staging in ("f32", "bf16"):
        bf16 = staging == "bf16"
        chain = f".{staging}-host"

        def picks(op, n=None):
            if op.startswith("chain_"):
                return chain
            return ".xla" if n is None else f".xla.chunked.c{n}"

        y0 = ex.run(drive_to(gm, two, picks))["Y"]
        for n in counts:
            seq = drive_to(gm, two, lambda op: picks(op, n))
            y = ex.run(seq)["Y"]
            tol = BF16_PLAIN_Y_TOL if bf16 else F32_PLAIN_Y_TOL
            ok = torch.allclose(y, y0, **tol)
            ok_want, errs = within(y, want_y, BF16_Y_TOL if bf16 else F32_Y_TOL)
            verified = ScheduleVerifier(gm)(seq).ok
            row = {"phase": "chunk", "workload": "moe", "staging": staging,
                   "chunks": n,
                   "chosen": sorted(set(chunks_of(seq.vector()).values())),
                   "tolerance": tol,
                   "vs_unchunked_max_abs_err": float((y - y0).abs().max()),
                   "within_tol": ok, "vs_expected": errs,
                   "within_tol_expected": ok_want, "verified": verified}
            emit(row)
            rows.append(row)
            if not (ok and ok_want and verified and row["chosen"] == [n]):
                failed.append(f"moe/{staging}/c{n}")
    del ex, tb
    torch.cuda.empty_cache()

    # the card's constants: one more op's host time on the stream executor
    # (a one-lane chain of 200 small adds, run 20 times), and the pinned copy
    # rate of one moe slot table, both directions
    k_ops, reps = 200, 20
    vec = {n: torch.rand(4096, device=device) for n in ("a", "b", "o")}
    lane = one.lanes[0]
    chain_seq = Sequence([Start()] + [VectorAdd(f"add{i}", "a", "b", "o").bind(lane)
                                      for i in range(k_ops)] + [Finish()])
    dex = StreamExecutor(one, vec, device="cuda")
    run_n = dex.prepare_n(chain_seq)
    run_n(2)
    per_op = []
    for _ in range(5):
        t0 = time.perf_counter()
        run_n(reps)
        per_op.append((time.perf_counter() - t0) / (reps * k_ops) * 1e6)
    per_op.sort()
    dispatch_us = per_op[len(per_op) // 2]
    table = m.n_experts * cap * m.d_model * 4
    host = torch.empty(table // 4, pin_memory=True)
    dbuf = torch.empty(table // 4, device=device)
    h2d = timer.ms(lambda: dbuf.copy_(host, non_blocking=True))
    d2h = timer.ms(lambda: host.copy_(dbuf, non_blocking=True))
    rate_gbs = (table / (h2d * 1e-3) + table / (d2h * 1e-3)) / 2 / 1e9
    menus = {"attn": fold_chunk_menu(a), "moe": ffn_chunk_menu(m, cap)}
    const = {"phase": "chunk_constants",
             "dispatch_us_measured": dispatch_us,
             "dispatch_us_samples": per_op,
             "CHUNK_DISPATCH_US": roofline.CHUNK_DISPATCH_US,
             "slot_table_bytes": table, "h2d_ms": h2d, "d2h_ms": d2h,
             "xfer_gbs_measured": rate_gbs, "XFER_GBS": roofline.XFER_GBS,
             "full_size_menus": {k: {"counts": v[0], "est_hidden_us": v[1]}
                                 for k, v in menus.items()}}
    emit(const)
    del vec, dex, host, dbuf
    if failed:
        raise AssertionError(f"chunk phase failed on {failed}")
    return rows, const


def phase_chunk_driver(torch, device):
    """``--chunk`` on attn and moe at full width with the cut budget: the
    ``perf.chunked`` block, verified or demoted as the plain runs may be;
    returns the launch counts of each run."""
    from tenzing_tpu_torch.bench import driver

    runs = {}
    for workload in ("attn", "moe"):
        t0 = time.time()
        extra = dict(climb_budget=4) if workload == "moe" else {}
        req = driver.DriverRequest(workload=workload, chunk=True,
                                   mcts_iters=DRIVER_MCTS_ITERS,
                                   iters=3, search_iters=2, **extra)
        reset_launches()
        result = driver.run(req, device="cuda")
        launches = all_launches()
        verdict = result.verdict
        print(result.to_json_line(), flush=True)
        chunked = verdict.get("perf", {}).get("chunked")
        row = {"phase": "chunk_driver", "workload": workload,
               "launches": launches, "verified": verdict.get("verified"),
               "diverged": verdict.get("diverged"),
               "winner_label": verdict.get("winner_label"),
               "vs_baseline": verdict.get("vs_baseline"), "chunked": chunked,
               "wall_s": round(time.time() - t0, 3)}
        emit(row)
        if not chunked or "menus" not in chunked or not chunked["menus"]:
            raise AssertionError(f"{workload} --chunk: no perf.chunked menus: {chunked}")
        hidden = chunked["hidden_comm_us"].get("measured")
        if not isinstance(hidden, float) or hidden < 0:
            raise AssertionError(f"{workload} --chunk: perf.chunked lacks the "
                                 f"measured hidden comm: {chunked}")
        check_no_failures(verdict, f"{workload} --chunk driver")
        if verdict.get("verified") is not True or not verdict.get("gate"):
            raise AssertionError(f"{workload} --chunk not verified: {verdict}")
        runs[workload] = launches
        torch.cuda.empty_cache()
    return runs


def _host_sync_row(torch, exs, workload, label, order, out_name):
    """One order with every EventSync blocking the host and with the host
    syncs deferred (runtime/executor.py): the outputs bit for bit, and in
    turns (blocking, deferred, deferred, blocking) each one's wall and
    breakdown.py's idle share per iteration and the host blocks it
    executed."""
    from tenzing_tpu_torch.bench.breakdown import measure

    outs = {mode: ex.run(order)[out_name] for mode, ex in exs.items()}
    equal = bool(torch.equal(outs["blocking"], outs["deferred"]))
    del outs
    runs = {}
    for mode in ("blocking", "deferred", "deferred", "blocking"):
        runs.setdefault(mode, []).append(measure(exs[mode], order,
                                                 iters=HOST_SYNC_ITERS))
    row = {"phase": "host_syncs", "workload": workload, "order": label,
           "ops": len(order), "out": out_name, "bit_equal": equal}
    for mode, ms in runs.items():
        row[mode] = {"wall_us": [m["wall_us"] for m in ms],
                     "idle_share": [m["idle_share"] for m in ms],
                     "host_syncs_per_iter": [m["host_syncs_per_iter"]
                                             for m in ms]}
    emit(row)
    return row


def phase_host_syncs(torch, device):
    """The chunk directive's host wait, blocking and deferred: the moe
    pipeline's chunked orders (every expert MLP on .xla, unchunked and
    chunked 2 and 4 ways, f32 chains on the host and on the device copy, 2
    lanes) and attention's naive order with every fold unchunked and
    chunked 2 and 4 ways (1 lane), each run with every EventSync blocking
    and with the host syncs deferred.  The outputs must be bit-equal; the
    chunked attention orders must execute fewer host blocks deferred (an
    EventSync precedes each chunked block but the first); the moe orders
    the same number (their directive follows the dispatch await, a host
    op)."""
    from tenzing_tpu_torch.bench.driver import attn_graph
    from tenzing_tpu_torch.core.platform import Platform
    from tenzing_tpu_torch.models.moe_pipeline import chunked_orders, host_buffer_names
    from tenzing_tpu_torch.models.ring_attention import fixed_order, make_blocked_buffers
    from tenzing_tpu_torch.runtime.executor import StreamExecutor, buffers_from_numpy

    def executors(plat, bufs):
        return {mode: StreamExecutor(plat, bufs, device="cuda",
                                     defer_host_syncs=mode == "deferred")
                for mode in ("blocking", "deferred")}

    rows, failed = [], []
    m, mbufs, cap = moe_full()
    tb = buffers_from_numpy(mbufs, device, host_buffer_names(m, "choice"))
    del mbufs
    exs = executors(Platform.make_n_lanes(2), tb)
    for chain in (".f32-host", ".f32-rdma"):
        orders, _ = chunked_orders(m, cap, chain=chain)
        for label, order in orders.items():
            row = _host_sync_row(torch, exs, "moe", f"{chain[1:]}/{label}", order,
                             "Y")
            rows.append(row)
            if not (row["bit_equal"] and row["deferred"]["host_syncs_per_iter"]
                    == row["blocking"]["host_syncs_per_iter"]):
                failed.append(row["order"])
    del exs, tb
    torch.cuda.empty_cache()

    a = attn_full_args()
    bufs, _ = make_blocked_buffers(a, seed=0, with_expected=False)
    tb = buffers_from_numpy(bufs, device)
    del bufs
    one = Platform.make_n_lanes(1)
    exs = executors(one, tb)
    gc = attn_graph(a, chunk=True, chunk_relax=True)
    for n in (1, 2, 4):
        order = (fixed_order(gc, one) if n == 1 else
                 fixed_order(gc, one, kernel_of=lambda s, n=n: f".xla.chunked.c{n}"))
        row = _host_sync_row(torch, exs, "attn", f"naive/c{n}", order, "O")
        rows.append(row)
        fewer = (row["deferred"]["host_syncs_per_iter"][0]
                 < row["blocking"]["host_syncs_per_iter"][0])
        if not (row["bit_equal"] and (fewer if n > 1 else True)):
            failed.append(f"attn/c{n}")
    del exs, tb
    torch.cuda.empty_cache()
    if failed:
        raise AssertionError(f"host_syncs phase failed on {failed}")
    return rows


def phase_moe_layer_kernels(torch, device, timer):
    """``ffn_rows`` at the layer's chunk shape (chunk 0's received slot
    table at world size 1: n = 2048, d 512, d_ff 2048) and at ragged n
    (2047, 37) against its plain version at ``FFN_TOL``; the erf gelu control
    must be rejected and two launches must give the same bits; the kernel's,
    the plain version's and the ``matmul -> gelu -> matmul`` three-call times
    beside the bound."""
    import numpy as np
    import torch.nn.functional as F

    from tenzing_tpu_torch.models.moe import MoEArgs, make_moe_buffers
    from tenzing_tpu_torch.ops import ffn_kernels as fk

    a = MoEArgs(**MOE_LAYER)
    bufs, _, _ = make_moe_buffers(a, seed=0)
    idx = torch.from_numpy(bufs["disp_idx_0"][0].reshape(-1)).long()
    x0 = torch.from_numpy(bufs["X"][:a.chunk_tokens])[idx].contiguous().to(device)
    w1 = torch.from_numpy(bufs["W1"][0].astype(np.float32)).to(device)
    w2 = torch.from_numpy(bufs["W2"][0].astype(np.float32)).to(device)
    del bufs
    gen = torch.Generator(device=device)
    gen.manual_seed(1)

    def rand_case(n):
        return torch.randn(n, a.d_model, device=device, generator=gen), w1, w2

    def bf16(case):
        return tuple(t.to(torch.bfloat16) for t in case)

    def dff_case(n, dff):
        return (torch.randn(n, a.d_model, device=device, generator=gen),
                torch.randn(a.d_model, dff, device=device, generator=gen)
                / a.d_model ** 0.5,
                torch.randn(dff, a.d_model, device=device, generator=gen)
                / dff ** 0.5)

    cases = [("chunk", (x0, w1, w2)), ("ragged-n2047", rand_case(2047)),
             ("ragged-n37", rand_case(37)), ("chunk-bf16", bf16((x0, w1, w2))),
             ("ragged-n2047-bf16", bf16(rand_case(2047))),
             ("ragged-n37-bf16", bf16(rand_case(37))),
             ("ragged-n1-bf16", bf16(rand_case(1))),
             ("ragged-dff2040-bf16", bf16(dff_case(2048, 2040))),
             ("ragged-dff8-bf16", bf16(dff_case(300, 8)))]
    rows, failed = [], []
    for label, (x, cw1, cw2) in cases:
        n, d = x.shape
        dff = cw1.shape[1]
        is16 = x.dtype == torch.bfloat16
        tol = fk.FFN_BF16_TOL if is16 else fk.FFN_TOL
        got = fk.ffn_rows(x, cw1, cw2)
        again = fk.ffn_rows(x, cw1, cw2)
        want = fk.ffn_rows_plain(x, cw1, cw2)
        if is16:
            # a skipped hidden tile: W1's last 64 columns zeroed (the erf
            # gelu moves y by less than a bf16 ulp)
            w1c = cw1.clone()
            w1c[:, -64:] = 0
            ctl = fk.ffn_rows_plain(x, w1c, cw2)
            del w1c
        else:
            ctl = fk.ffn_rows_plain(x, cw1, cw2, approximate="none")
        torch.cuda.synchronize()
        flops = fk.ffn_flops(1, n, d, dff)
        nbytes = fk.ffn_bytes(1, n, d, dff, itemsize=x.element_size())
        bound, bound_by = attn_bound(nbytes, flops, bf16=is16)
        g32, w32 = got.float(), want.float()
        row = {"phase": "moe_layer_kernels", "case": label, "kernel": "ffn_rows",
               "dtype": str(x.dtype).replace("torch.", ""),
               "shape": [n, d, dff], "tolerance": tol,
               "max_abs_err": float((g32 - w32).abs().max()),
               "within_tol": bool(torch.allclose(g32, w32, **tol)),
               "deterministic": bool(torch.equal(got, again)),
               "finite": bool(torch.isfinite(g32).all()),
               "control": "skipped_hidden_tile" if is16 else "erf_gelu",
               "control_max_abs_err": float((ctl.float() - w32).abs().max()),
               "control_rejected": not torch.allclose(ctl.float(), w32,
                                                      **tol),
               "y_max_abs": float(w32.abs().max()),
               "flops": flops, "bytes": nbytes,
               "bound_ms": bound, "bound_by": bound_by}
        if not is16:
            row["bound_simt_ms"] = flops / PEAK_F32_FLOPS * 1e3
        del again, ctl, g32, w32
        if label == "chunk":
            row.update(split_controls(torch, x, cw1, cw2, want, tol))
        if label.startswith("chunk"):
            work = torch.empty(n, dff, dtype=x.dtype, device=device)
            row.update({
                "ms": timer.ms(lambda: fk.ffn_rows(x, cw1, cw2, out=got,
                                                   work=work)),
                "plain_ms": timer.ms(lambda: fk.ffn_rows_plain(x, cw1, cw2)),
                # no single PyTorch call computes the function: three calls
                "library_calls_ms": timer.ms(lambda: torch.matmul(F.gelu(
                    torch.matmul(x, cw1), approximate="tanh"), cw2)),
                "library_calls": "torch.matmul -> gelu(tanh) -> torch.matmul"})
        emit(row)
        rows.append(row)
        if not (row["within_tol"] and row["deterministic"] and row["finite"]
                and row["control_rejected"]
                and row.get("split_controls_ok", True)):
            failed.append(label)
        del got, want
    del cases, x0, w1, w2
    torch.cuda.empty_cache()
    # the bf16 body's SASS: HGMMA in every instantiation, no mma.sync
    # (HMMA), no spills
    from tenzing_tpu_torch.bench import ffn_bf16

    sass = ffn_bf16.hmma_counts(ffn_bf16.KERNELS)
    emit({"phase": "moe_layer_kernels", "case": "bf16_sass", "sass": sass})
    for name, v in sass.items():
        if not v.get("hgmma") or v.get("hmma") or sum(
                v.get("spills", {}).values()):
            failed.append(f"sass {name}")
    next(r for r in rows if r["case"] == "chunk-bf16")["sass"] = {
        k: {"hgmma": v.get("hgmma"), "hmma": v.get("hmma"),
            "spills": sum(v.get("spills", {}).values())}
        for k, v in sass.items()}
    if failed:
        raise AssertionError(f"moe layer kernels phase failed on {failed}")
    return rows


def _drop_expert(torch, y, bufs, a, expert: int = 0):
    """The control: the gathered Y with every token routed to ``expert``
    zeroed, as if that expert's output were dropped."""
    out = y.clone()
    t, tc = a.tokens_per_shard, a.chunk_tokens
    for c in range(a.n_chunks):
        idx, w = bufs[f"disp_idx_{c}"], bufs[f"disp_w_{c}"]
        for s in range(a.n_ep):
            rows = s * t + c * tc + idx[s, expert][w[s, expert] > 0]
            out[torch.from_numpy(rows.astype("int64")).to(out.device)] = 0.0
    return out


@contextlib.contextmanager
def count_calls(module, name: str):
    """Count the calls of ``module.<name>`` made inside the block (a list
    of one count, read after it): the executor's collective posts through
    ``torch.distributed``, so this shows a path went through the process
    group."""
    real, count = getattr(module, name), [0]

    def counted(*args, **kwargs):
        count[0] += 1
        return real(*args, **kwargs)

    setattr(module, name, counted)
    try:
        yield count
    finally:
        setattr(module, name, real)


def phase_moe_layer(torch, device, timer):
    """The expert-parallel MoE layer (models/moe.py) at full width on a
    world-size-1 NCCL group initialised here through a ``file://``
    rendezvous and torn down at the end: the dryrun's agreement protocol
    (parallel/dryrun.py: an all-.xla, an all-.pallas and a mixed schedule,
    Y within ``dryrun.Y_TOL`` of the float64 expected, ``ffn_rows`` launched
    by the .pallas ones), a control with expert 0's output dropped that
    must be rejected, the self all-to-all's time per chunk, and a short
    ``explore`` through ``DistControlPlane``; the agreement and the search
    must post the layer's all-to-alls through the NCCL group
    (``dist.all_to_all_single`` counted).  Returns the launch counts of
    the agreement and the search."""
    import tempfile

    import torch.distributed as dist

    from tenzing_tpu_torch.models.moe import MoEArgs, make_moe_buffers
    from tenzing_tpu_torch.parallel import dryrun
    from tenzing_tpu_torch.parallel.control_plane import DistControlPlane
    from tenzing_tpu_torch.parallel.mesh import close_mesh, control_group, init_mesh

    t0 = time.time()
    a = MoEArgs(**MOE_LAYER)
    torch.cuda.set_device(device)
    with tempfile.TemporaryDirectory(prefix="tz_moe_layer_") as d:
        mesh = init_mesh("ep", "nccl", "file://" + os.path.join(d, "rv"), 0, 1)
        try:
            cp = DistControlPlane(control_group())
            layer = dryrun.build_layer(mesh, device, a, seed=0,
                                       impl_choice=True)
            setup_s = time.time() - t0
            reset_launches()
            with count_calls(dist, "all_to_all_single") as a2a_calls:
                rows, orders = dryrun.agree_schedules(layer, cp)
                search = dryrun.explore_layer(layer, cp, MOE_LAYER_ITERS)
            launches = all_launches()
            for r in rows:
                emit({"phase": "moe_layer", "y_tolerance": dryrun.Y_TOL, **r})
            pallas = next(o for o, r in zip(orders, rows)
                          if set(r["ffn_slots"]) == {".pallas"})
            y = dryrun.run_gathered(layer, pallas)
            bufs, _, _ = make_moe_buffers(a, seed=0)
            ctl = _drop_expert(torch, y, bufs, a)
            del bufs
            ctl_ok = bool(torch.allclose(ctl, layer.want, **dryrun.Y_TOL))
            # the exchange of one chunk's slot table, as the layer posts it,
            # beside a plain device copy of the same bytes
            ex_bufs = layer.executor.init_bufs
            src, dst = ex_bufs["send_disp_0"], ex_bufs["recv_disp_0"]
            group = mesh.group("ep")
            a2a_ms = timer.ms(lambda: dist.all_to_all_single(dst, src,
                                                             group=group))
            copy_ms = timer.ms(lambda: dst.copy_(src))
            nbytes = 2 * src.numel() * src.element_size()
            row = {"phase": "moe_layer_summary", "args": MOE_LAYER,
                   "schedules": len(rows),
                   "dropped_expert_control": {
                       "max_abs_err": float((ctl - layer.want).abs().max()),
                       "within_tol": ctl_ok},
                   "layer_nccl_all_to_all_calls": a2a_calls[0],
                   "self_a2a_per_chunk_ms": a2a_ms, "copy_per_chunk_ms": copy_ms,
                   "a2a_bytes": nbytes, "a2a_bound_ms": bound_ms(nbytes),
                   "explore": {k: v for k, v in search.items() if k != "pct50_s"},
                   "explore_pct50_s": search["pct50_s"],
                   "launches": launches, "setup_s": round(setup_s, 3),
                   "wall_s": round(time.time() - t0, 3)}
            emit(row)
            del layer, y, ctl, src, dst, ex_bufs
            torch.cuda.empty_cache()
            # the same layer in bf16: its .pallas slot is the bf16 ffn_rows
            a16 = MoEArgs(**MOE_LAYER, dtype="bfloat16")
            layer16 = dryrun.build_layer(mesh, device, a16, seed=0,
                                         impl_choice=True)
            reset_launches()
            rows16, orders16 = dryrun.agree_schedules(layer16, cp)
            launches16 = all_launches()
            for r in rows16:
                emit({"phase": "moe_layer_bf16",
                      "y_tolerance": dryrun.Y_TOL_BF16, **r})
            pallas16 = next(o for o, r in zip(orders16, rows16)
                            if set(r["ffn_slots"]) == {".pallas"})
            y16 = dryrun.run_gathered(layer16, pallas16)
            bufs16, _, _ = make_moe_buffers(a16, seed=0)
            ctl16 = _drop_expert(torch, y16, bufs16, a16)
            del bufs16
            ctl16_ok = dryrun.y_within(ctl16, layer16.want, "bfloat16")
            row16 = {"phase": "moe_layer_bf16_summary", "args": asdict(a16),
                     "schedules": len(rows16),
                     "dropped_expert_control": {
                         **dryrun.y_error(ctl16, layer16.want),
                         "within_tol": ctl16_ok},
                     "launches": launches16,
                     "wall_s": round(time.time() - t0, 3)}
            emit(row16)
            del layer16, y16, ctl16
        finally:
            close_mesh()
    torch.cuda.empty_cache()
    if a2a_calls[0] <= 0:
        raise AssertionError("the moe layer posted no all-to-all through "
                             "the NCCL group")
    if ctl_ok or ctl16_ok:
        raise AssertionError("a dropped-expert control passed the Y "
                             f"tolerance (f32 {ctl_ok}, bf16 {ctl16_ok})")
    if launches["ffn_rows"] <= 0:
        raise AssertionError("the moe layer never launched ffn_rows")
    if launches16["ffn_rows_bf16"] <= 0:
        raise AssertionError("the bf16 moe layer never launched ffn_rows in "
                             "bf16")
    if search["rollouts"] < 1:
        raise AssertionError(f"the moe layer search measured nothing: {search}")
    return launches, rows, row, launches16


def phase_mesh_halo(torch, device):
    """The mesh halo exchange at the flagship width per rank on a
    world-size-1 NCCL group and a 1x1x1 mesh: the dryrun's agreement
    (parallel/dryrun.py ``agree_halo``: U bit-exact on every schedule, the
    engine menu's all-``.xla``, all-``.rdma`` and mixed orders among them)
    and an MCTS on the engine menu; returns the launch counts and the
    summary row."""
    import tempfile

    from tenzing_tpu_torch.models.halo import HaloArgs
    from tenzing_tpu_torch.parallel import dryrun
    from tenzing_tpu_torch.parallel.control_plane import DistControlPlane
    from tenzing_tpu_torch.parallel.mesh import close_mesh, control_group, init_mesh

    t0 = time.time()
    torch.cuda.set_device(device)
    with tempfile.TemporaryDirectory(prefix="tz_mesh_halo_") as d:
        mesh = init_mesh(dryrun.HALO_AXES, "nccl",
                         "file://" + os.path.join(d, "rv"), 0, 1,
                         shape=(1, 1, 1))
        try:
            cp = DistControlPlane(control_group())
            h = dryrun.build_halo(mesh, device,
                                  HaloArgs(**dryrun.HALO_FULL_ARGS), seed=0)
            setup_s = time.time() - t0
            reset_launches()
            rows = dryrun.agree_halo(h, cp)
            search = dryrun.explore_halo(h, cp, MESH_HALO_ITERS)
            launches = all_launches()
            for r in rows:
                emit({"phase": "mesh_halo", **r})
            row = {"phase": "mesh_halo_summary",
                   "args": dryrun.HALO_FULL_ARGS, "mesh": [1, 1, 1],
                   "schedules": len(rows),
                   "engines_scheduled": sorted({e for r in rows
                                                for e in r["engines"]}),
                   "explore": {k: v for k, v in search.items()
                               if k != "pct50_s"},
                   "iteration_pct50_ms": [t * 1e3 for t in search["pct50_s"]],
                   "launches": launches, "setup_s": round(setup_s, 3),
                   "wall_s": round(time.time() - t0, 3)}
            emit(row)
            del h
        finally:
            close_mesh()
    torch.cuda.empty_cache()
    whole = {tuple(sorted(set(r["engines"]))) for r in rows}
    if not {("xla",), ("rdma",)} <= whole:
        raise AssertionError(f"the mesh halo agreement lacks an all-.xla or "
                             f"an all-.rdma schedule: {whole}")
    if search["rollouts"] < 1:
        raise AssertionError(f"the mesh halo search measured nothing: {search}")
    if launches["device_copy"] <= 0:
        raise AssertionError("the mesh halo's .rdma loopback never launched "
                             "device_copy")
    return launches, row


def phase_mesh_halo_shared(torch):
    """Two ranks on GPU 0 over gloo, a 2x1x1 mesh, every exchange ``.rdma``
    (parallel/dryrun.py ``halo_shared_main``): per rank, U exact, both shift
    kernels launched, the write-after-read probe exact, and one x face's
    shift timed and held against ``torch.roll``.  The same two ranks then
    run the irregular SpMV's 2-rank shared-card stage on a 1x2 mesh
    (``halo_then_models_shared_main``: one start of the ranks for both).
    Returns the ranks' halo rows and that stage."""
    from tenzing_tpu_torch.parallel import dryrun
    from tenzing_tpu_torch.parallel.launch import launch

    t0 = time.time()
    cases = [{k: c[k] for k in ("model", "args", "label", "axes", "shape")}
             for c in dryrun.shared_cases(2)]
    ranks = launch("tenzing_tpu_torch.parallel.dryrun:"
                   "halo_then_models_shared_main", 2, "cuda",
                   {"args": dryrun.HALO_FULL_ARGS, "time_reps": 20,
                    "cases": cases},
                   timeout_s=600.0, mesh_axes=dryrun.HALO_AXES,
                   mesh_shape=(2, 1, 1), shared_card=True)
    bad = []
    for rank in ranks:
        r = rank["halo"]
        emit({"phase": "mesh_halo_shared", "args": dryrun.HALO_FULL_ARGS, **r})
        t = r["timing"]
        if not (all(s["u_exact"] for s in r["schedules"])
                and r["launches"]["rdma_shift_post"] > 0
                and r["launches"]["rdma_shift_wait"] > 0
                and r["war"]["acc_exact"] and t["exact_vs_roll"]
                and t["plain_exact"]):
            bad.append(r["rank"])
    emit({"phase": "mesh_halo_shared_summary", "ranks": len(ranks),
          "then": [c["label"] for c in cases],
          "wall_s": round(time.time() - t0, 3)})
    if bad:
        raise AssertionError(f"the shared-card mesh halo failed on ranks {bad}")
    stages = [{"stage": c["label"], "ranks": [r["models"][i] for r in ranks]}
              for i, c in enumerate(cases)]
    return [r["halo"] for r in ranks], stages


IRREGULAR_SHARED_RANKS = 4  # the shared-card irregular SpMV's own launch


def phase_irregular_shared(torch, stages_2):
    """The irregular SpMV on ranks sharing GPU 0 (parallel/dryrun.py
    ``models_main`` with ``shared_card``): the 2-rank band stage
    ``stages_2`` (run by :func:`phase_mesh_halo_shared`'s ranks), then the
    4-rank band and random stages in one launch.  Per stage and rank, every
    ``exchange.rdma`` schedule's Y within the tolerance, both shift kernels
    launched once per distance and schedule, and each distance's shift
    timed; returns the stages' rank rows."""
    from tenzing_tpu_torch.parallel import dryrun

    nproc = IRREGULAR_SHARED_RANKS
    bad = []
    t0 = time.time()
    summary = dryrun.models_main("spmv_irregular", nproc, "cuda",
                                 shared_card=True)
    stages = list(stages_2) + summary["stages"]
    for stage in stages:
        for r in stage["ranks"]:
            steps = sorted(int(d) for d in r["timing"])
            sched = r["schedules"]
            n_posts = len(sched) * len(steps)
            ok = (sched and all(x["within_tol"] and x["exchange"] == "rdma"
                                for x in sched)
                  and r["launches"]["rdma_shift_post"] == n_posts
                  and r["launches"]["rdma_shift_wait"] == n_posts)
            emit({"phase": "irregular_spmv_shared", "stage": stage["stage"],
                  "steps": steps, "ok": bool(ok), **r})
            if not ok:
                bad.append((stage["stage"], r["rank"]))
    emit({"phase": "irregular_spmv_shared_summary", "nproc": [2, nproc],
          "stages": [s["stage"] for s in stages],
          "nvidia_smi": nvidia_smi(), "wall_s": round(time.time() - t0, 3)})
    if bad:
        raise AssertionError(f"the shared-card irregular SpMV failed on "
                             f"(stage, rank) {bad}")
    return stages


def phase_models(torch, device, timer):
    """The other multi-device models at world size 1 over NCCL (module
    docstring, 11i): each stage of ``dryrun.full_cases``, every count set
    to 0 just before it and read just after; then the ring step's fold
    kernel on its 8192-key block against the plain version.  Returns
    (the launches by model, the fold rows)."""
    from tenzing_tpu_torch.models.ring_attention import RingAttnArgs
    from tenzing_tpu_torch.ops import attention_kernels as ak
    from tenzing_tpu_torch.parallel import dryrun

    launches, bad = {}, []
    for model in ("spmv_dist", "ring", "tp_mlp", "pipeline",
                  "pipeline_train"):
        t0 = time.time()
        reset_launches()
        summary = dryrun.models_main(model, 1, "cuda")
        launches[model] = {k: v for k, v in all_launches().items() if v}
        rows = [r for st in summary["stages"] for r in st["schedules"]]
        emit({"phase": "models", "model": model, "stages": summary["stages"],
              "launches": launches[model], "nvidia_smi": nvidia_smi(),
              "wall_s": round(time.time() - t0, 3)})
        if not rows or not all(r["within_tol"] for r in rows):
            bad.append(model)
    ring = launches["ring"]
    if ring.get("attn_block", 0) <= 0 or ring.get("attn_block_bf16", 0) <= 0:
        bad.append("ring launches")
    # two wrong dW at the card's width that dW's limit must reject (host)
    controls = dryrun.train_controls(dryrun.PIPE_FULL)
    emit({"phase": "models_train_controls", "args": dryrun.PIPE_FULL,
          "controls": controls})
    bad += [f"train control {k} passed" for k, c in controls.items()
            if c["within_tol"]]
    if bad:
        raise AssertionError(f"the models phase failed on {bad}")
    torch.cuda.empty_cache()
    # the ring step's fold at world size 1: all 8192 keys in one block
    a = RingAttnArgs(**{k: v for k, v in dryrun.RING_FULL.items()})
    b, n, d = a.batch, a.seq_local, a.head_dim
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    q, k, v = (torch.randn(b, n, d, device=device, generator=gen)
               for _ in range(3))
    fold_rows = []
    for bf16 in (False, True):
        st = [torch.zeros(b, n, d, device=device),
              torch.full((b, n, d), -1e30, device=device),
              torch.zeros(b, n, d, device=device)]
        got, want = [t.clone() for t in st], [t.clone() for t in st]
        ak.attn_block(q, k, v, *got, a.scale, bf16_inputs=bf16)
        ak.attn_block_plain(q, k, v, *want, a.scale, bf16)
        torch.cuda.synchronize()
        tol = ak.BF16_STATE_TOL if bf16 else ak.F32_STATE_TOL
        ok, errs = ak.state_check(got, want, tol)
        bound, bound_by = attn_bound(ak.fold_bytes(b, n, n, d),
                                     ak.attention_flops(b, n, n, d), bf16)
        row = {"phase": "ring_fold", "bf16_inputs": bf16,
               "shape": [b, n, n, d], "within_tol": ok, "errors": errs,
               "max_abs_err": max(e["max_abs"] for e in errs.values()),
               "ms": timer.ms(lambda: ak.attn_block(
                   q, k, v, *got, a.scale, bf16_inputs=bf16)),
               "plain_ms": timer.ms(lambda: ak.attn_block_plain(
                   q, k, v, *want, a.scale, bf16)),
               "bound_ms": bound, "bound_by": bound_by,
               "nvidia_smi": nvidia_smi()}
        row["tflops"] = ak.attention_flops(b, n, n, d) / (row["ms"] * 1e-3) / 1e12
        emit(row)
        fold_rows.append(row)
        del got, want, st
        if not ok:
            bad.append(f"ring fold bf16={bf16}")
    del q, k, v
    torch.cuda.empty_cache()
    if bad:
        raise AssertionError(f"the models phase failed on {bad}")
    return launches, fold_rows


def phase_dfs_example(torch):
    """The DFS example at the reference's size with a small cap."""
    import contextlib
    import io

    from tenzing_tpu_torch.core.graph import Graph
    from tenzing_tpu_torch.core.platform import Platform
    from tenzing_tpu_torch.examples import spmv_dfs
    from tenzing_tpu_torch.models.spmv import SpMVCompound
    from tenzing_tpu_torch.solve.dfs import enumerate_schedules

    from tenzing_tpu_torch.bench import driver
    from tenzing_tpu_torch.core.serdes import sequence_to_json
    from tenzing_tpu_torch.core.state import State
    from tenzing_tpu_torch.native import bridge

    t0 = time.time()
    cap = 12
    path = os.path.join(OUT_DIR, "spmv_dfs.csv")
    err = io.StringIO()
    prior = os.environ.get("TENZING_TPU_NATIVE")

    def enumerated(mode):
        """The example's enumeration (deterministic) with the native core on
        or off; its schedules' JSON and its host time."""
        os.environ["TENZING_TPU_NATIVE"] = mode
        g = Graph()
        g.start_then(SpMVCompound())
        g.then_finish(SpMVCompound())
        t = time.perf_counter()
        states = enumerate_schedules(g, Platform.make_n_lanes(2), cap)
        return ([json.dumps(sequence_to_json(st.sequence)) for st in states],
                time.perf_counter() - t)

    try:
        os.environ["TENZING_TPU_NATIVE"] = "1"
        with contextlib.redirect_stdout(io.StringIO()), \
                contextlib.redirect_stderr(err):
            rc = spmv_dfs.main(["--matrix-m", "150000", "--max-seqs", str(cap),
                                "--benchmark-iters", "10", "--dump-csv", path])
            native, native_s = enumerated("1")
            python, python_s = enumerated("0")
        os.environ["TENZING_TPU_NATIVE"] = "1"
        halo_g, _ = driver.graph_for(driver.DriverRequest())
        halo_plat = Platform.make_n_lanes(driver.search_lanes(
            driver.DriverRequest()))
        halo_root_lowers = bridge.try_decisions(State(halo_g),
                                                halo_plat) is not None
    finally:
        if prior is None:
            os.environ.pop("TENZING_TPU_NATIVE", None)
        else:
            os.environ["TENZING_TPU_NATIVE"] = prior
    with open(path) as f:
        n_rows = sum(1 for line in f if line.strip())
    best = [line for line in err.getvalue().splitlines() if line.startswith("best:")]
    row = {"phase": "dfs_example", "rc": rc, "schedules_measured": n_rows,
           "unique_terminals_enumerated": len(native), "cap": cap,
           "native_equals_python": native == python,
           "native_library": os.path.relpath(str(bridge.library_path()), REPO),
           "enumerate_native_host_s": round(native_s, 6),
           "enumerate_python_host_s": round(python_s, 6),
           "halo_root_lowers": halo_root_lowers, "card": nvidia_smi(),
           "best": best[0] if best else None, "wall_s": round(time.time() - t0, 3)}
    emit(row)
    if rc != 0 or n_rows < 1 or len(native) < n_rows or not best:
        raise AssertionError(f"the dfs example failed: {row}")
    if native != python:
        raise AssertionError("the native enumeration differs from the Python "
                             f"one at cap {cap}: {row}")
    torch.cuda.empty_cache()
    return row


def check_warm_start(verdict, phase: str) -> None:
    """The recorded warm start of a full-size driver run: at least one row
    of the committed databases measured (the block is printed, each row's
    TPU ratio beside its pct50 here) and the climb seeded from the best one
    spent budget."""
    rec = verdict.get("recorded")
    climbs = verdict.get("climbs") or []
    emit({"phase": f"{phase}_warm_start", "recorded": rec,
          "recorded_climb": climbs[0] if climbs else None})
    if not rec or not rec.get("measured"):
        raise AssertionError(f"{phase}: the warm start measured no recorded "
                             f"row: {rec}")
    if not climbs or climbs[0].get("seed") != "recorded" \
            or climbs[0]["spent"] <= 0:
        raise AssertionError(f"{phase}: the recorded climb did not run: "
                             f"{climbs}")


def check_attrib(verdict, trace_dir: str, metrics_path: str) -> None:
    """``--profile-winner`` / ``--trace-out`` / ``--metrics-json`` of the
    halo driver run: the ``attrib`` block complete with ``sum_of_parts_us >=
    critical_path_us > 0``, and explain.json, the trace and the metrics
    parse."""
    a = verdict.get("attrib") or {}
    keys = ("n_timed", "sum_of_parts_us", "critical_path_us",
            "dispatch_overhead_us", "overlap_efficiency", "timers",
            "fetch_overhead_us")
    with open(os.path.join(trace_dir, "explain.json")) as f:
        explain = json.load(f)
    with open(os.path.join(trace_dir, "trace.json")) as f:
        chrome = json.load(f)
    with open(os.path.join(trace_dir, "trace.jsonl")) as f:
        records = [json.loads(line) for line in f if line.strip()]
    with open(metrics_path) as f:
        metrics = json.load(f)
    emit({"phase": "driver_attrib", **{k: a.get(k) for k in keys},
          "explain": a.get("explain"), "critical_path": a.get("critical_path"),
          "per_lane_busy_us": a.get("per_lane_busy_us"),
          "utilization": a.get("utilization"),
          "trace_records": len(records),
          "trace_events": len(chrome["traceEvents"]),
          "counters": metrics["counters"]})
    if any(a.get(k) is None for k in keys) or not \
            a["sum_of_parts_us"] >= a["critical_path_us"] > 0:
        raise AssertionError(f"the attrib block is incomplete: {a}")
    if verdict.get("winner_label") is not None and "explain" not in a:
        raise AssertionError("the attrib block lacks the explain against naive")
    if explain.get("attrib", {}).get("n_timed") != a["n_timed"] \
            or not records or not chrome["traceEvents"]:
        raise AssertionError("explain.json or the trace is empty")


def phase_examples(torch, halo_db: str):
    """The MoE and halo examples with small budgets (the halo on a
    world-size-1 NCCL group, then on two ranks sharing the card with every
    exchange ``.rdma``), and ``mcts_replay`` over the halo driver's
    database."""
    import contextlib
    import io

    from tenzing_tpu_torch.examples import halo_mcts, mcts_replay, moe_mcts

    import glob
    import shutil

    small = ["--mcts-iters", "4", "--benchmark-iters", "3"]
    # the moe example dumps its tree (--dump-tree) into the working
    # directory: run it from a directory of its own under chiprun_out
    tree_dir = os.path.join(OUT_DIR, "examples_tree")
    shutil.rmtree(tree_dir, ignore_errors=True)
    os.makedirs(tree_dir)
    for name, module, argv in (
            ("moe_mcts", moe_mcts, small + ["--dump-tree"]),
            ("halo_mcts", halo_mcts, small),
            ("halo_mcts_shared", halo_mcts,
             small + ["--nproc", "2", "--shared-card"])):
        t0 = time.time()
        out, err = io.StringIO(), io.StringIO()
        reset_launches()
        cwd = os.getcwd()
        if "--dump-tree" in argv:
            os.chdir(tree_dir)
        try:
            with contextlib.redirect_stdout(out), \
                    contextlib.redirect_stderr(err):
                rc = module.main(argv)
        finally:
            os.chdir(cwd)
        launches = all_launches()
        rows = out.getvalue().strip().splitlines()
        best = [line for line in err.getvalue().splitlines()
                if line.startswith("best:")]
        stamp = [json.loads(line) for line in err.getvalue().splitlines()
                 if line.startswith('{"tenzing_tpu_torch"')]
        row = {"phase": "examples", "example": name, "rc": rc,
               "schedules": len(rows), "best": best[0] if best else None,
               "launches": {k: v for k, v in launches.items() if v},
               "stamp": stamp[0] if stamp else None,
               "wall_s": round(time.time() - t0, 3)}
        if "--dump-tree" in argv:
            dots = sorted(glob.glob(os.path.join(tree_dir, "mcts_tree_*.dot")))
            row["tree_dumps"] = [os.path.basename(d) for d in dots]
            if not dots or any("digraph mcts" not in open(d).read()
                               for d in dots):
                raise AssertionError(f"the {name} example dumped no tree: "
                                     f"{row}")
        emit(row)
        if rc != 0 or len(rows) < 1 or not best or not stamp:
            raise AssertionError(f"the {name} example failed: {row}")
        torch.cuda.empty_cache()
    t0 = time.time()
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = mcts_replay.main(["--csv", halo_db, "--workload", "halo",
                               "--lanes", "8", "--mcts-iters", "24",
                               "--strategies", "FastMin,Random"])
    lines = out.getvalue().strip().splitlines()
    db = [line for line in err.getvalue().splitlines()
          if line.startswith("database:")]
    row = {"phase": "examples", "example": "mcts_replay", "rc": rc,
           "database": db[0] if db else None, "strategies": lines,
           "wall_s": round(time.time() - t0, 3)}
    emit(row)
    if rc != 0 or len(lines) != 2 or not db:
        raise AssertionError(f"the replay example failed: {row}")


# -- the synthesized collectives and the learned screen ------------------------------

# the halo widths of the synth_halo phase: the flagship (nQ 3 splits one way
# only, so its menu is neighbor.c1) and the same grid at nQ 2, where the
# face also splits in two (neighbor.c2)
SYNTH_HALO_NQ2 = dict(nq=2, lx=512, ly=512, lz=512, radius=3)
# the injected device loss of the learn phase's step (c): at the full-size
# halo this spec fires on the fourth incumbent's first attempt (the naive
# baseline and the first three incumbents measure; fault/inject.py draws by
# schedule id and attempt, the same on every machine)
LEARN_LOSS_SPEC = "device_lost:0.15:6"


def _pick_suffixes(g, plat, prefer):
    """The first decision at every step, each choice taking the alternative
    ``prefer(choice name, alternative names)`` names."""
    from tenzing_tpu_torch.core.state import ChooseOp, State

    st = State(g)
    while not st.is_terminal():
        ds = st.get_decisions(plat)
        chosen = ds[0]
        alts = [d for d in ds if isinstance(d, ChooseOp)]
        if alts:
            want = prefer(alts[0].op.name(), [d.choice.name() for d in alts])
            chosen = next((d for d in alts if d.choice.name() == want), ds[0])
        st = st.apply(chosen)
    return st.sequence


def phase_synth_spmv(torch, device, smi):
    """(a) The spmv driver at m=150000 with ``--synth-collectives`` (the
    roofline's prune on, as at full size in the reference): verified, no
    ``fault`` block, the ``synth`` block with the menu and each pruned
    instantiation's reason under the card's constants.  (b) Through the
    stream executor with graphs at m=150000 and m=8192: the fixed host round
    trip and each pipe instantiation (every instantiation kept), the kernel
    slot where the menu offers it; every pipe schedule's y and x_remote
    equal the fixed one's bit for bit and y passes the spmv check against
    the host product; at m=8192 ``ell_spmv`` is launched on every schedule;
    each schedule's graph wall and segment count.  Returns the ``ell_spmv``
    launches counted under the pipe schedules."""
    from tenzing_tpu_torch.bench import breakdown, driver
    from tenzing_tpu_torch.collectives.synth import synths_of
    from tenzing_tpu_torch.core.platform import Platform
    from tenzing_tpu_torch.ops.spmv_kernels import ELL_TOL
    from tenzing_tpu_torch.runtime import graphs
    from tenzing_tpu_torch.runtime.executor import StreamExecutor

    t0 = time.time()
    req = driver.DriverRequest(workload="spmv", m=150_000,
                               mcts_iters=DRIVER_MCTS_ITERS,
                               iters=3, search_iters=2,
                               synth_collectives=True)
    reset_launches()
    result = driver.run(req, device="cuda")
    launches = all_launches()
    verdict = result.verdict
    print(result.to_json_line(), flush=True)
    synth = verdict.get("perf", {}).get("synth")
    emit({"phase": "synth_spmv_driver", "m": 150_000, "card": smi,
          "verified": verdict.get("verified"), "synth": synth,
          "launches": {k: v for k, v in launches.items() if v},
          "wall_s": round(time.time() - t0, 3)})
    check_no_failures(verdict, "synth spmv driver")
    if verdict.get("verified") is not True:
        raise AssertionError(f"synth spmv driver not verified: {verdict}")
    menu = (synth or {}).get("menus", {}).get("x_exchange")
    if not menu or menu["menu"][0] != "fixed" or not menu["est_us"]:
        raise AssertionError(f"the synth block lacks the exchange menu: {synth}")
    kept = set(menu["menu"][1:])
    if set(menu["pruned"]) | kept != set(menu["est_us"]) or not all(
            menu["pruned"].values()):
        raise AssertionError(f"an instantiation is neither kept nor pruned "
                             f"with a reason: {menu}")
    torch.cuda.empty_cache()

    synth_launches = 0
    for m in (150_000, 8192):
        t1 = time.time()
        g, tb, want = spmv_setup(torch, device, m, synth=True)
        plat = Platform.make_n_lanes(2)
        ex = StreamExecutor(plat, tb, device="cuda", graphs=True)
        rows, outs = [], {}
        for label in ("fixed", "pipe.c2", "pipe.c4"):
            def prefer(name, alts, label=label):
                sfx = ".fixed" if label == "fixed" else label
                return next((a for a in alts if a.endswith(sfx)),
                            next((a for a in alts if a.endswith(".pallas")),
                                 next((a for a in alts if a.endswith(".xla")),
                                      None)))
            order = _pick_suffixes(g, plat, prefer)
            chosen = synths_of(order.vector())
            if (label == "fixed") != (not chosen):
                raise AssertionError(f"m={m} {label}: chose {chosen}")
            before = all_launches()
            out = ex.run(order)
            after = all_launches()
            outs[label] = {k: out[k].clone() for k in ("y", "x_remote")}
            ell = after["ell_spmv"] - before["ell_spmv"]
            if label != "fixed":
                synth_launches += ell
            meas = breakdown.measure(ex, order, 20, profile=False)
            segs = graphs.plan_segments(order.vector(), ex.host_names,
                                        ex.ctx.defer_host_syncs)
            rows.append({"schedule": label, "ops": len(order),
                         "wall_us": meas["wall_us"],
                         "host_syncs_per_iter": meas["host_syncs_per_iter"],
                         "segments": len(segs), "ell_spmv_launches": ell,
                         "kernel_slot": any(op.name().endswith(".pallas")
                                            for op in order.vector())})
            if m == 8192 and ell <= 0:
                raise AssertionError(f"m=8192 {label}: ell_spmv not launched")
        ok = y_close(torch, outs["fixed"]["y"], want, ELL_TOL)
        same = {k: all(torch.equal(outs[k][n], outs["fixed"][n])
                       for n in ("y", "x_remote"))
                for k in ("pipe.c2", "pipe.c4")}
        emit({"phase": "synth_spmv", "m": m, "card": smi, "schedules": rows,
              "y_within_tol": ok, "bit_identical_to_fixed": same,
              "wall_s": round(time.time() - t1, 3)})
        if not ok or not all(same.values()):
            raise AssertionError(f"synth spmv m={m}: y {ok}, pipes equal to "
                                 f"fixed {same}")
        del ex, tb, outs
        torch.cuda.empty_cache()
    return synth_launches


def phase_synth_halo(torch, device, smi):
    """The mesh halo at the flagship width per rank on a world-size-1 NCCL
    group and a 1x1x1 mesh, built with ``synth=True, synth_relax=True``:
    every face on ``.xla``, every face on ``neighbor.c1``, and a mix (x
    faces ``.rdma``, y ``neighbor.c1``, z ``.xla``); then the same grid at
    nQ 2, where a face splits in two: every face on ``.xla`` and every face
    on ``neighbor.c2``.  U bit-exact against the expected array (and so
    against the all-``.xla`` order) on every schedule; ``device_copy``
    launched where an ``.rdma`` face runs."""
    import tempfile

    from tenzing_tpu_torch.collectives.synth import synths_of
    from tenzing_tpu_torch.models.halo import HaloArgs
    from tenzing_tpu_torch.parallel import dryrun
    from tenzing_tpu_torch.parallel.control_plane import DistControlPlane
    from tenzing_tpu_torch.parallel.mesh import close_mesh, control_group, init_mesh

    picks = {
        "xla": lambda n: ".xla",
        "neighbor.c1": lambda n: ".synthed.neighbor.c1",
        "neighbor.c2": lambda n: ".synthed.neighbor.c2",
        "mixed": lambda n: {"x": ".rdma", "y": ".synthed.neighbor.c1",
                            "z": ".xla"}[n[-1]],
    }
    cases = ((dryrun.HALO_FULL_ARGS, ("xla", "neighbor.c1", "mixed")),
             (SYNTH_HALO_NQ2, ("xla", "neighbor.c2")))
    rows = []
    torch.cuda.set_device(device)
    with tempfile.TemporaryDirectory(prefix="tz_synth_halo_") as d:
        mesh = init_mesh(dryrun.HALO_AXES, "nccl",
                         "file://" + os.path.join(d, "rv"), 0, 1,
                         shape=(1, 1, 1))
        try:
            cp = DistControlPlane(control_group())
            for args, labels in cases:
                t0 = time.time()
                h = dryrun.build_halo(mesh, device, HaloArgs(**args), seed=0,
                                      synth=True)
                g = dryrun.halo_graph(h.args, synth=True)
                for label in labels:
                    order = dryrun.engine_order(g, h.platform, picks[label])
                    reset_launches()
                    row = dryrun.run_checked(h, order, cp, label)
                    row.update(args=args, card=smi,
                               synths=sorted({f"{v['sketch']}.c{v['chunks']}"
                                              for v in synths_of(
                                                  order.vector()).values()}),
                               device_copy=all_launches()["device_copy"])
                    emit({"phase": "synth_halo", **row})
                    rows.append(row)
                    if not row["u_exact"]:
                        raise AssertionError(f"synth halo {label}: U differs")
                    if "rdma" in row["engines"] and row["device_copy"] <= 0:
                        raise AssertionError(f"synth halo {label}: the .rdma "
                                             "faces never launched device_copy")
                    if label.startswith("neighbor") and row["synths"] != [label]:
                        raise AssertionError(f"synth halo {label}: ran "
                                             f"{row['synths']}")
                emit({"phase": "synth_halo_summary", "args": args, "card": smi,
                      "wall_s": round(time.time() - t0, 3)})
                del h
                torch.cuda.empty_cache()
        finally:
            close_mesh()
    return rows


def phase_learn(torch, smi, halo_db: str, halo_trace: str):
    """(a) ``--learn-train`` on the halo driver phase's own database and
    trace bundle (the card's measurements; no TPU database): rows >= 4 and a
    ``train_spearman``.  (b) The halo driver at full size with
    ``--learn-screen`` and that model, ``--prefetch-compiles 2``: the screen
    escalated queries to the card and its answers, the climbs' prescreen
    prunes and the prefetcher's ranked hints are reported, the winner
    verified by the gate, no ``fault`` block.  (The surrogate may answer
    none: every rollout of the alias discipline can lie within the screen's
    band of the four best measured; PERF.md §6.)  (c) The same search with an injected
    device loss (``LEARN_LOSS_SPEC``): the degraded verdict (``vs_baseline``
    1.0, ``verified: false``, ``fault.degraded``) and no kernel launched
    after the loss (the counts when the loss was injected equal those at the
    end), the run returning normally.  Returns the path of (b)'s verdict,
    which the serve phase's regression check reads."""
    from tenzing_tpu_torch.bench import driver
    from tenzing_tpu_torch.fault import inject

    model = os.path.join(OUT_DIR, "halo_model.json")
    t0 = time.time()
    train = driver.run(driver.DriverRequest(
        learn_train=[halo_db], learn_trace=[os.path.join(halo_trace,
                                                         "*.jsonl")],
        learn_model=model), device="cuda").verdict
    print(json.dumps(train), flush=True)
    emit({"phase": "learn_train", **train, "card": smi,
          "wall_s": round(time.time() - t0, 3)})
    if train.get("rows", 0) < 4 or "train_spearman" not in train:
        raise AssertionError(f"learn-train: {train}")
    torch.cuda.empty_cache()

    # the halo driver phase's budget
    base = dict(mcts_iters=DRIVER_MCTS_ITERS, iters=3, search_iters=2,
                climb_budget=4,
                prefetch_compiles=2, learn_screen=True, learn_model=model)
    from tenzing_tpu_torch.obs.metrics import get_metrics

    counters = ("learn.screen.surrogate_hits", "learn.screen.escalations",
                "learn.screen.escalations.warmup",
                "learn.screen.escalations.topk",
                "learn.screen.escalations.fidelity",
                "learn.prune.local_skipped", "learn.surrogate.predictions")
    reg = get_metrics()
    before = {c: reg.counter(c).value for c in counters}
    t0 = time.time()
    reset_launches()
    result = driver.run(driver.DriverRequest(**base), device="cuda")
    launches = all_launches()
    verdict = result.verdict
    print(result.to_json_line(), flush=True)
    screened = os.path.join(OUT_DIR, "learn_screen_verdict.json")
    with open(screened, "w") as f:
        f.write(result.to_json_line() + "\n")
    emit({"phase": "learn_screen", "card": smi, "learn": verdict.get("learn"),
          "counters": {c: reg.counter(c).value - before[c] for c in counters},
          "verified": verdict.get("verified"),
          "vs_baseline": verdict.get("vs_baseline"),
          "winner_label": verdict.get("winner_label"),
          "launches": {k: v for k, v in launches.items() if v},
          "wall_s": round(time.time() - t0, 3)})
    check_no_failures(verdict, "learn screen")
    learn = verdict.get("learn") or {}
    if verdict.get("verified") is not True:
        raise AssertionError(f"the screened halo search is not verified: "
                             f"{verdict}")
    if learn.get("escalations", 0) <= 0 or (
            reg.counter("learn.surrogate.predictions").value
            <= before["learn.surrogate.predictions"]):
        raise AssertionError(f"the learned screen predicted or escalated "
                             f"nothing: {learn}")
    torch.cuda.empty_cache()

    t0 = time.time()
    at_loss = {}
    record = inject.FaultInjectingBenchmarker._record

    def snapshot(self, kind, sid):
        if kind == "device_lost" and not at_loss:
            at_loss.update(all_launches())
        record(self, kind, sid)

    reset_launches()
    inject.FaultInjectingBenchmarker._record = snapshot
    try:
        result = driver.run(driver.DriverRequest(
            inject_faults=LEARN_LOSS_SPEC, **base), device="cuda")
    finally:
        inject.FaultInjectingBenchmarker._record = record
    end = all_launches()
    verdict = result.verdict
    print(result.to_json_line(), flush=True)
    fault = verdict.get("fault") or {}
    row = {"phase": "learn_degraded", "card": smi, "spec": LEARN_LOSS_SPEC,
           "value": verdict.get("value"), "naive_us": verdict.get("naive_us"),
           "vs_baseline": verdict.get("vs_baseline"),
           "verified": verdict.get("verified"), "fault": fault,
           "launches_at_loss": {k: v for k, v in at_loss.items() if v},
           "launches_after_loss": {k: end[k] - at_loss.get(k, 0) for k in end
                                   if end[k] != at_loss.get(k, 0)},
           "wall_s": round(time.time() - t0, 3)}
    emit(row)
    if not at_loss:
        raise AssertionError("learn degraded: the device loss never fired")
    if (verdict.get("vs_baseline") != 1.0 or verdict.get("verified") is not False
            or fault.get("degraded") is not True):
        raise AssertionError(f"learn degraded: not the degraded verdict: "
                             f"{verdict}")
    if row["launches_after_loss"]:
        raise AssertionError(f"learn degraded: kernels launched after the "
                             f"loss: {row['launches_after_loss']}")
    torch.cuda.empty_cache()
    return screened


# -- the serve phase ---------------------------------------------------------------

# the two requests the serve phase queues cold: the driver's default (the
# full-width halo, 8 lanes) and the spmv search at --m 8192 (ell_spmv on its
# menu)
SERVE_REQUESTS = {"halo": {}, "spmv": {"workload": "spmv", "m": 8192}}
# the chip smoke's cut budget (the halo driver phase's) as the daemon's
# overrides: budget fields only, which the daemon checks leave the item's
# fingerprint as it is
SERVE_OVERRIDES = dict(mcts_iters=DRIVER_MCTS_ITERS, iters=3, search_iters=2,
                       climb_budget=4)
# each request's store: halo drains into a segmented store directory, spmv
# into the monolithic file, so the card drives both backends
SERVE_STORES = {"halo": "store.d", "spmv": "store.json"}
# the listen loop's cold request: nothing stored answers it (its bucket
# differs from --m 8192's, and the restored store has no near-tier model)
SERVE_COLD = {"workload": "spmv", "m": 4096}
SERVE_BURST = 16  # repeats of each exact request sent to the listen loop
SUPERVISOR_TICK_S = 0.2  # step 4's supervisor tick


def serve_admitted(csv: str, req, topk: int = 3) -> int:
    """The records a re-warm from ``csv`` stores: the distinct schedules
    among the rows the port's ``scored_rows`` admits, at most ``topk`` (the
    drain's winners are verified, so none is stored flagged)."""
    from tenzing_tpu_torch.bench.driver import graph_for
    from tenzing_tpu_torch.bench.recorded import scored_rows
    from tenzing_tpu_torch.serve.fingerprint import schedule_key

    scored, _ = scored_rows([csv], graph_for(req)[0])
    return min(topk, len({schedule_key(seq) for _, _, seq, _ in scored}))


def serve_child(serve_dir: str, halo_db: str) -> int:
    """``chip_smoke.py --serve-child DIR DB``: steps 1 and 2 of the serve
    phase in a process that never touches the card.  (1) ``serve warm
    --platform cuda`` of the full-width halo request from DB (the CLI's
    ``main``) into ``DIR/warm``; (2) through the library, a cold query of
    each of ``SERVE_REQUESTS`` against a fresh store and queue in
    ``DIR/<workload>``, each under a trace context of its own with the
    tracer on, as the listen loop runs a request; the tracer's bundle goes
    to ``DIR/serve_child.jsonl``.  Prints one JSON line: the warm summary,
    each stored record's source, platform and admission stamp, each
    query's tier, trace id, work items and resolve time, the tracer's
    drops, and whether CUDA was initialized."""
    import io

    import torch

    sys.path.insert(0, REPO)
    from tenzing_tpu_torch.bench.driver import DriverRequest
    from tenzing_tpu_torch.obs import context as obs_context
    from tenzing_tpu_torch.obs.export import write_jsonl
    from tenzing_tpu_torch.obs.tracer import configure
    from tenzing_tpu_torch.serve import __main__ as serve_cli
    from tenzing_tpu_torch.serve.service import ScheduleService
    from tenzing_tpu_torch.serve.store import ScheduleStore

    warm_store = os.path.join(serve_dir, "warm", "store.json")
    buf = io.StringIO()
    t0 = time.time()
    with contextlib.redirect_stdout(buf):
        serve_cli.main(["warm", "--store", warm_store, "--platform", "cuda",
                        "--workload", "halo", "--csv", halo_db])
    out = {"child": "serve",
           "warm": json.loads(buf.getvalue().strip().splitlines()[-1]),
           "warm_wall_s": round(time.time() - t0, 3),
           "warm_records": [
               {"source": r["provenance"].get("source"),
                "platform": r["fingerprint"]["platform"],
                "verified": bool(r.get("verified_at_admission")),
                "vs_naive": r["vs_naive"], "pct50_us": r["pct50_us"]}
               for r in ScheduleStore(warm_store).records()],
           "cold": {}}
    tracer = configure(enabled=True)
    for name, kw in SERVE_REQUESTS.items():
        d = os.path.join(serve_dir, name)
        svc = ScheduleService(os.path.join(d, SERVE_STORES[name]),
                              queue_dir=os.path.join(d, "queue"),
                              platform="cuda")
        t0 = time.perf_counter()
        with obs_context.use(obs_context.new_trace()):
            res = svc.query(DriverRequest(**kw))
        us = (time.perf_counter() - t0) * 1e6
        items = svc.queue.items()
        out["cold"][name] = {"tier": res.tier, "work_item": res.work_item,
                             "items": len(items),
                             "trace_id": res.trace_id,
                             "envelope_trace_id": [
                                 (p.get("trace") or {}).get("trace_id")
                                 for _, p in items],
                             "exact": res.fingerprint.exact_digest,
                             "platform": res.fingerprint.platform,
                             "resolve_us": round(us, 1),
                             "phase_us": res.phase_us}
    write_jsonl(tracer, os.path.join(serve_dir, "serve_child.jsonl"))
    out["tracer"] = tracer.retention()
    out["cuda_initialized"] = torch.cuda.is_initialized()
    print(json.dumps(out), flush=True)
    return 0


def _launched(run):
    """``run()``'s result and the kernel launches it made, counted as the
    difference around it (the nonzero ones)."""
    before = all_launches()
    out = run()
    return out, {k: v - before.get(k, 0) for k, v in all_launches().items()
                 if v - before.get(k, 0)}


def _serve_run(torch, device, name: str, record, req):
    """Steps 5 and 8 for one workload: the exact answer's schedule,
    deserialized against the graph the driver searches, run on the card
    through the stream executor (with graphs) beside naive on the same
    buffers, each run's launches counted apart (``launches`` the answer's,
    ``launches_naive`` naive's).  Halo: U bit-exact with naive's; spmv: y of
    both within ``ELL_TOL`` of the float64 product."""
    from tenzing_tpu_torch.bench import driver
    from tenzing_tpu_torch.core.platform import Platform
    from tenzing_tpu_torch.core.serdes import sequence_from_json
    from tenzing_tpu_torch.models.halo_pipeline import naive_order
    from tenzing_tpu_torch.models.spmv import fixed_orders
    from tenzing_tpu_torch.ops.spmv_kernels import ELL_TOL
    from tenzing_tpu_torch.runtime.executor import StreamExecutor
    from tenzing_tpu_torch.verify import ScheduleVerifier

    plat = Platform.make_n_lanes(driver.search_lanes(req))
    if name == "halo":
        g, tbufs, _, hargs = driver.build_halo(req, device)
        naive, want = naive_order(hargs, plat), None
    else:
        g, tbufs, want = spmv_setup(torch, device, driver.spmv_m(req))
        naive = fixed_orders(g)["naive"]
    order = sequence_from_json(record["ops"], g)
    if not ScheduleVerifier(g)(order).ok:
        raise AssertionError(f"serve exact {name}: the answer is not sound")
    ex = StreamExecutor(plat, tbufs, device="cuda")
    t0 = time.time()
    out_s, launches = _launched(lambda: ex.run(order))
    out_n, launches_naive = _launched(lambda: ex.run(naive))
    row = {"ops": len(order), "graphs": True,
           "run_wall_s": round(time.time() - t0, 3),
           "kernel_ops": answer_kernels(order), "launches": launches,
           "launches_naive": launches_naive}
    if name == "halo":
        row["U_bit_exact_vs_naive"] = bool(torch.equal(out_s["U"],
                                                       out_n["U"]))
        ok = row["U_bit_exact_vs_naive"]
    else:
        row["y_max_abs_err"] = float((out_s["y"].double() - want).abs().max())
        row["naive_y_max_abs_err"] = float(
            (out_n["y"].double() - want).abs().max())
        ok = (y_close(torch, out_s["y"], want, ELL_TOL)
              and y_close(torch, out_n["y"], want, ELL_TOL))
        row["within_ell_tol"] = ok
    del ex, tbufs, out_s, out_n
    torch.cuda.empty_cache()
    if not ok:
        raise AssertionError(f"serve exact {name}: the answered schedule's "
                             f"outputs disagree: {row}")
    return row


def answer_kernels(order):
    """The hand-written kernels a schedule's ops launch, with the number of
    ops that launch each: the menu slots the search picked (a pack or
    unpack on a kernel slot, a transfer on ``.rdma``, an SpMV on
    ``.pallas``).  Step 8 holds the answers' launches to it."""
    from tenzing_tpu_torch.models.spmv import SpMVPallasOp
    from tenzing_tpu_torch.ops.halo_kernels import _KernelPack, _KernelUnpack
    from tenzing_tpu_torch.ops.rdma import RdmaCopyStart

    kinds = ((_KernelPack, "halo_pack"), (_KernelUnpack, "halo_unpack"),
             (RdmaCopyStart, "device_copy"), (SpMVPallasOp, "ell_spmv"))
    out = {}
    for op in order:
        op = op.unbound() if hasattr(op, "unbound") else op
        for cls, kernel in kinds:
            if isinstance(op, cls):
                out[kernel] = out.get(kernel, 0) + 1
    return out


def phase_serve(torch, device, smi, halo_db: str, inputs):
    """The serving plane on the card (module docstring): warm, cold, a
    drain in-process (halo, into a segmented store), then one by the CLI's
    subprocess runner (spmv), exact answers run on the card, disaster
    recovery, the listen loop, its answers run on the card, and the
    analysis of what they all wrote (step 9; ``inputs`` names the halo
    driver phase's trace, metrics and verdict files and the learn phase's
    screened verdict).  Returns the row it prints, with each step's
    launches."""
    import shutil

    from tenzing_tpu_torch.obs.tracer import Tracer, set_tracer

    from tenzing_tpu_torch.bench.driver import DriverRequest
    from tenzing_tpu_torch.serve.daemon import (
        DaemonOpts,
        DrainDaemon,
        drain_checkpoint_of,
        drain_csv_path,
    )
    from tenzing_tpu_torch.serve.service import ScheduleService
    from tenzing_tpu_torch.serve.store import ScheduleStore, WorkQueue, open_store

    torch.cuda.empty_cache()
    serve_dir = os.path.join(OUT_DIR, "serve")
    shutil.rmtree(serve_dir, ignore_errors=True)
    os.makedirs(serve_dir)
    t_phase = time.time()
    card = torch.cuda.get_device_name(0)
    reqs = {n: DriverRequest(**kw) for n, kw in SERVE_REQUESTS.items()}
    steps = {}

    # steps 1-2: warm and cold, in a process that never touches the card
    t0 = time.time()
    r = subprocess.run([sys.executable, os.path.abspath(__file__),
                        "--serve-child", serve_dir, halo_db],
                       capture_output=True, text=True, timeout=600)
    with open(os.path.join(serve_dir, "child.err"), "w") as f:
        f.write(r.stderr)
    if r.returncode != 0:
        raise AssertionError(f"serve child rc={r.returncode}: "
                             f"{r.stderr[-2000:]}")
    child = _json_tail(r.stdout, "serve child")
    warm = child["warm"]
    steps["warm"] = {"added": warm["added"], "admission": warm["admission"],
                     "rows": warm["rows"], "candidates": warm["candidates"],
                     "records": child["warm_records"],
                     "wall_s": child["warm_wall_s"]}
    steps["cold"] = {**child["cold"],
                     "cuda_initialized": child["cuda_initialized"],
                     "tracer": child["tracer"],
                     "wall_s": round(time.time() - t0, 3)}
    db_name = os.path.basename(halo_db)
    if not (warm["admission"]["verified"] or 0) >= 1 or not all(
            w["source"] == db_name and w["platform"] == "cuda"
            for w in child["warm_records"]):
        raise AssertionError(f"serve warm: {steps['warm']}")
    if child["cuda_initialized"] or any(
            c["tier"] != "cold" or c["items"] != 1 or c["platform"] != "cuda"
            or not c["trace_id"] or c["envelope_trace_id"] != [c["trace_id"]]
            for c in child["cold"].values()):
        raise AssertionError(f"serve cold: {steps['cold']}")

    dirs = {n: os.path.join(serve_dir, n) for n in reqs}
    queues = {n: WorkQueue(os.path.join(d, "queue")) for n, d in dirs.items()}
    stores = {n: os.path.join(d, SERVE_STORES[n]) for n, d in dirs.items()}
    items = {n: q.items()[0] for n, q in queues.items()}

    # step 3: the halo item drained in this process on the card, traced
    # into a tracer of its own, so the bundle holds the drain alone
    t0 = time.time()
    bundles = {"serve_child": os.path.join(serve_dir, "serve_child.jsonl"),
               "daemon_halo": os.path.join(serve_dir, "daemon_halo.jsonl"),
               "daemon_spmv": os.path.join(serve_dir, "daemon_spmv.jsonl")}
    d = DrainDaemon(DaemonOpts(
        queue_dir=queues["halo"].dir, store_path=stores["halo"],
        owner="chip-smoke-halo", once=True, in_process=True,
        device="cuda", handle_signals=False,
        overrides=dict(SERVE_OVERRIDES), trace_out=bundles["daemon_halo"]))
    verdicts = []
    inner = d._runner

    def runner(path, payload, timeout):
        verdicts.append(inner(path, payload, timeout))
        return verdicts[-1]

    d._runner = runner
    reset_launches()
    outer_tracer = set_tracer(Tracer(enabled=False))
    try:
        summary = d.run()
    finally:
        drain_tracer = set_tracer(outer_tracer)
    launches = all_launches()
    path, payload = items["halo"]
    exact = queues["halo"].exact_of(path)
    left = sorted(n for n in os.listdir(queues["halo"].dir)
                  if n.startswith(("work-", "lease-", "fail-", "poison-")))
    st = open_store(stores["halo"])
    steps["drain_halo"] = {
        "runner": "in_process", "summary": summary["counters"],
        "history": d.history[-1:], "left": left,
        "verified": verdicts[-1].get("verified") if verdicts else None,
        "value_us": verdicts[-1].get("value") if verdicts else None,
        "vs_baseline": verdicts[-1].get("vs_baseline") if verdicts else None,
        "records": len(st), "devices": sorted({
            r["provenance"].get("device") for r in st.records()}),
        "launches": {k: v for k, v in launches.items() if v},
        "tracer": drain_tracer.retention(),
        "wall_s": round(time.time() - t0, 3)}
    if (summary["counters"]["completed"] != 1 or left
            or not verdicts or verdicts[-1].get("verified") is not True
            or len(st) < 1 or steps["drain_halo"]["devices"] != [card]
            or any(r["exact"] != exact for r in st.records())):
        raise AssertionError(f"serve drain halo: {steps['drain_halo']}")
    missing = [k for k in ("halo_pack", "halo_unpack", "device_copy")
               if launches[k] <= 0]
    if missing:
        raise AssertionError(f"the halo drain never launched {missing}")
    torch.cuda.empty_cache()

    # step 4, once the halo drain is done (the card to itself): the spmv
    # item drained through the supervisor (serve/supervisor.py), whose one
    # member is the daemon CLI with its default subprocess runner; the
    # member's --exec-item child reports the kernels it launched (counted
    # from 0 in that process) in its verdict, and the member writes the
    # bundle step 9 reads
    member = [sys.executable, "-m", "tenzing_tpu_torch.serve.daemon",
              "--queue", queues["spmv"].dir, "--store", stores["spmv"],
              "--owner", "{owner}", "--idle-exit", "1", "--poll", "0.2",
              "--heartbeat", "0.5", "--trace-out", bundles["daemon_spmv"],
              "--device", "cuda"]
    for k, v in SERVE_OVERRIDES.items():
        member += ["--override", f"{k}={v}"]
    cmd = [sys.executable, "-m", "tenzing_tpu_torch.serve.supervisor",
           "--queue", queues["spmv"].dir, "--store", stores["spmv"],
           "--owner", "chip-smoke-supervisor",
           "--owner-prefix", "chip-smoke-spmv",
           "--min-daemons", "1", "--max-daemons", "1", "--drain-exit",
           "--compact-interval", "0", "--gc-interval", "0",
           "--tick", str(SUPERVISOR_TICK_S), "--heartbeat", "0.5",
           "--member-idle-exit", "1", "--member-argv", json.dumps(member)]
    t0 = time.time()
    with open(os.path.join(serve_dir, "supervisor_spmv.err"), "w") as err:
        r = subprocess.run(cmd, cwd=REPO, stdout=subprocess.PIPE, stderr=err,
                           text=True, timeout=600)
    path, payload = items["spmv"]
    exact = queues["spmv"].exact_of(path)
    ckpt = drain_checkpoint_of(payload, path)
    sup = _json_tail(r.stdout, "serve spmv supervisor")
    with open(os.path.join(queues["spmv"].dir,
                           "status-chip-smoke-spmv-0.json")) as f:
        member_status = json.load(f)
    with open(os.path.join(ckpt, "verdict.json")) as f:
        verdict = json.load(f)
    st = ScheduleStore(stores["spmv"])
    want_records = serve_admitted(drain_csv_path(ckpt), reqs["spmv"])
    left = sorted(n for n in os.listdir(queues["spmv"].dir)
                  if n.startswith(("work-", "lease-", "fail-", "poison-")))
    steps["drain_spmv"] = {
        "runner": "supervisor", "rc": r.returncode,
        "reason": sup.get("reason"),
        "supervisor": {k: sup.get(k) for k in (
            "counters", "members", "double_runs", "audit_complete",
            "completed_by", "queue_after", "cuda_initialized", "wall_s")},
        "status_written": os.path.exists(os.path.join(
            queues["spmv"].dir, "status-supervisor.json")),
        "summary": member_status.get("counters"), "left": left,
        "verified": verdict.get("verified"), "value_us": verdict.get("value"),
        "vs_baseline": verdict.get("vs_baseline"),
        "device": (verdict.get("device") or {}).get("name"),
        "records": len(st), "admitted_by_scored_rows": want_records,
        "devices": sorted({r["provenance"].get("device")
                           for r in st.records()}),
        "launches": verdict.get("launches"),
        # the member's own drain of the item (its status history), so the
        # supervisor's share of the step is the rest
        "item_wall_s": ((member_status.get("history") or [{}])[-1]
                        .get("wall_s")),
        "wall_s": round(time.time() - t0, 3)}
    restarts = sum(m.get("restarts", 0)
                   for m in (sup.get("members") or {}).values())
    if (r.returncode != 0 or sup.get("reason") != "drained" or restarts
            or sup.get("double_runs") != {} or sup.get("audit_complete")
            is not True or sup.get("cuda_initialized") is not False
            or sup.get("completed_by") != {exact: ["chip-smoke-spmv-0"]}
            or not steps["drain_spmv"]["status_written"]
            or (member_status.get("counters") or {}).get("completed") != 1
            or left or verdict.get("verified") is not True
            or len(st) != want_records
            or any(dv != card for dv in steps["drain_spmv"]["devices"])):
        raise AssertionError(f"serve drain spmv: {steps['drain_spmv']}")
    if not (verdict.get("launches") or {}).get("ell_spmv", 0) > 0:
        raise AssertionError(f"the spmv drain never launched ell_spmv: "
                             f"{steps['drain_spmv']}")

    # step 5: exact re-queries, each answer run on the card beside naive
    steps["exact"] = {}
    for name, req in reqs.items():
        svc = ScheduleService(stores[name], platform="cuda")
        if not len(svc.store):
            steps["exact"][name] = {"records": 0, "tier": None}
            continue
        t0 = time.perf_counter()
        res = svc.query(req)
        us = (time.perf_counter() - t0) * 1e6
        p = res.provenance
        row = {"tier": res.tier, "resolve_us": round(us, 1),
               "phase_us": res.phase_us, "records": len(svc.store),
               "key": res.record["key"] if res.record else None,
               "was_predicted": p.get("was_predicted"),
               "verified": p.get("verified"), "compiles": p.get("compiles"),
               "measurements": p.get("measurements"),
               "device": p.get("device"), "vs_naive": res.vs_naive,
               "pct50_us": res.pct50_us}
        if (res.tier != "exact" or p.get("was_predicted") is not False
                or p.get("verified") is not True or p.get("compiles") != 0
                or p.get("measurements") != 0 or p.get("device") != card):
            raise AssertionError(f"serve exact {name}: {row}")
        t0 = time.time()
        reset_launches()
        row.update(_serve_run(torch, device, name, res.record, req))
        row["wall_s"] = round(time.time() - t0, 3)
        steps["exact"][name] = row
    steps["dr"] = _serve_dr(serve_dir, stores, card)
    steps["listen"] = _serve_listen(serve_dir, stores["halo"], card,
                                    steps["exact"])
    # step 8: the schedules the listen loop answered, on the card beside
    # naive; the answers' own launches (the kernels line's launches_listen)
    # must be the kernels their menu slots pick, each launched
    t0 = time.time()
    answered = steps["listen"].pop("ops")
    run = steps["listen_run"] = {
        name: _serve_run(torch, device, name, {"ops": answered[name]},
                         reqs[name])
        for name in reqs}
    launches = {}
    for name in reqs:
        for k, v in run[name]["launches"].items():
            launches[k] = launches.get(k, 0) + v
    run["launches"] = launches
    run["wall_s"] = round(time.time() - t0, 3)
    watched = ("halo_pack", "halo_unpack", "device_copy", "ell_spmv")
    wrong = {name: run[name] for name in reqs
             if sorted(run[name]["kernel_ops"])
             != sorted(k for k in watched if run[name]["launches"].get(k))}
    missing = [k for k in ("halo_unpack", "device_copy", "ell_spmv")
               if not launches.get(k)]
    if wrong or missing:
        raise AssertionError(f"the listen loop's answers launched other "
                             f"kernels than their slots pick ({wrong}) or "
                             f"never launched {missing}: {run}")
    # step 9: the analysis of what steps 1-8 wrote, in one child that
    # never initializes CUDA
    spmv_ckpt = drain_checkpoint_of(items["spmv"][1], items["spmv"][0])
    spec = {
        "serve_dir": serve_dir,
        "bundles": [bundles["serve_child"], bundles["daemon_halo"],
                    bundles["daemon_spmv"],
                    os.path.join(spmv_ckpt, "trace", "trace.jsonl"),
                    os.path.join(serve_dir, "listen", "trace.jsonl")],
        "drained": {n: child["cold"][n]["trace_id"] for n in reqs},
        "halo_store": stores["halo"], "spmv_store": stores["spmv"],
        "spmv_queue": queues["spmv"].dir,
        "listen_queue": os.path.join(serve_dir, "listen", "queue"),
        "listen_record": steps["listen"]["record_dir"],
        "halo_db": halo_db, "spmv_db": drain_csv_path(spmv_ckpt),
        "report": os.path.join(OUT_DIR, "report.md"), **inputs}
    steps["obs"] = _serve_obs(serve_dir, spec, smi)
    result = {"phase": "serve", "card": smi, "steps": steps,
              "wall_s": round(time.time() - t_phase, 3)}
    emit(result)
    return result


def _serve_cli(serve_dir: str, *argv):
    """One ``python -m tenzing_tpu_torch.serve`` subcommand; returns its exit
    code and its JSON line (stderr appended to ``serve_dir/dr.err``)."""
    r = subprocess.run([sys.executable, "-m", "tenzing_tpu_torch.serve",
                        *argv], cwd=REPO, capture_output=True, text=True,
                       timeout=300)
    with open(os.path.join(serve_dir, "dr.err"), "a") as f:
        f.write(f"$ serve {' '.join(argv)}\n{r.stderr}")
    return r.returncode, _json_tail(r.stdout, f"serve {argv[0]}")


def _serve_dr(serve_dir: str, stores, card: str):
    """Step 6: merge, compact, back up, lose and restore the halo store
    directory through the CLI, then fsck it."""
    import shutil

    from tenzing_tpu_torch.serve.segments import record_digest
    from tenzing_tpu_torch.serve.store import open_store

    t_step = time.time()
    store = stores["halo"]
    walls = {}

    def cli(*argv):
        t0 = time.time()
        rc, doc = _serve_cli(serve_dir, *argv)
        walls[argv[0]] = round(time.time() - t0, 3)
        if rc != 0:
            raise AssertionError(f"serve {argv[0]} rc={rc}: {doc}")
        return doc

    n_halo = len(open_store(store))
    n_spmv = len(open_store(stores["spmv"]))
    merged = cli("merge", "--store", store, "--from", stores["spmv"])
    compact = cli("compact", "--store", store)
    recs = open_store(store).records()
    before = sorted(record_digest(r) for r in recs)
    backup = cli("backup", "--store", store, "--note", "chip smoke")
    lost = sorted(os.listdir(os.path.join(store, "segments")))
    shutil.rmtree(os.path.join(store, "segments"))
    os.unlink(os.path.join(store, "manifest.json"))
    restore = cli("restore", "--store", store)
    fsck = cli("fsck", "--store", store)
    after_recs = open_store(store).records()
    after = sorted(record_digest(r) for r in after_recs)
    devices = sorted({r["provenance"].get("device") for r in after_recs})
    out = {"records_halo": n_halo, "records_spmv": n_spmv,
           "merged": merged["merged"], "records_after_merge": merged["records"],
           "compact": {k: compact[k] for k in (
               "buckets_compacted", "segments_reclaimed", "orphans_adopted",
               "records", "skipped")},
           "backup": {k: backup[k] for k in ("n_files", "bytes",
                                            "captured")},
           "segments_lost": len(lost),
           "restore": {k: restore[k] for k in ("mode", "files_restored",
                                               "damaged_skipped")},
           "fsck": {k: fsck.get(k) for k in (
               "rc", "records", "segments", "checksum_failed",
               "orphan_segments", "missing_segments", "damaged_segments",
               "errors", "warnings")},
           "fsck_backups_ok": all(b["ok"] for b in fsck.get("backups", [])),
           "records": len(after), "digests_equal": after == before,
           "devices": devices, "wall_by_command_s": walls,
           "wall_s": round(time.time() - t_step, 3)}
    if (fsck["rc"] != 0 or fsck["checksum_failed"] or fsck["orphan_segments"]
            or fsck["missing_segments"] or not out["fsck_backups_ok"]
            or after != before or len(after) != n_halo + n_spmv
            or restore["mode"] != "verbatim" or devices != [card]):
        raise AssertionError(f"serve disaster recovery: {out}")
    return out


class _JsonLinesChild:
    """A child process spoken to in JSON lines over its stdin and stdout:
    :meth:`ask` writes requests and waits, with a timeout, for one response
    per request ``id``."""

    def __init__(self, cmd, err_path: str):
        import queue
        import threading

        self._err = open(err_path, "w")
        self.proc = subprocess.Popen(cmd, cwd=REPO, stdin=subprocess.PIPE,
                                     stdout=subprocess.PIPE, stderr=self._err,
                                     text=True, bufsize=1)
        self.lines = queue.Queue()
        threading.Thread(target=self._read, daemon=True).start()

    def _read(self):
        for line in self.proc.stdout:
            self.lines.put(line)
        self.lines.put(None)

    def _next(self, deadline: float):
        line = self.lines.get(timeout=max(0.1, deadline - time.time()))
        if line is None:
            raise AssertionError("the listen child exited early (see "
                                 f"{self._err.name})")
        return line

    def ask(self, docs, timeout: float = 120.0):
        for d in docs:
            self.proc.stdin.write(json.dumps(d) + "\n")
        self.proc.stdin.flush()
        deadline = time.time() + timeout
        got = {}
        while len(got) < len(docs):
            doc = json.loads(self._next(deadline))
            got[doc.get("id")] = doc
        return got

    def close(self, timeout: float = 120.0):
        """EOF on stdin; returns the exit code and the remaining lines."""
        self.proc.stdin.close()
        rc = self.proc.wait(timeout=timeout)
        rest = []
        while True:
            line = self.lines.get(timeout=30)
            if line is None:
                break
            rest.append(line)
        self._err.close()
        return rc, rest

    def kill(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait(timeout=30)


def _pct50_max(xs):
    xs = sorted(xs)
    return {"n": len(xs), "pct50_us": xs[(len(xs) - 1) // 2] if xs else None,
            "max_us": xs[-1] if xs else None}


def _serve_listen(serve_dir: str, store: str, card: str, exact_rows):
    """Step 7: ``serve listen`` on the restored store in a child that never
    initializes CUDA (module docstring).  Returns its row, with the
    answered schedules' ops under ``ops`` for step 8."""
    from tenzing_tpu_torch.obs.export import read_jsonl
    from tenzing_tpu_torch.serve.reqlog import read_request_log
    from tenzing_tpu_torch.serve.store import WorkQueue

    t_step = time.time()
    d = os.path.join(serve_dir, "listen")
    # the status document, its metric snapshots and the request log where
    # the loop keeps them by default, in the store's directory, so step 9's
    # report and alerts read them as part of the store
    paths = {"queue": os.path.join(d, "queue"),
             "record": os.path.join(store, "reqlog"),
             "status": os.path.join(store, "status-chip-smoke-listen.json"),
             "trace": os.path.join(d, "trace.jsonl")}
    os.makedirs(d)
    child = _JsonLinesChild(
        [sys.executable, os.path.abspath(__file__), "--listen-child", store,
         paths["queue"], paths["record"], paths["status"], paths["trace"]],
        os.path.join(d, "listen.err"))
    halo, spmv = SERVE_REQUESTS["halo"], SERVE_REQUESTS["spmv"]

    def q(rid, req):
        return {"op": "query", "id": rid, "request": dict(req)}

    def hits(m):
        return m["metrics"]["metrics"]["counters"].get("serve.fp_cache.hits",
                                                       0)

    admitted = 0
    try:
        got = child.ask([{"op": "ping", "id": "ping"},
                         {"op": "metrics", "id": "m0"}])
        got.update(child.ask([q("h1", halo)]))
        got.update(child.ask([{"op": "metrics", "id": "m1"}]))
        got.update(child.ask([q("h2", halo)]))
        got.update(child.ask([{"op": "metrics", "id": "m2"}]))
        got.update(child.ask([{"op": "batch", "id": "b",
                               "requests": [dict(halo), dict(spmv)]}]))
        got.update(child.ask([q("cold", SERVE_COLD)]))
        burst = [q(f"f{i}", (halo, spmv)[i % 2])
                 for i in range(2 * SERVE_BURST)]
        got.update(child.ask(burst))
        got.update(child.ask([{"op": "stats", "id": "s"},
                              {"op": "metrics", "id": "m3"}]))
        admitted = 2 + 2 + 1 + len(burst)
        rc, rest = child.close()
    finally:
        child.kill()
    tail = [json.loads(x) for x in rest if x.startswith("{")]
    summary, verdict = tail[-2], tail[-1]
    results = {"h1": got["h1"]["result"], "h2": got["h2"]["result"],
               "b_halo": got["b"]["results"][0],
               "b_spmv": got["b"]["results"][1],
               "cold": got["cold"]["result"]}
    bursts = [got[f"f{i}"]["result"] for i in range(2 * SERVE_BURST)]
    exact = [results[k] for k in ("h1", "h2", "b_halo", "b_spmv")] + bursts
    log = read_request_log(paths["record"])
    status = json.load(open(paths["status"]))
    trace = [r for r in read_jsonl(paths["trace"]) if r.get("kind") == "span"
             and r.get("name") == "serve.query"]
    # a batch's members share its trace id: a resolution is its trace id
    # and its exact digest
    fast_ids = {((r.get("attrs") or {}).get("trace_id"),
                 (r.get("attrs") or {}).get("exact")) for r in trace
                if (r.get("attrs") or {}).get("fast_path")}

    def is_fast(r):
        return (r["trace_id"], r["fingerprint"]["exact"]) in fast_ids

    walked = [r for r in exact if not is_fast(r)]
    fast = [r for r in exact if is_fast(r)]
    slo = got["m3"]["metrics"].get("slo") or {}
    queued = WorkQueue(paths["queue"]).items()
    row = {
        "pong": got["ping"].get("pong"),
        "tiers": {k: v["tier"] for k, v in results.items()},
        "burst_tiers": sorted({r["tier"] for r in bursts}),
        "h2_cache_hit": results["h2"]["provenance"].get("cache_hit"),
        "fp_cache_hits": [hits(got[m]) for m in ("m0", "m1", "m2", "m3")],
        "h2_fast_path": is_fast(results["h2"]),
        "h1_fast_path": is_fast(results["h1"]),
        "keys_as_step5": {
            "halo": results["h1"]["key"] == exact_rows["halo"]["key"],
            "spmv": results["b_spmv"]["key"] == exact_rows["spmv"].get(
                "key")},
        "devices": sorted({r["provenance"].get("device") for r in exact}),
        "cold_items": len(queued),
        # the first exact answer of each workload walks the store (and
        # builds its graph); the rest come from the fast path
        "resolve_us_walk": {"halo": results["h1"]["resolve_us"],
                            "spmv": results["b_spmv"]["resolve_us"]},
        "resolve_us_fast": {
            w: _pct50_max([r["resolve_us"] for r in fast
                           if r["fingerprint"]["workload"] == w])
            for w in ("halo", "spmv")},
        "resolve_us_cold": results["cold"]["resolve_us"],
        "walked": len(walked), "fast": len(fast),
        "stats_queue_depth": got["s"]["stats"].get("queue", {}).get("depth"),
        "slo": {k: slo.get(k) for k in ("histogram", "count", "pct99_us",
                                        "target_us", "baseline_pct99_us")},
        "rc": rc, "cuda_initialized": verdict.get("cuda_initialized"),
        "summary_counters": summary.get("counters"),
        "status_state": status.get("state"),
        "reqlog": {"records": len(log["records"]), "admitted": admitted,
                   "segments": log["segments"], "damaged": log["damaged"],
                   "checksum_failed": log["checksum_failed"]},
        "record_dir": paths["record"],
        "wall_s": round(time.time() - t_step, 3)}
    ok = (row["pong"] is True and verdict.get("child") == "listen"
          and rc == 0 and verdict.get("cuda_initialized") is False
          and all(row["tiers"][k] == "exact" for k in (
              "h1", "h2", "b_halo", "b_spmv"))
          and row["tiers"]["cold"] == "cold" and row["burst_tiers"] == [
              "exact"]
          and row["h2_cache_hit"] is True and row["h2_fast_path"]
          and not row["h1_fast_path"]
          and row["fp_cache_hits"][2] == row["fp_cache_hits"][1] + 1
          and all(row["keys_as_step5"].values()) and row["devices"] == [card]
          and row["cold_items"] == 1 and os.path.exists(
              results["cold"]["work_item"])
          and slo.get("count", 0) >= len(exact)
          and slo.get("pct99_us") is not None
          and row["status_state"] == "stopped"
          and row["reqlog"]["records"] == admitted
          and not row["reqlog"]["checksum_failed"]
          and not row["reqlog"]["damaged"])
    if not ok:
        raise AssertionError(f"serve listen: {row}")
    row["ops"] = {"halo": results["h1"]["ops"],
                  "spmv": results["b_spmv"]["ops"]}
    return row


def listen_child(store: str, queue: str, record: str, status: str,
                 trace: str) -> int:
    """``chip_smoke.py --listen-child STORE QUEUE RECORD STATUS TRACE``: step
    7's ``serve listen --platform cuda`` (the CLI's ``main``) over this
    process's stdin and stdout, in a process that never touches the card.
    After EOF it prints one JSON line: whether CUDA was initialized."""
    import torch

    sys.path.insert(0, REPO)
    from tenzing_tpu_torch.serve import __main__ as serve_cli

    rc = serve_cli.main([
        "listen", "--store", store, "--queue", queue, "--platform", "cuda",
        "--workers", "1", "--owner", "chip-smoke-listen", "--status", status,
        "--record", record, "--trace-out", trace])
    print(json.dumps({"child": "listen", "rc": rc,
                      "cuda_initialized": torch.cuda.is_initialized()}),
          flush=True)
    return rc


# the report sections step 9 gives inputs for, each of which must be present
SERVE_REPORT_SECTIONS = (
    "## Recorded search databases", "## Driver verdicts",
    "### Device, reported schedule and result gate", "## Telemetry bundles",
    "## Metrics", "## Schedule-serving stores", "#### segments",
    "- service `chip-smoke-listen`", "- request log", "### work queue",
    "## Causal analysis")
# the rules that must not fire on step 9's tree: the listen loop stopped,
# nothing was poisoned, the store stayed writable and fsck found no damage
SERVE_QUIET_RULES = ("stale_heartbeat", "poison", "store_unwritable",
                     "store_damage_rate")


def obs_child(spec_path: str) -> int:
    """``chip_smoke.py --obs-child SPEC``: step 9 of the serve phase in a
    process that never touches the card, each tool through its CLI's
    ``main``: (1) ``obs.export`` stitches the bundles SPEC names and
    ``obs.causal`` analyzes them; (2) ``obs.alerts check`` on the restored
    halo directory and the listen loop's queue, then again with
    ``--set queue_age.max_s=0``, and the ledger loaded as an ``AlertBook``;
    (3) ``obs.report`` over the halo driver phase's database, verdict,
    trace and metrics, the spmv drain's database, both stores, the listen
    queue and the bundles; (4) ``obs.report --check`` of that verdict
    against itself and of the learn phase's screened verdict against it;
    (5) ``serve.replay --platform cuda --from-recorded`` of the listen
    loop's request log, and ``--check`` of its document against itself;
    (6) one ``obs.report --follow`` render of step 4's queue (the
    supervisor's status block and its member) and ``obs.alerts check`` over
    it.  Prints one JSON line of what each returned, for the parent to
    check."""
    import io
    import re

    import torch

    sys.path.insert(0, REPO)
    from tenzing_tpu_torch.obs import alerts, causal, export, report
    from tenzing_tpu_torch.serve import replay
    from tenzing_tpu_torch.serve.reqlog import read_request_log

    with open(spec_path) as f:
        spec = json.load(f)
    sd = spec["serve_dir"]
    walls = {}

    def cli(name, fn, argv):
        buf = io.StringIO()
        t0 = time.time()
        with contextlib.redirect_stdout(buf):
            rc = fn(argv)
        walls[name] = round(time.time() - t0, 3)
        return rc, buf.getvalue()

    def last_json(text):
        return json.loads(text.strip().splitlines()[-1])

    def check(name, fresh, baseline, tol):
        rc, text = cli(name, report.main, ["--check", fresh, "--baseline",
                                           baseline, "--tol", str(tol)])
        m = re.search(r"\*\*verdict: (\w+)\*\*", text)
        return {"rc": rc, "verdict": m.group(1) if m else None,
                "reasons": [ln[4:] for ln in text.splitlines()
                            if ln.startswith("  - ")]}

    t_all = time.time()
    out = {"child": "obs"}
    # (1) the bundles stitched, and the causal chain of each drained item
    stitched = os.path.join(sd, "stitched.json")
    rc, text = cli("export", export.main,
                   [*spec["bundles"], "--out", stitched])
    summary = last_json(text)
    causal_path = os.path.join(sd, "causal.json")
    rc_c, _ = cli("causal", causal.main,
                  [*spec["bundles"], "--out", causal_path])
    with open(causal_path) as f:
        cdoc = json.load(f)
    out["stitch"] = {"rc": rc, "bundles": summary["bundles"],
                     "records": summary["records"],
                     "traces": len(summary["traces"])}
    out["causal"] = {"rc": rc_c, "n_traces": cdoc["n_traces"],
                     "pct99_ranking": cdoc["aggregate"].get("pct99_ranking")}
    out["drained"] = {}
    for name, tid in spec["drained"].items():
        st = summary["traces"].get(tid) or {}
        t = cdoc["traces"].get(tid) or {}
        segs = t.get("segments_us") or {}
        out["drained"][name] = {
            "trace_id": tid, "processes": st.get("processes"),
            "n_processes": st.get("n_processes", 0),
            "error": t.get("error"), "tier": t.get("tier"),
            "servable": t.get("servable"), "window_us": t.get("window_us"),
            "segments_us": segs, "unattributed_us": t.get("unattributed_us"),
            "queue_wait_us": t.get("queue_wait_us"),
            "coverage": t.get("coverage"),
            "sum_minus_window_us": (
                round(sum(segs.values()) + t["unattributed_us"]
                      - t["window_us"], 3) if "window_us" in t else None)}
    # (2) the alert rules over the restored store and the listen queue
    state = os.path.join(sd, "alerts.json")
    base = ["check", "--store", spec["halo_store"], "--queue-dir",
            spec["listen_queue"], "--state", state]
    rc, text = cli("alerts", alerts.main, base)
    out["alerts"] = {"rc": rc, "firing": last_json(text)["firing"]}
    rc, text = cli("alerts_queue_age", alerts.main,
                   base + ["--set", "queue_age.max_s=0"])
    book = alerts.AlertBook(state).load()
    out["alerts_queue_age"] = {
        "rc": rc, "firing": last_json(text)["firing"],
        "ledger_firing": book.get("firing"),
        "ledger_alerts": len(book.get("alerts") or {})}
    # (3) the report over everything the card's runs wrote
    rc, _ = cli("report", report.main, [
        "--csv", spec["halo_db"], spec["spmv_db"],
        "--bench", spec["halo_verdict"], "--trace", spec["halo_trace"],
        "--metrics", spec["halo_metrics"],
        "--store", spec["halo_store"], spec["spmv_store"],
        "--queue-dir", spec["listen_queue"], "--causal", *spec["bundles"],
        "--out", spec["report"]])
    with open(spec["report"]) as f:
        md = f.read()
    out["report"] = {"rc": rc, "lines": len(md.splitlines()),
                     "missing": [h for h in SERVE_REPORT_SECTIONS
                                 if h not in md]}
    # (4) the regression check, of the main path's verdict against itself
    # and of the screened search's against it
    out["check_self"] = check("check_self", spec["halo_verdict"],
                              spec["halo_verdict"], 0.05)
    out["check_learn"] = check("check_learn", spec["learn_verdict"],
                               spec["halo_verdict"], 0.25)
    # (5) the listen loop's recorded traffic replayed
    replay_path = os.path.join(sd, "replay.json")
    replay_log = os.path.join(sd, "replay_reqlog")
    rc, _ = cli("replay", replay.main, [
        "--platform", "cuda", "--from-recorded", spec["listen_record"],
        "--halo-csv", spec["halo_db"], "--spmv-csv", spec["spmv_db"],
        "--noise-samples", "64", "--record", replay_log,
        "--out", replay_path])
    with open(replay_path) as f:
        doc = json.load(f)

    def by_workload(directory):
        """Each query record's tier (its outcome where it has none), by
        the request's workload."""
        out = {}
        for r in read_request_log(directory)["records"]:
            if r.get("op") in ("query", "batch"):
                wl = r.get("workload") or (r.get("request") or {}).get(
                    "workload", "halo")
                out.setdefault(wl, []).append(r.get("tier")
                                              or r.get("outcome"))
        return out

    recorded_tiers = by_workload(spec["listen_record"])
    halo_recorded = len(recorded_tiers.get("halo", []))
    # the segmented path's own record of what it served: each replayed
    # request's tier, so the halo requests are held to exact one by one
    replayed_tiers = by_workload(replay_log)

    def tiers(path):
        return {t: {k: v[k] for k in ("count", "pct50_us", "pct99_us")}
                for t, v in doc[path]["resolve_us"].items()}

    hn = doc.get("host_noise") or {}
    out["replay"] = {
        "rc": rc, "platform": doc.get("platform"),
        "host_noise": bool(hn), "halo_recorded": halo_recorded,
        "replayed_tiers": replayed_tiers,
        "n": doc.get("n"), "qps": doc.get("qps"),
        "pacing": doc.get("pacing", {}).get("source"),
        "monolithic": tiers("monolithic"), "segmented": tiers("segmented"),
        "verifier_calls": {p: doc[p]["verifier_calls"]
                           for p in ("monolithic", "segmented")},
        "shed": doc["segmented"]["shed"],
        "timeouts": doc["segmented"]["timeouts"],
        "qps_effective": doc["segmented"]["qps_effective"],
        "exact_pct99_speedup": doc.get("exact_pct99_speedup"),
        "floors_us": {k: {q: (hn.get(k) or {}).get(q)
                          for q in ("p50_us", "p99_us", "iid")}
                      for k in ("timer_wake_us", "hot_spin_us")}}
    out["check_replay"] = check("check_replay", replay_path, replay_path,
                                0.25)
    # (6) step 4's supervisor: the report's fleet view of its status block
    # (one --follow render) and the alert rules over its queue
    rc, text = cli("fleet", report.main, [
        "--follow", "--max-ticks", "1", "--interval", "0",
        "--queue-dir", spec["spmv_queue"]])
    out["fleet"] = {"rc": rc, "lines": [
        ln for ln in text.splitlines()
        if ln.startswith("superv ") or ln.strip().startswith(
            ("member ", "breaker "))]}
    rc, text = cli("alerts_fleet", alerts.main, [
        "check", "--store", os.path.dirname(spec["spmv_store"]),
        "--queue-dir", spec["spmv_queue"],
        "--state", os.path.join(sd, "alerts_fleet.json")])
    out["alerts_fleet"] = {"rc": rc, "firing": sorted(
        {f["rule"] for f in last_json(text)["firing"]})}
    out["walls_s"] = walls
    out["wall_s"] = round(time.time() - t_all, 3)
    out["cuda_initialized"] = torch.cuda.is_initialized()
    print(json.dumps(out), flush=True)
    return 0


def _serve_obs(serve_dir: str, spec, smi):
    """Step 9: ``--obs-child`` over what steps 1-8 wrote (module
    docstring), checked here.  Returns its row."""
    t0 = time.time()
    spec_path = os.path.join(serve_dir, "obs_spec.json")
    with open(spec_path, "w") as f:
        json.dump(spec, f, indent=1)
    r = subprocess.run([sys.executable, os.path.abspath(__file__),
                        "--obs-child", spec_path], capture_output=True,
                       text=True, timeout=300)
    with open(os.path.join(serve_dir, "obs.err"), "w") as f:
        f.write(r.stderr)
    if r.returncode != 0:
        raise AssertionError(f"obs child rc={r.returncode}: "
                             f"{r.stderr[-2000:]}")
    row = _json_tail(r.stdout, "obs child")
    row["card"] = smi
    row["step_wall_s"] = round(time.time() - t0, 3)
    bad = []
    if row["cuda_initialized"]:
        bad.append("the analysis initialized CUDA")
    if row["stitch"]["rc"] != 0 or row["causal"]["rc"] != 0:
        bad.append("stitch or causal exited non-zero")
    for name, t in row["drained"].items():
        segs = t["segments_us"]
        if (t["error"] or t["n_processes"] < 2
                or any(segs.get(k, 0) <= 0 for k in (
                    "search", "measure", "merge"))
                or t["sum_minus_window_us"] is None
                or abs(t["sum_minus_window_us"]) > 1.0):
            bad.append(f"the {name} drain's trace: {t}")
    a, q = row["alerts"], row["alerts_queue_age"]
    rules = sorted({f["rule"] for f in a["firing"]})
    if (a["rc"] != (1 if a["firing"] else 0)
            or set(rules) & set(SERVE_QUIET_RULES)):
        bad.append(f"alerts on the restored tree: {a}")
    if (q["rc"] != 1 or not any(f["rule"] == "queue_age"
                                for f in q["firing"])
            or not any(k.startswith("queue_age:")
                       for k in q["ledger_firing"] or [])):
        bad.append(f"alerts with queue_age.max_s=0: {q}")
    if row["report"]["rc"] != 0 or row["report"]["missing"]:
        bad.append(f"report: {row['report']}")
    if row["check_self"] != {"rc": 0, "verdict": "ok", "reasons": []}:
        bad.append(f"the verdict checked against itself: {row['check_self']}")
    if row["check_learn"]["rc"] == 2 or row["check_learn"]["verdict"] is None:
        bad.append(f"the screened verdict's check: {row['check_learn']}")
    rp = row["replay"]
    exact = rp["segmented"].get("exact") or {}
    if (rp["rc"] != 0 or rp["platform"] != "cuda" or not rp["host_noise"]
            or rp["verifier_calls"]["segmented"] != 0
            or exact.get("count", 0) < rp["halo_recorded"]
            or rp["halo_recorded"] < 1
            or rp["replayed_tiers"].get("halo", []) != ["exact"]
            * rp["halo_recorded"]):
        bad.append(f"replay: {rp}")
    if row["check_replay"] != {"rc": 0, "verdict": "ok", "reasons": []}:
        bad.append(f"the replay checked against itself: "
                   f"{row['check_replay']}")
    fl = row["fleet"]["lines"]
    if (row["fleet"]["rc"] != 0
            or not any(ln.startswith("superv chip-smoke-supervisor: stopped")
                       for ln in fl)
            or not any("member chip-smoke-spmv-0" in ln for ln in fl)
            or any(ln.strip().startswith("breaker ") for ln in fl)):
        bad.append(f"the supervisor's fleet lines: {row['fleet']}")
    af = row["alerts_fleet"]
    if (af["rc"] != (1 if af["firing"] else 0)
            or "supervisor_crash_loop" in af["firing"]):
        bad.append(f"alerts on the supervisor's queue: {af}")
    emit({"phase": "serve_obs", "card": smi, "wall_s": row["wall_s"],
          "step_wall_s": row["step_wall_s"],
          "drained": {n: {k: t[k] for k in (
              "n_processes", "window_us", "segments_us", "unattributed_us",
              "queue_wait_us", "coverage")}
              for n, t in row["drained"].items()},
          "alerts": rules, "alerts_queue_age": sorted(
              {f["rule"] for f in q["firing"]}),
          "check_learn": row["check_learn"],
          "replay": {p: {t: {k: v[k] for k in ("pct50_us", "pct99_us")}
                         for t, v in rp[p].items()}
                     for p in ("monolithic", "segmented")},
          "replayed_tiers": {w: {t: ts.count(t) for t in sorted(set(ts))}
                             for w, ts in rp["replayed_tiers"].items()},
          "floors_us": rp["floors_us"], "fleet_lines": fl,
          "alerts_fleet": af["firing"]})
    if bad:
        raise AssertionError("serve step 9: " + "; ".join(bad))
    return row


# -- the fault phase ---------------------------------------------------------------

# the spmv search at m=8192 (ell_spmv on its menu), run by each step
FAULT_CMD = ["-m", "tenzing_tpu_torch.bench", "--workload", "spmv",
             "--m", "8192", "--mcts-iters", "12", "--iters", "3",
             "--search-iters", "2"]
FAULT_SPEC = "transient:0.2:1,hang:0.1:2,deterministic:0.1:3,corrupt:0.1:4"
# the chaos step searches longer: the identity-keyed kinds (deterministic,
# corrupt) fire on a rate 0.1 of the distinct candidates, and 12 MCTS
# iterations reach about 14 of them (no fault at all in 0.9^14 = 23% of runs)
FAULT_CHAOS_ITERS = 48
# T: the watchdog's slack beyond each measurement's own floor (T per
# schedule in a batch; bench/benchmarker.py measurement_floor_s), a few times
# the slowest measurement's capture, warm-up and fence.  H > T: an injected
# hang outlasts it
FAULT_TIMEOUT_S = 4.0
FAULT_HANG_S = 6.0
FAULT_KILL_LINES = 5  # step 3 sends SIGINT once the journal holds this many
STICKY_AT = 4  # step 4: the k-th measurement triggers the device-side assert


def _run_bench(args, name, fault_dir, popen=False):
    """Run the driver CLI with ``args`` in a fresh process (stderr to
    ``fault_dir/name.err``); returns the completed process, or the Popen."""
    cmd = [sys.executable, *FAULT_CMD, *args]
    err = open(os.path.join(fault_dir, f"{name}.err"), "w")
    if popen:
        return subprocess.Popen(cmd, cwd=REPO, stdout=subprocess.PIPE,
                                stderr=err, text=True)
    try:
        return subprocess.run(cmd, cwd=REPO, stdout=subprocess.PIPE,
                              stderr=err, text=True, timeout=900)
    finally:
        err.close()


def _json_tail(text: str, what: str):
    lines = [ln for ln in text.strip().splitlines() if ln.startswith("{")]
    if not lines:
        raise AssertionError(f"{what}: no JSON line in its output")
    return json.loads(lines[-1])


def _journal(ckdir: str):
    """(measured rows as (schedule id, opts key), all lines) of a journal,
    read through the package against the m=8192 spmv graph."""
    from tenzing_tpu_torch.bench import driver
    from tenzing_tpu_torch.bench.benchmarker import schedule_id
    from tenzing_tpu_torch.fault import SearchCheckpoint

    g = driver.build_spmv(driver.DriverRequest(workload="spmv", m=8192),
                          "cpu")[0]
    ck = SearchCheckpoint(ckdir)
    with open(ck.journal_path) as f:
        n_lines = sum(1 for ln in f if ln.strip())
    rows = [(schedule_id(seq), None if o is None else
             (o.n_iters, o.max_retries, o.target_secs))
            for seq, o, _, prov in ck.load_measurements(g)
            if prov == "measured"]
    return rows, n_lines


def _restored(err_path: str) -> int:
    with open(err_path) as f:
        for ln in f:
            if ln.startswith("resume: "):
                return int(ln.split()[1])
    raise AssertionError(f"{err_path}: no resume line")


def fault_chaos_and_resume(fault_dir: str) -> dict:
    """Steps 1 and 2: the chaos run, then its --resume."""
    from tenzing_tpu_torch.fault import Quarantine

    d1 = os.path.join(fault_dir, "d1")
    chaos = ["--checkpoint", d1, "--inject-faults", FAULT_SPEC,
             "--measure-timeout", str(FAULT_TIMEOUT_S),
             "--inject-hang-secs", str(FAULT_HANG_S)]
    t0 = time.time()
    p = _run_bench(chaos + ["--mcts-iters", str(FAULT_CHAOS_ITERS)], "chaos",
                   fault_dir)
    chaos_s = time.time() - t0
    if p.returncode != 0:
        raise AssertionError(f"fault chaos run failed (rc {p.returncode}); "
                             f"see {fault_dir}/chaos.err")
    v = _json_tail(p.stdout, "fault chaos run")
    fault = v.get("fault") or {}
    injected = fault.get("injected", {})
    rows, n_lines = _journal(d1)
    quarantined = set(Quarantine(os.path.join(d1, "quarantine.json")).entries)
    out = {"chaos": {"verified": v.get("verified"), "value": v.get("value"),
                     "winner_label": v.get("winner_label"),
                     "reported_schedule": v.get("reported_schedule"),
                     "fault": fault, "journal_lines": n_lines,
                     "measured_rows": len(rows),
                     "quarantined": len(quarantined),
                     "wall_s": round(chaos_s, 3)}}
    if v.get("verified") is not True:
        raise AssertionError(f"fault chaos run not verified: {v}")
    missing = [k for k in ("transient", "deterministic", "corrupt")
               if injected.get(k, 0) <= 0]
    if missing or fault.get("quarantined", 0) < 1:
        raise AssertionError(f"fault chaos run injected no {missing} or "
                             f"quarantined nothing: {fault}")
    leaked = {sid for sid, _ in rows} & quarantined
    if leaked:
        raise AssertionError(f"quarantined (mutated or broken) schedules "
                             f"among the journal's measured rows: {leaked}")

    t0 = time.time()
    p = _run_bench(chaos + ["--mcts-iters", str(FAULT_CHAOS_ITERS),
                            "--resume"], "resume_finished", fault_dir)
    resume_s = time.time() - t0
    if p.returncode != 0:
        raise AssertionError(f"fault resume of a finished run failed (rc "
                             f"{p.returncode}); see {fault_dir}/"
                             "resume_finished.err")
    r = _json_tail(p.stdout, "fault resume of a finished run")
    rows2, n_lines2 = _journal(d1)
    restored = _restored(os.path.join(fault_dir, "resume_finished.err"))
    out["resume_finished"] = {
        "resumed": (r.get("fault") or {}).get("resumed"),
        "restored": restored, "measured_rows_after": len(rows2),
        "journal_lines_after": n_lines2, "value": r.get("value"),
        "reported_schedule": r.get("reported_schedule"),
        "verified": r.get("verified"), "wall_s": round(resume_s, 3)}
    if (r.get("fault") or {}).get("resumed") is not True:
        raise AssertionError(f"the resume did not report resumed: {r}")
    if restored != len(rows) or len(rows2) != len(rows):
        raise AssertionError(f"resume restored {restored} of {len(rows)} "
                             f"journaled rows and left {len(rows2)}")
    for key in ("value", "vs_baseline", "reported_schedule", "winner_label",
                "naive_us"):
        if r.get(key) != v.get(key):
            raise AssertionError(f"the resumed run reports {key} "
                                 f"{r.get(key)!r}, the run {v.get(key)!r}")
    return out


def fault_kill_and_resume(fault_dir: str) -> dict:
    """Step 3: SIGINT a clean checkpointed run, then resume it."""
    import signal

    from tenzing_tpu_torch.fault import read_checked_json

    d2 = os.path.join(fault_dir, "d2")
    journal = os.path.join(d2, "measurements.jsonl")
    t0 = time.time()
    p = _run_bench(["--checkpoint", d2], "killed", fault_dir, popen=True)
    lines = 0
    while p.poll() is None and time.time() - t0 < 600:
        if os.path.exists(journal):
            with open(journal) as f:
                lines = sum(1 for ln in f if ln.endswith("\n"))
            if lines >= FAULT_KILL_LINES:
                break
        time.sleep(0.05)
    if p.poll() is not None:
        raise AssertionError(f"the run to kill ended first (rc "
                             f"{p.returncode}, {lines} journal lines)")
    p.send_signal(signal.SIGINT)
    p.communicate(timeout=120)
    kill_s = time.time() - t0
    state = read_checked_json(os.path.join(d2, "state.json"))
    before, n_before = _journal(d2)
    out = {"killed": {"rc": p.returncode, "lines_at_signal": lines,
                      "journal_lines": n_before, "measured_rows": len(before),
                      "interrupted": state.get("interrupted"),
                      "wall_s": round(kill_s, 3)}}
    if state.get("interrupted") is not True:
        raise AssertionError(f"state.json after SIGINT: {state}")
    t0 = time.time()
    r = _run_bench(["--checkpoint", d2, "--resume"], "resume_killed",
                   fault_dir)
    if r.returncode != 0:
        raise AssertionError(f"the resume after the kill failed (rc "
                             f"{r.returncode}); see {fault_dir}/"
                             "resume_killed.err")
    v = _json_tail(r.stdout, "resume after the kill")
    after, n_after = _journal(d2)
    again = set(after[len(before):]) & set(before)
    out["resume_killed"] = {
        "verified": v.get("verified"), "resumed": (v.get("fault") or {}).get(
            "resumed"), "restored": _restored(os.path.join(
                fault_dir, "resume_killed.err")),
        "new_measured_rows": len(after) - len(before),
        "remeasured": len(again),
        "failures": (v.get("fault") or {}).get("failures"),
        "wall_s": round(time.time() - t0, 3)}
    # no fault was injected: no measurement of either run may have failed
    if (v.get("verified") is not True or again
            or out["resume_killed"]["failures"]):
        raise AssertionError(f"the resume after the kill: {out}")
    return out


class StickyAt:
    """Test-only: wraps an inner benchmarker and, at its ``k``-th
    measurement, indexes a CUDA tensor out of range — a device-side assert,
    the sticky error that leaves the process's context unusable.  Records
    the (schedule id, opts) of each measurement it passes on."""

    def __init__(self, inner, k: int, device):
        self.inner = inner
        self.k = k
        self.device = device
        self.calls = 0
        self.measured = []

    def benchmark(self, order, opts=None):
        import torch

        from tenzing_tpu_torch.bench.benchmarker import schedule_id

        self.calls += 1
        if self.calls == self.k:
            x = torch.zeros(4, device=self.device)
            idx = torch.full((1,), 1 << 20, dtype=torch.long,
                             device=self.device)
            x[idx].sum().item()
        res = self.inner.benchmark(order, opts)
        self.measured.append([schedule_id(order), None if opts is None else
                              [opts.n_iters, opts.max_retries,
                               opts.target_secs]])
        return res


def sticky_child(ckdir: str, k: int) -> int:
    """``chip_smoke.py --sticky-child DIR K``: a checkpointed MCTS of the
    m=8192 spmv search through the library, the inner benchmarker wrapped
    in :class:`StickyAt` (K = 0: never), resuming from DIR's journal.
    Prints one JSON line; exits 3 naming the error class when the search
    raises."""
    import torch

    sys.path.insert(0, REPO)
    from tenzing_tpu_torch.bench import driver
    from tenzing_tpu_torch.bench.benchmarker import (
        BenchOpts,
        CachingBenchmarker,
        EmpiricalBenchmarker,
    )
    from tenzing_tpu_torch.core.platform import Platform
    from tenzing_tpu_torch.fault import (
        JournalingBenchmarker,
        Quarantine,
        ResilientBenchmarker,
        SearchCheckpoint,
    )
    from tenzing_tpu_torch.runtime.executor import StreamExecutor
    from tenzing_tpu_torch.runtime.graphs import device_sync
    from tenzing_tpu_torch.solve.local import first_decision_order
    from tenzing_tpu_torch.solve.mcts import MctsOpts, explore

    dev = torch.device("cuda", 0)
    g, bufs, _, _ = driver.build_spmv(
        driver.DriverRequest(workload="spmv", m=8192), dev)
    plat = Platform.make_n_lanes(2)
    ex = StreamExecutor(plat, bufs, device=str(dev))
    inner = StickyAt(EmpiricalBenchmarker(ex), k, dev)
    ckpt = SearchCheckpoint(ckdir)
    bench = CachingBenchmarker(JournalingBenchmarker(ResilientBenchmarker(
        inner, quarantine=Quarantine(ckpt.quarantine_path),
        quiesce=lambda: device_sync(dev)), ckpt))
    restored = ckpt.restore_into(bench, g)
    opts = BenchOpts(n_iters=3, max_retries=2, target_secs=0.01)
    reset_launches()
    out = {"child": "sticky", "k": k, "restored": restored}
    try:
        # the ell_spmv walk first (the driver's spmv incumbent), then MCTS
        bench.benchmark(first_decision_order(g, plat, ".pallas"), opts)
        res = explore(g, plat, bench, MctsOpts(n_iters=8, bench_opts=opts,
                                               seed=0, checkpoint=ckpt))
    except Exception as e:  # reported, then the process ends
        out.update(error=type(e).__name__,
                   cause=type(e.__cause__).__name__ if e.__cause__ else None,
                   message=str(e)[:300], measured=inner.measured,
                   launches={"ell_spmv": all_launches()["ell_spmv"]})
        print(json.dumps(out), flush=True)
        os._exit(3)  # no exit handler may touch the broken context
    out.update(ok=True, sims=len(res.sims), measured=inner.measured,
               launches={"ell_spmv": all_launches()["ell_spmv"]})
    print(json.dumps(out), flush=True)
    return 0


def fault_sticky(fault_dir: str) -> dict:
    """Step 4: a real sticky error in a child, then a child that resumes."""
    d3 = os.path.join(fault_dir, "d3")
    runs, rows = {}, None
    for name, k in (("sticky", STICKY_AT), ("sticky_resume", 0)):
        if k == 0:  # the journal the failed child left, before the resume
            rows, _ = _journal(d3)
        t0 = time.time()
        with open(os.path.join(fault_dir, f"{name}.err"), "w") as err:
            p = subprocess.run([sys.executable, os.path.join(REPO,
                                                             "chip_smoke.py"),
                                "--sticky-child", d3, str(k)], cwd=REPO,
                               stdout=subprocess.PIPE, stderr=err, text=True,
                               timeout=600)
        with open(os.path.join(fault_dir, f"{name}.out"), "w") as f:
            f.write(p.stdout)
        runs[name] = (p.returncode, _json_tail(p.stdout, name),
                      round(time.time() - t0, 3))
    (rc1, c1, s1), (rc2, c2, s2) = runs["sticky"], runs["sticky_resume"]

    def key(m):  # (schedule id, opts) as the journal reader gives them
        return (m[0], tuple(m[1]) if m[1] is not None else None)

    journaled = [key(m) for m in c1.get("measured", [])]
    remeasured = {key(m) for m in c2.get("measured", [])} & set(journaled)
    out = {"sticky": {"rc": rc1, "error": c1.get("error"),
                      "cause": c1.get("cause"), "k": STICKY_AT,
                      "journaled_rows": len(rows),
                      "ell_spmv_launches": c1.get("launches", {}).get(
                          "ell_spmv"), "wall_s": s1},
           "sticky_resume": {"rc": rc2, "ok": c2.get("ok"),
                             "restored": c2.get("restored"),
                             "measured": len(c2.get("measured", [])),
                             "remeasured": len(remeasured), "wall_s": s2}}
    if rc1 == 0 or c1.get("error") != "DeviceLostError" \
            or "device-side assert" not in c1.get("message", ""):
        raise AssertionError(f"the sticky child: {c1}")
    if len(rows) != STICKY_AT - 1 or sorted(rows) != sorted(journaled):
        raise AssertionError(f"the sticky child journaled {len(rows)} rows, "
                             f"want {STICKY_AT - 1}: {c1}")
    if (c1.get("launches") or {}).get("ell_spmv", 0) <= 0:
        raise AssertionError(f"the sticky child never launched ell_spmv: {c1}")
    if rc2 != 0 or not c2.get("ok") or c2.get("restored") != STICKY_AT - 1 \
            or remeasured:
        raise AssertionError(f"the resuming child: {c2}")
    return out


FSCHAOS_SEED = 777  # step 5: the hostile-filesystem drill's seed


def fault_fschaos(fault_dir: str, card: str) -> dict:
    """Step 5: ``python -m tenzing_tpu_torch.fault.fschaos --quick --device
    cuda``: one fleet run of the supervisor and two members draining one
    halo smoke item on the card under the seeded fsinject spec, a member's
    process group SIGKILLed mid-drain, then the ``store_unwritable``
    drill."""
    work = os.path.join(fault_dir, "fschaos")
    t0 = time.time()
    with open(os.path.join(fault_dir, "fschaos.err"), "w") as err:
        p = subprocess.run([sys.executable, "-m",
                            "tenzing_tpu_torch.fault.fschaos", "--workdir",
                            work, "--quick", "--device", "cuda", "--seed",
                            str(FSCHAOS_SEED)],
                           cwd=REPO, stdout=subprocess.PIPE, stderr=err,
                           text=True, timeout=600)
    v = _json_tail(p.stdout, "fschaos")
    run = (v.get("runs") or [{}])[0]
    drains = run.get("drains") or {}
    records = run.get("records") or {}
    counters = (run.get("summary") or {}).get("counters") or {}
    out = {"fschaos": {
        "rc": p.returncode, "seed": FSCHAOS_SEED,
        "workload": v.get("workload"),
        "invariants": v.get("invariants"), "ok": v.get("ok"),
        "violations": run.get("violations"),
        "member_sigkilled": run.get("member_sigkilled"),
        "restarts": counters.get("restarts", 0), "counters": counters,
        "records": records, "devices": run.get("devices"),
        "probe": {k: (run.get("probe") or {}).get(k)
                  for k in ("probes", "degraded")},
        "fault_evidence": run.get("fault_evidence"),
        "drill": {k: (v.get("drill") or {}).get(k) for k in (
            "fired", "resolved", "probe_write_denials")},
        "drains": drains, "wall_s": round(time.time() - t0, 3)}}
    # every fingerprint holds a record the drain acknowledged, every stored
    # record names the card, and so does the drain's verdict (the halo smoke
    # runs no kernel slot: its launches are printed, not required)
    if (p.returncode != 0 or v.get("device") != "cuda"
            or v.get("workload") != "halo"
            or not all((v.get("invariants") or {}).values())
            or not run.get("member_sigkilled") or counters.get(
                "restarts", 0) < 1 or not drains or not records
            or any(r.get("stored", 0) < max(1, r.get("acknowledged", 0))
                   for r in records.values())
            or run.get("devices") != [card]
            or any(d.get("device") != card for d in drains.values())):
        raise AssertionError(f"the fschaos drill: {out['fschaos']}")
    return out


def phase_fault(torch) -> dict:
    """The fault phase (module docstring): steps 1-2, 3, 4 and 5 as four
    chains of fresh processes, side by side."""
    import shutil
    import threading

    torch.cuda.empty_cache()
    fault_dir = os.path.join(OUT_DIR, "fault")
    shutil.rmtree(fault_dir, ignore_errors=True)
    os.makedirs(fault_dir)
    t0 = time.time()
    results, errors = {}, {}

    def chain(name, fn):
        try:
            results.update(fn(fault_dir))
        except BaseException as e:  # noqa: BLE001 — re-raised below
            errors[name] = e

    card = torch.cuda.get_device_name(0)
    threads = [threading.Thread(target=chain, args=(n, f), name=n)
               for n, f in (("chaos", fault_chaos_and_resume),
                            ("kill", fault_kill_and_resume),
                            ("sticky", fault_sticky),
                            ("fschaos", lambda d: fault_fschaos(d, card)))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    row = {"phase": "fault", **results, "errors": {
        k: f"{type(e).__name__}: {e}"[:500] for k, e in errors.items()},
        "timeout_s": FAULT_TIMEOUT_S, "hang_s": FAULT_HANG_S,
        "wall_s": round(time.time() - t0, 3)}
    emit(row)
    if errors:
        raise next(iter(errors.values()))
    return row


def main() -> int:
    global _log
    import torch

    if not torch.cuda.is_available():
        sys.stderr.write("chip_smoke: no CUDA device available\n")
        return 2
    sys.path.insert(0, REPO)
    global F32_O_TOL, BF16_O_TOL, F32_Y_TOL, BF16_Y_TOL, within
    from tenzing_tpu_torch.bench import driver
    from tenzing_tpu_torch.bench.gate import within
    from tenzing_tpu_torch.ops import kernel_lib
    from tenzing_tpu_torch.ops.attention_kernels import BF16_O_TOL, F32_O_TOL
    from tenzing_tpu_torch.ops.ffn_kernels import BF16_Y_TOL, F32_Y_TOL

    os.makedirs(OUT_DIR, exist_ok=True)
    _log = open(os.path.join(OUT_DIR, "chip_smoke.jsonl"), "w")
    t_start = time.time()
    device = torch.device("cuda", 0)
    smi = nvidia_smi()
    precision = {"allow_tf32": torch.backends.cuda.matmul.allow_tf32,
                 "float32_matmul_precision": torch.get_float32_matmul_precision()}
    emit({"phase": "device", "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "count": torch.cuda.device_count(),
          "name": torch.cuda.get_device_name(0), **precision})
    if precision != {"allow_tf32": False, "float32_matmul_precision": "highest"}:
        raise AssertionError(f"float32 matmuls must not use TF32: {precision}")

    t0 = time.time()
    kernel_lib.lib()
    emit({"phase": "build", "seconds": round(time.time() - t0, 3),
          "compiled": kernel_lib.build_info.get("compiled"),
          "sources": list(kernel_lib.SOURCES),
          "library": os.path.relpath(kernel_lib.build_info["path"], REPO)})
    with open(os.path.join(OUT_DIR, "ptxas.txt"), "w") as f:
        f.write(str(kernel_lib.build_info.get("ptxas", "(library was cached)")))

    timer = Timer(torch, device)
    t0 = time.time()
    summary = phase_kernels(torch, device, timer)
    emit({"phase": "kernels", "rows": sum(len(v) for v in summary.values()),
          "all_exact": True, "wall_s": round(time.time() - t0, 3)})

    t0 = time.time()
    ex_info = phase_executor(torch, device)
    emit({"phase": "executor", **ex_info, "wall_s": round(time.time() - t0, 3)})

    t0 = time.time()
    halo_trace = os.path.join(OUT_DIR, "halo_trace")
    halo_metrics = os.path.join(OUT_DIR, "halo_metrics.json")
    halo_db = os.path.join(OUT_DIR, "halo_driver.csv")
    req = driver.DriverRequest(mcts_iters=DRIVER_MCTS_ITERS, iters=3,
                               search_iters=2, climb_budget=4,
                               profile_winner=True,
                               profile_repeats=HALO_PROFILE_REPEATS,
                               trace_out=halo_trace,
                               metrics_json=halo_metrics, dump_csv=halo_db)
    reset_launches()
    result = driver.run(req, device="cuda")
    launches = all_launches()
    verdict = result.verdict
    print(result.to_json_line(), flush=True)
    # the serve phase's report and regression check read it back
    halo_verdict = os.path.join(OUT_DIR, "halo_verdict.json")
    with open(halo_verdict, "w") as f:
        f.write(result.to_json_line() + "\n")
    emit({"phase": "driver", "launches": launches,
          "verified": verdict.get("verified"), "climbs": verdict.get("climbs"),
          "perf": capture_perf(verdict), "wall_s": round(time.time() - t0, 3)})
    check_prefetch(verdict, "driver")
    check_warm_start(verdict, "driver")
    check_attrib(verdict, halo_trace, halo_metrics)
    if verdict.get("metric") != "halo_iter_pct50_searched_n512":
        raise AssertionError(f"driver metric {verdict.get('metric')!r}")
    check_no_failures(verdict, "halo driver")
    if verdict.get("verified") is not True:
        raise AssertionError(f"driver result not verified: {verdict}")
    if not verdict.get("climbs") or not all(c["spent"] > 0
                                            for c in verdict["climbs"]):
        raise AssertionError(f"the halo climbs did not run: {verdict}")
    missing = [k for k in ("halo_pack", "halo_unpack", "device_copy",
                           "halo_pack.simt", "halo_unpack.tma",
                           "halo_unpack.simt")
               if launches[k] <= 0]
    if missing:
        raise AssertionError(f"the main path never launched {missing}")

    t0 = time.time()
    attn_rows = phase_attn_kernels(torch, device, timer)
    emit({"phase": "attn_kernels", "rows": len(attn_rows),
          "all_within_tol": True, "wall_s": round(time.time() - t0, 3)})
    t0 = time.time()
    want_o, attn_ex = phase_attn_executor(torch, device)
    emit({"phase": "attn_executor", **attn_ex,
          "wall_s": round(time.time() - t0, 3)})
    attn_launches = phase_attn_driver(torch, device, want_o)
    t0 = time.time()
    afused_rows, afused_timing, sdpa_ms = phase_attn_fused(torch, device, timer,
                                                           want_o)
    emit({"phase": "attn_fused", "rows": len(afused_rows),
          "all_within_tol": True, "wall_s": round(time.time() - t0, 3)})
    t0 = time.time()
    afused_launches = phase_attn_fused_driver(torch, device)
    emit({"phase": "attn_fused_driver", "wall_s": round(time.time() - t0, 3)})

    t0 = time.time()
    moe_rows = phase_moe_kernels(torch, device, timer)
    emit({"phase": "moe_kernels", "rows": len(moe_rows),
          "all_within_tol": True, "wall_s": round(time.time() - t0, 3)})
    t0 = time.time()
    want_y, moe_ex = phase_moe_executor(torch, device)
    emit({"phase": "moe_executor", **moe_ex,
          "wall_s": round(time.time() - t0, 3)})
    moe_launches = phase_moe_driver(torch, device, want_y)
    t0 = time.time()
    chunk_rows, chunk_const = phase_chunk(torch, device, timer, want_o,
                                          want_y)
    emit({"phase": "chunk", "rows": len(chunk_rows), "all_within_tol": True,
          "wall_s": round(time.time() - t0, 3)})
    del want_y, want_o
    t0 = time.time()
    sync_rows = phase_host_syncs(torch, device)
    emit({"phase": "host_syncs", "rows": len(sync_rows), "all_bit_equal": True,
          "wall_s": round(time.time() - t0, 3)})
    t0 = time.time()
    chunk_launches = phase_chunk_driver(torch, device)
    emit({"phase": "chunk_driver", "wall_s": round(time.time() - t0, 3)})

    t0 = time.time()
    layer_rows = phase_moe_layer_kernels(torch, device, timer)
    emit({"phase": "moe_layer_kernels", "rows": len(layer_rows),
          "all_within_tol": True, "wall_s": round(time.time() - t0, 3)})
    layer_launches, _, layer_summary, layer16_launches = phase_moe_layer(
        torch, device, timer)
    mesh_launches, mesh_summary = phase_mesh_halo(torch, device)
    shared_ranks, irr_stages_2 = phase_mesh_halo_shared(torch)
    irr_stages = phase_irregular_shared(torch, irr_stages_2)
    model_launches, ring_folds = phase_models(torch, device, timer)

    t0 = time.time()
    spmv_rows = phase_spmv_kernels(torch, device, timer)
    emit({"phase": "spmv_kernels", "rows": len(spmv_rows),
          "all_within_tol": True, "wall_s": round(time.time() - t0, 3)})
    t0 = time.time()
    spmv_ex = phase_spmv_executor(torch, device)
    emit({"phase": "spmv_executor", **spmv_ex,
          "wall_s": round(time.time() - t0, 3)})
    t0 = time.time()
    graph_rows = phase_graphs(torch, device)
    emit({"phase": "graphs_summary", "schedules": len(graph_rows),
          "slower_with_graphs": [f"{r['workload']}/{r['order']}"
                                 for r in graph_rows
                                 if r["wall_us"] > r["eager"]["wall_us"]],
          "wall_s": round(time.time() - t0, 3)})
    t0 = time.time()
    fused_rows, fused_timing = phase_fused(torch, device, timer)
    emit({"phase": "fused", "rows": len(fused_rows), "all_within_tol": True,
          "wall_s": round(time.time() - t0, 3)})
    t0 = time.time()
    sweep = phase_fused_sweep(torch, device, timer)
    emit({"phase": "fused_sweep", "rows": len(sweep), "all_within_tol": True,
          "wall_s": round(time.time() - t0, 3)})
    spmv_launches = phase_spmv_driver(torch, device)
    phase_dfs_example(torch)
    phase_examples(torch, halo_db)
    t0 = time.time()
    synth_launches = phase_synth_spmv(torch, device, smi)
    emit({"phase": "synth_spmv_summary", "card": smi,
          "ell_spmv_launches_synth": synth_launches,
          "wall_s": round(time.time() - t0, 3)})
    t0 = time.time()
    phase_synth_halo(torch, device, smi)
    emit({"phase": "synth_halo_done", "card": smi,
          "wall_s": round(time.time() - t0, 3)})
    t0 = time.time()
    learn_verdict = phase_learn(torch, smi, halo_db, halo_trace)
    emit({"phase": "learn_done", "card": smi,
          "wall_s": round(time.time() - t0, 3)})
    serve_row = phase_serve(torch, device, smi, halo_db, {
        "halo_trace": os.path.join(halo_trace, "trace.jsonl"),
        "halo_metrics": halo_metrics, "halo_verdict": halo_verdict,
        "learn_verdict": learn_verdict})
    phase_fault(torch)

    # one halo iteration's six faces at the batched blocking, per kernel
    def six_faces(rows, blocking):
        picked = [r for r in rows if r["slot"] == blocking or (
            blocking == ".pallasb" and r["slot"] == ".pallas"
            and not any(q["face"] == r["face"] and q["slot"] == ".pallasb"
                        for q in rows))]
        return {key: sum(r[key] for r in picked)
                for key in ("ms", "plain_ms", "library_ms", "bound_ms")}

    sources = {
        "halo_pack": ("tenzing_tpu_torch/csrc/halo_pack.cu",
                      "tenzing_tpu/ops/halo_pallas.py:189",
                      ".pallasb"),
        "halo_unpack": ("tenzing_tpu_torch/csrc/halo_unpack.cu",
                        "tenzing_tpu/ops/halo_pallas.py:221",
                        ".pallasb"),
        "device_copy": ("tenzing_tpu_torch/csrc/device_copy.cu",
                        "tenzing_tpu/ops/rdma.py:138",
                        ".rdma"),
    }
    kernels = []
    for name, (src, replaces, blocking) in sources.items():
        rows = summary[name]
        agg = six_faces(rows, blocking)
        if name != "device_copy":
            # the flat slot's x and y faces (rows 5-6 of PERF.md's table)
            flat = [r for r in rows if r["slot"] == ".pallasf"]
            z_rows = [r for r in rows if "sector_bound_ms" in r
                      and r["slot"] == blocking]
            halo_extra = {
                "body_by_face": {r["face"]: r["body"] for r in rows},
                "launches_by_body": {b: launches[f"{name}.{b}"]
                                     for b in ("tma", "simt")
                                     if f"{name}.{b}" in launches},
                "sector_bound_ms": sum(r["sector_bound_ms"] for r in z_rows),
                "flat_xy": {key: sum(r[key] for r in flat) for key in (
                    "ms", "library_ms", "bound_ms", "simt_ms")
                    if all(key in r for r in flat)},
            }
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            # device_copy also runs on the moe path's .rdma chains
            "launches": launches[name] + (moe_launches[name]
                                          if name == "device_copy" else 0),
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": agg["ms"], "plain_ms": agg["plain_ms"],
            "bound_ms": agg["bound_ms"], "bound_by": "bytes",
            "library_ms": agg["library_ms"],
            "work": "six faces of one halo iteration, "
                    + ("staging copies" if name == "device_copy"
                       else "batched blocking (one row per block on x)"),
        })
        # the serve phase's in-process halo drain (not in "launches"), and
        # the schedules its listen loop answered, run on the card
        kernels[-1]["launches_serve"] = serve_row["steps"]["drain_halo"][
            "launches"].get(name, 0)
        kernels[-1]["launches_listen"] = serve_row["steps"]["listen_run"][
            "launches"].get(name, 0)
        if name == "device_copy":
            kernels[-1]["launches_by_path"] = {"halo": launches[name],
                                               "moe": moe_launches[name]}
            kernels[-1]["clean_ms"] = sum(r["clean_ms"] for r in rows)
            kernels[-1]["library_clean_ms"] = sum(r["library_clean_ms"]
                                                  for r in rows)
        else:
            kernels[-1].update(halo_extra)
    # the attention kernels: the f32 row at the main path's shapes, the bf16
    # row beside it; launches count both input types
    for name, case, replaces, work in (
            ("attn_block", "block-{}-init",
             "tenzing_tpu/ops/attention_pallas.py:66",
             "one 1024-key block into the (4, 8192, 128) state"),
            ("attn_fused", "fused-{}",
             "tenzing_tpu/ops/attention_pallas.py:165",
             "all 8192 keys into the (4, 8192, 128) state")):
        by_case = {r["case"]: r for r in attn_rows}
        f32, bf16 = by_case[case.format("f32")], by_case[case.format("bf16")]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "tenzing_tpu_torch/csrc/attn_fold.cu",
            "replaces": replaces,
            "launches": attn_launches[name] + attn_launches[name + "_bf16"],
            "max_abs_err": max(r["max_abs_err"] for r in attn_rows
                               if r["kernel"] == name and not r["bf16_inputs"]),
            "ms": f32["ms"], "plain_ms": f32["plain_ms"],
            "bound_ms": f32["bound_ms"], "bound_by": f32["bound_by"],
            "library_ms": f32["library_ms"],
            "bound_simt_ms": f32["bound_simt_ms"], "tflops": f32["tflops"],
            "ptxas": f32["ptxas"],
            "work": work + ", f32 inputs (split-TF32 wgmma; bound_ms by the "
                           "split's three TF32 products)",
            "launches_bf16_inputs": attn_launches[name + "_bf16"],
            "bf16": {key: bf16[key] for key in (
                "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                "tflops", "bound_two_pass_ms", "cast_ms", "ptxas")} | {
                "max_abs_err": max(r["max_abs_err"] for r in attn_rows
                                   if r["kernel"] == name and r["bf16_inputs"])},
        })
    # the ring step at world size 1 folds all 8192 keys as one block
    block = next(k for k in kernels if k["name"] == "attn_block")
    block["launches_ring"] = {
        "f32": model_launches["ring"].get("attn_block", 0),
        "bf16": model_launches["ring"].get("attn_block_bf16", 0)}
    block["ring_fold"] = {
        ("bf16" if r["bf16_inputs"] else "f32"): {key: r[key] for key in (
            "shape", "ms", "plain_ms", "bound_ms", "bound_by", "tflops",
            "max_abs_err")} for r in ring_folds}
    # the expert MLP at the main path's shapes (one chunk's slot table)
    full = next(r for r in moe_rows if r["case"] == "full")
    e, c, d, dff = full["shape"]
    kernels.append({
        "name": "ffn_batched", "route": "cuda",
        "source": "tenzing_tpu_torch/csrc/ffn_expert.cu",
        "replaces": "tenzing_tpu/ops/ffn_pallas.py:101",
        "launches": moe_launches["ffn_batched"],
        "max_abs_err": max(r["max_abs_err"] for r in moe_rows),
        "ms": full["ms"], "plain_ms": full["plain_ms"],
        "bound_ms": full["bound_ms"], "bound_by": full["bound_by"],
        "bound_simt_ms": full["bound_simt_ms"],
        "library_ms": None,  # no single PyTorch call computes it
        "library_calls_ms": full["library_calls_ms"],
        "library_calls": full["library_calls"],
        "work": f"one chunk's expert MLP: {e} experts x {c} slots, d {d}, "
                f"d_ff {dff}, f32",
    })
    # the MoE layer's .pallas expert MLP at one chunk's shape, f32 and bf16
    for dt, case, name, launched in (
            ("float32", "chunk", "ffn_rows", layer_launches["ffn_rows"]),
            ("bfloat16", "chunk-bf16", "ffn_rows_bf16",
             layer16_launches["ffn_rows_bf16"])):
        lrow = next(r for r in layer_rows if r["case"] == case)
        n, d, dff = lrow["shape"]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "tenzing_tpu_torch/csrc/ffn_rows.cu",
            "replaces": "tenzing_tpu/ops/ffn_pallas.py:43",
            "launches": launched,
            "max_abs_err": max(r["max_abs_err"] for r in layer_rows
                               if r["dtype"] == dt),
            "ms": lrow["ms"], "plain_ms": lrow["plain_ms"],
            "bound_ms": lrow["bound_ms"], "bound_by": lrow["bound_by"],
            **({"bound_simt_ms": lrow["bound_simt_ms"]}
               if "bound_simt_ms" in lrow else {}),
            "library_ms": None,  # no single PyTorch call computes it
            "library_calls_ms": lrow["library_calls_ms"],
            "library_calls": lrow["library_calls"],
            "work": f"one chunk's expert MLP of the MoE layer at world size "
                    f"1: n {n}, d {d}, d_ff {dff}, {dt}",
        })
    kernels[-2]["self_a2a_per_chunk_ms"] = layer_summary[
        "self_a2a_per_chunk_ms"]
    # the mesh shift: one x face of the flagship halo between two ranks on
    # one card (time-sliced contexts, not NVLink); the slower rank's times
    timing = [r["timing"] for r in shared_ranks]
    face_bytes = timing[0]["bytes"]
    for name, key, replaces, nbytes in (
            ("rdma_shift_post", "post_ms", "tenzing_tpu/ops/rdma.py:189",
             face_bytes),
            ("rdma_shift_wait", "wait_ms", "tenzing_tpu/ops/rdma.py:225", 8)):
        kernels.append({
            "name": name, "route": "cuda",
            "source": "tenzing_tpu_torch/csrc/rdma_shift.cu",
            "replaces": replaces,
            "launches": sum(r["launches"][name] for r in shared_ranks),
            "launches_by_rank": [r["launches"][name] for r in shared_ranks],
            "max_abs_err": max(t["max_abs_err"] for t in timing),
            "ms": max(t[key] for t in timing),
            "plain_ms": max(t["plain_ms"] for t in timing),
            "bound_ms": bound_ms(nbytes), "bound_by": "bytes",
            "library_ms": None,  # NCCL refuses two ranks on one device
            "by_rank_ms": [t[key] for t in timing],
            "post_wait_ms": max(t["post_wait_ms"] for t in timing),
            "barrier_ms": max(t["barrier_ms"] for t in timing),
            "copy_ms": max(t["copy_ms"] for t in timing),
            "handoff": timing[0]["handoff"],
            "handoffs": {h: {k: max(t["handoffs"][h][k] for t in timing)
                             for k in timing[0]["handoffs"][h]}
                         for h in timing[0]["handoffs"]},
            "work": "one x face (3, 3, 512, 512) f32 of the flagship halo "
                    "between two ranks sharing one card through CUDA IPC "
                    "(time-sliced contexts, not NVLink)",
        })
    # the irregular SpMV's .rdma exchange: shifts 1-3 between 2 and 4 ranks
    # sharing the card, several collective ids in flight
    for name in ("rdma_shift_post", "rdma_shift_wait"):
        row = next(k for k in kernels if k["name"] == name)
        row["launches_irregular"] = {
            s["stage"]: sum(r["launches"][name] for r in s["ranks"])
            for s in irr_stages}
        key = "post_ms" if name == "rdma_shift_post" else "wait_ms"
        row["irregular_ms_by_distance"] = {
            s["stage"]: {d: max(r["timing"][d][key] for r in s["ranks"])
                         for d in s["ranks"][0]["timing"]}
            for s in irr_stages}
    next(k for k in kernels if k["name"] == "device_copy")[
        "launches_mesh_halo"] = mesh_launches["device_copy"]
    # the SpMV kernel at the --m 8192 path's spmv_remote shapes
    main_row = next(r for r in spmv_rows if r["case"].startswith("m8192"))
    kernels.append({
        "name": "ell_spmv", "route": "cuda",
        "source": "tenzing_tpu_torch/csrc/ell_spmv.cu",
        "replaces": "tenzing_tpu/ops/spmv_pallas.py:78",
        "launches": spmv_launches[8192]["ell_spmv"],
        # under the synthesized host pipe's schedules at m=8192 (synth_spmv)
        "launches_synth": synth_launches,
        # the serve phase's spmv drain (its --exec-item child's own count)
        # and its exact answer run on the card
        "launches_serve": serve_row["steps"]["drain_spmv"]["launches"][
            "ell_spmv"],
        "launches_serve_exact": serve_row["steps"]["exact"].get(
            "spmv", {}).get("launches", {}).get("ell_spmv", 0),
        "launches_listen": serve_row["steps"]["listen_run"]["launches"].get(
            "ell_spmv", 0),
        "max_abs_err": max(r["max_abs_err"] for r in spmv_rows),
        "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"],
        "library_call": main_row["library_call"],
        "floor_ms": main_row["floor_ms"], "warm_ms": main_row["warm_ms"],
        "work": "spmv_remote at m=8192: a (%d, %d) slab, x of %d" % tuple(
            main_row["shape"]),
    })
    # the fused regions of the m=150000 naive order (host exchange), at one
    # tile: no single library call computes a region; the stepped members'
    # summed time stands beside it
    host_t = [r for r in fused_timing if r["exchange"] == "host"]
    kernels.append({
        "name": "fused_region", "route": "cuda",
        "source": "tenzing_tpu_torch/csrc/fused_region.cu",
        "replaces": "tenzing_tpu/runtime/fused.py:358",
        "launches": spmv_launches[150_000]["fused_region"],
        "max_abs_err": max(max(r["vs_plain"].values()) for r in fused_rows),
        "ms": sum(r["ms"] for r in host_t),
        "plain_ms": sum(r["plain_ms"] for r in host_t),
        "bound_ms": sum(r["bound_ms"] for r in host_t), "bound_by": "bytes",
        "library_ms": None,
        "stepped_members_ms": sum(r["stepped_ms"] for r in host_t),
        "vs_bound": sum(r["ms"] for r in host_t) / sum(r["bound_ms"]
                                                      for r in host_t),
        "instantiation": host_t[0]["instantiation"],
        "work": "the two regions of the m=150000 naive order, one tile: "
                + "; ".join("+".join(r["members"]) for r in host_t),
    })
    # the attention members of the same kernel: the naive .xla order's one
    # region (8 folds + finalize) at one tile; one f32
    # scaled_dot_product_attention call computes its O
    naive_t = next(r for r in afused_timing
                   if r["order"] == "naive" and r["tiles"] == 1)
    kernels.append({
        "name": "fused_region_attn", "route": "cuda",
        "source": "tenzing_tpu_torch/csrc/fused_region.cu",
        "replaces": "tenzing_tpu/runtime/fused.py:358",
        "launches": afused_launches["fused_region"],
        "max_abs_err": max(max(v["max_abs"] for v in r["vs_plain"].values())
                           for r in afused_rows),
        "ms": naive_t["ms"], "plain_ms": naive_t["plain_ms"],
        "bound_ms": naive_t["bound_ms"], "bound_by": naive_t["bound_by"],
        "library_ms": sdpa_ms,
        "stepped_members_ms": naive_t["stepped_ms"],
        "bound_simt_ms": naive_t["bound_simt_ms"], "tflops": naive_t["tflops"],
        "instantiation": naive_t["instantiation"],
        "by_tiles_ms": {str(r["tiles"]): r["ms"] for r in afused_timing
                        if r["order"] == "naive"},
        "work": "the naive .xla attention order's region at one tile: "
                + "+".join(naive_t["members"]),
        "chunk_constants": {k: chunk_const[k] for k in (
            "dispatch_us_measured", "xfer_gbs_measured")},
        "launches_chunk_driver": {w: c["fused_region"]
                                  for w, c in chunk_launches.items()},
    })
    emit({"phase": "done", "wall_s": round(time.time() - t_start, 3)})
    _log.close()
    print(json.dumps({"kernels": kernels}), flush=True)
    print(nvidia_smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 4 and sys.argv[1] == "--sticky-child":
        sys.exit(sticky_child(sys.argv[2], int(sys.argv[3])))
    if len(sys.argv) == 4 and sys.argv[1] == "--serve-child":
        sys.exit(serve_child(sys.argv[2], sys.argv[3]))
    if len(sys.argv) == 7 and sys.argv[1] == "--listen-child":
        sys.exit(listen_child(*sys.argv[2:7]))
    if len(sys.argv) == 3 and sys.argv[1] == "--obs-child":
        sys.exit(obs_child(sys.argv[2]))
    sys.exit(main())
