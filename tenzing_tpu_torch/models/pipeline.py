"""Pipeline parallelism: microbatch pipelining, and its training step, as
searchable op DAGs.

Counterpart of ``tenzing_tpu/models/pipeline.py``.  Stage s of an S-stage
network lives on rank s of mesh axis ``"pp"``; every rank runs the same
per-tick program (SPMD): compute the resident stage on the resident
microbatch, then shift the activations one hop forward (``PermuteStart`` +
``AwaitTransfer``).  A microbatch leaves the last stage S - 1 ticks after
stage 0 took it.  The microbatches are dealt over ``n_chains`` independent
tick chains::

    inject_t -> compute_t -> rotate_t (post) -> await_t -> inject_{t+1} ...
                         \\-> collect_t   (once the pipe is full)

which share nothing until the final interleave, so one chain's rotate can
hide behind another's stage product.  :class:`PipelineTrain` is a whole
training step: per chain the forward (stashing each live microbatch's input
and pre-activation), then the backward on the reverse ring (``shift=-1``)
seeding g = y - target at the last stage and accumulating dW per stage;
``pt_addgrads`` sums the chains' dW.

Ticks whose slot holds no live microbatch compute on whatever the slot
holds (SPMD), and only collected rows and valid backward steps reach Y and
dW: the rank, tick and stage decide on the host whether an inject, a
collect, a stash or a dW update happens at all, so a dead slot never
enters them.  The stage is gelu(act @ W) with the tanh gelu
(``jax.nn.gelu``'s default); its backward ``aten.gelu_backward`` of the
same form.  Ops write in place into their buffers or declared per-chain
scratch; float32 products run in full float32.  Op names, kind tags and
schedule JSON are the reference's.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np

from tenzing_tpu_torch.core.graph import Graph
from tenzing_tpu_torch.core.operation import CompoundOp, DeviceOp
from tenzing_tpu_torch.ops.comm_ops import AwaitTransfer, PermuteStart
from tenzing_tpu_torch.utils.numeric import gelu_tanh, gelu_tanh_grad

AXIS = "pp"


@dataclass(frozen=True)
class PipelineArgs:
    n_pp: int  # pipeline stages == mesh ranks
    n_microbatches: int = 4
    n_chains: int = 2  # interleaved virtual pipelines (the searched freedom)
    mb_size: int = 4  # rows per microbatch
    d_model: int = 8
    dtype: str = "float32"

    @property
    def chain_microbatches(self) -> int:
        assert self.n_microbatches % self.n_chains == 0
        return self.n_microbatches // self.n_chains

    @property
    def chain_ticks(self) -> int:
        return self.chain_microbatches + self.n_pp - 1


def _act(v: int, t: int) -> str:
    """Activation buffer chain ``v`` reads at tick ``t`` (ping-pong pair)."""
    return f"act_{v}_{t % 2}"


def _gelu_(t) -> None:
    import torch

    torch.ops.aten.gelu_(t, approximate="tanh")


class Inject(DeviceOp):
    """Tick ``t`` < M_v: stage 0 copies microbatch ``t``'s input into its
    activation slot (the other stages keep what the rotate delivered)."""

    def __init__(self, name: str, v: int, t: int):
        super().__init__(name)
        self._v, self._t = v, t

    def reads(self):
        return [_act(self._v, self._t), f"X_{self._v}"]

    def writes(self):
        return [_act(self._v, self._t)]

    def apply(self, bufs, ctx):
        if ctx.mesh.index(AXIS) == 0:
            bufs[_act(self._v, self._t)].copy_(bufs[f"X_{self._v}"][self._t])


class StageCompute(DeviceOp):
    """out_v = gelu(act @ W): the resident stage on the resident activation
    (every stage, every tick)."""

    def __init__(self, name: str, v: int, t: int, mb_rows: int = None):
        super().__init__(name)
        self._v, self._t = v, t
        self._mb = mb_rows  # per-rank activation rows, for chunk_counts

    def reads(self):
        return [_act(self._v, self._t), "W"]

    def writes(self):
        return [f"out_{self._v}"]

    def _rows(self, rows: int) -> slice:
        """The activation rows this op computes: all."""
        return slice(0, rows)

    def apply(self, bufs, ctx):
        import torch

        act = bufs[_act(self._v, self._t)]
        rows = self._rows(act.shape[0])
        out = bufs[f"out_{self._v}"][rows]
        torch.matmul(act[rows], bufs["W"][0], out=out)
        _gelu_(out)

    # -- op-chunking protocol (core/chunking.py): the stage product splits
    # over the activation rows, each partial writing its slice of out_v, so
    # the rotate post can follow the last partial
    def chunkable(self) -> bool:
        return True

    def chunk_counts(self) -> List[int]:
        # validity only; an op built without mb_rows is not chunkable
        from tenzing_tpu_torch.core.chunking import pow2_counts

        return pow2_counts(self._mb)

    def split(self, n: int) -> List["StageComputePartial"]:
        rows = self._mb
        if rows is None:
            raise ValueError(
                f"{self.name()}: split() needs the mb_rows extent")
        if n < 1 or rows % n:
            raise ValueError(f"{rows} activation rows do not split {n} ways")
        return [StageComputePartial(f"{self.name()}.c{n}p{j}", self._v,
                                    self._t, j, n, mb_rows=rows)
                for j in range(n)]


class StageComputePartial(StageCompute):
    """Partial ``j`` of an ``n``-way row split of :class:`StageCompute`:
    the stage product over its row slice, into that slice of ``out_v`` (the
    reference's read-modify-write slice update: it reads ``out_v`` too, so
    the partials chain)."""

    def __init__(self, name: str, v: int, t: int, part: int, n_parts: int,
                 mb_rows: int = None):
        super().__init__(name, v, t, mb_rows=mb_rows)
        self._part, self._n_parts = part, n_parts

    def chunkable(self) -> bool:
        return False  # a partial never re-splits

    def reads(self):
        return super().reads() + [f"out_{self._v}"]

    def _rows(self, rows: int) -> slice:
        if rows % self._n_parts:
            raise ValueError(f"{self.name()}: {rows} runtime rows do not "
                             f"split {self._n_parts} ways")
        per = rows // self._n_parts
        return slice(self._part * per, (self._part + 1) * per)


class Collect(DeviceOp):
    """Tick ``t`` >= S-1: the last stage banks microbatch ``t - (S-1)``'s
    finished output into its slot of the chain's result."""

    def __init__(self, name: str, v: int, t: int, args: PipelineArgs):
        super().__init__(name)
        self._v, self._t = v, t
        self._args = args

    def reads(self):
        return [f"out_{self._v}", f"Y_{self._v}"]

    def writes(self):
        return [f"Y_{self._v}"]

    def apply(self, bufs, ctx):
        if ctx.mesh.index(AXIS) == self._args.n_pp - 1:
            m = self._t - (self._args.n_pp - 1)
            bufs[f"Y_{self._v}"][m].copy_(bufs[f"out_{self._v}"])


class InterleaveY(DeviceOp):
    """Merge the chains' results into microbatch order (chain v slot j holds
    microbatch ``v + j * n_chains``)."""

    def __init__(self, name: str, args: PipelineArgs):
        super().__init__(name)
        self._args = args

    def reads(self):
        return [f"Y_{v}" for v in range(self._args.n_chains)]

    def writes(self):
        return ["Y"]

    def apply(self, bufs, ctx):
        nv = self._args.n_chains
        y = bufs["Y"]
        by_slot = y.view(y.shape[0] // nv, nv, *y.shape[1:])
        for v in range(nv):
            by_slot[:, v].copy_(bufs[f"Y_{v}"])


def _forward_chain(
    g: Graph,
    v: int,
    a: PipelineArgs,
    make_compute,
    inject_prefix: str = "inject",
    rotate_prefix: str = "rotate",
    await_prefix: str = "await",
    with_collect: bool = True,
):
    """Wire one chain's forward ticks: inject (while microbatches remain)
    -> compute -> rotate post -> await -> next tick; shared by
    :class:`Pipeline` and :class:`PipelineTrain`.  Returns (last compute op,
    last collect op or None)."""
    mv, ticks = a.chain_microbatches, a.chain_ticks
    prev_entry = None  # the op that delivers tick t's activation
    prev_collect = None
    comp = None
    for t in range(ticks):
        comp = make_compute(v, t)
        if t < mv:
            inj = Inject(f"{inject_prefix}_{v}_{t}", v, t)
            if prev_entry is None:
                g.start_then(inj)
            else:
                g.then(prev_entry, inj)
            g.then(inj, comp)
        else:
            g.then(prev_entry, comp)
        if prev_collect is not None:
            # WAR: compute_t overwrites out_v that collect_{t-1} read
            g.then(prev_collect, comp)
        if t < ticks - 1:
            post = PermuteStart(f"{rotate_prefix}_{v}_{t}", f"out_{v}",
                                _act(v, t + 1), AXIS)
            await_ = AwaitTransfer(f"{await_prefix}_{v}_{t}", _act(v, t + 1))
            g.then(comp, post)
            g.then(post, await_)
            prev_entry = await_
        if with_collect and t >= a.n_pp - 1:
            col = Collect(f"collect_{v}_{t}", v, t, a)
            g.then(comp, col)
            if prev_collect is not None:
                g.then(prev_collect, col)  # RAW: the Y_v chain
            prev_collect = col
    return comp, prev_collect


def stage_chunk_menu(args: PipelineArgs, relax: bool = False):
    """(pruned counts, {count: est hidden µs}) for one stage-tick product
    (bench/roofline.chunk_menu).  The neighbouring transfer is the stage
    send, one rank's activation rows, priced at ``roofline.EXCHANGE_GBS``
    (the reference priced it at a v5e's staging rate); ``relax=True`` keeps
    every structurally valid count."""
    from tenzing_tpu_torch.bench import roofline

    bpe = np.dtype(args.dtype).itemsize
    b, d = args.mb_size, args.d_model
    act = float(b * d * bpe)  # one rank's activation rows
    cost = roofline.Cost(flops=2.0 * b * d * d,
                         hbm_bytes=2.0 * act + float(d * d * bpe))
    return roofline.chunk_menu(
        StageCompute("probe", 0, 0, mb_rows=args.mb_size).chunk_counts(),
        cost, comm_us=act / (roofline.EXCHANGE_GBS * 1e9) * 1e6,
        combine_bytes=2.0 * act, relax=relax)


class Pipeline(CompoundOp):
    """The pipelined forward as one compound op: ``n_chains`` independent
    tick chains joined by the final interleave.  ``chunk=True`` wraps each
    tick's stage product in a ``ChunkChoice`` of its row splits (pruned by
    :func:`stage_chunk_menu`; ``chunk_relax`` keeps every valid count)."""

    def __init__(self, args: PipelineArgs, name: str = "pipeline",
                 chunk: bool = False, chunk_relax: bool = False):
        super().__init__(name)
        self._args = args
        self._chunk = chunk
        self._chunk_relax = chunk_relax

    def args(self) -> PipelineArgs:
        return self._args

    def graph(self) -> Graph:
        a = self._args
        g = Graph()
        counts, est = ((), None)
        if self._chunk:
            counts, est = stage_chunk_menu(a, relax=self._chunk_relax)

        def mk(vv, tt):
            step = StageCompute(f"compute_{vv}_{tt}", vv, tt,
                                mb_rows=a.mb_size)
            if any(int(n) > 1 for n in counts):
                from tenzing_tpu_torch.core.chunking import ChunkChoice, chunk_variants

                return ChunkChoice(step, chunk_variants(step, counts, est))
            return step

        inter = InterleaveY("pp_interleave", a)
        for v in range(a.n_chains):
            _comp, last_collect = _forward_chain(g, v, a, mk)
            g.then(last_collect, inter)
        g.then_finish(inter)
        return g


class TrainForward(DeviceOp):
    """Forward stage compute that also stashes this rank's live
    microbatch's input activation and pre-activation for the backward (the
    activation memory a pipeline training step carries); the pre-activation
    goes through per-chain scratch ``pt_z_<v>``."""

    def __init__(self, name: str, v: int, t: int, args: PipelineArgs):
        super().__init__(name)
        self._v, self._t, self._args = v, t, args

    def reads(self):
        return [_act(self._v, self._t), "W",
                f"stash_a_{self._v}", f"stash_z_{self._v}"]

    def writes(self):
        return [f"out_{self._v}", f"stash_a_{self._v}", f"stash_z_{self._v}"]

    def scratch_for(self, shapes):
        return {f"pt_z_{self._v}": (tuple(shapes[f"out_{self._v}"]),
                                    "float32")}

    def apply(self, bufs, ctx):
        import torch

        m = self._t - ctx.mesh.index(AXIS)  # this rank's live microbatch
        act = bufs[_act(self._v, self._t)]
        z = ctx.scratch[f"pt_z_{self._v}"]
        torch.matmul(act, bufs["W"][0], out=z)
        out = bufs[f"out_{self._v}"]
        out.copy_(z)
        _gelu_(out)
        if 0 <= m < self._args.chain_microbatches:
            bufs[f"stash_a_{self._v}"][m].copy_(act)
            bufs[f"stash_z_{self._v}"][m].copy_(z)


class BwdInject(DeviceOp):
    """Backward tick ``u`` < M_v: the last stage seeds microbatch ``u``'s
    gradient g = y - target (L2 loss; y = gelu of the stashed
    pre-activation).  The other stages keep what the reverse rotate
    delivered."""

    def __init__(self, name: str, v: int, u: int, args: PipelineArgs):
        super().__init__(name)
        self._v, self._u, self._args = v, u, args

    def reads(self):
        return [_act(self._v, self._u) + "g", f"stash_z_{self._v}",
                f"target_{self._v}"]

    def writes(self):
        return [_act(self._v, self._u) + "g"]

    def apply(self, bufs, ctx):
        if ctx.mesh.index(AXIS) != self._args.n_pp - 1:
            return
        g = bufs[_act(self._v, self._u) + "g"]
        g.copy_(bufs[f"stash_z_{self._v}"][self._u])
        _gelu_(g)
        g.sub_(bufs[f"target_{self._v}"][self._u])


class BwdCompute(DeviceOp):
    """One backward stage step: dz = g * gelu'(z); where this rank holds a
    live microbatch, dW_v += a^T dz; and the outgoing gradient dz W^T for
    the reverse rotate.  dz and a^T dz go through per-chain scratch."""

    def __init__(self, name: str, v: int, u: int, args: PipelineArgs):
        super().__init__(name)
        self._v, self._u, self._args = v, u, args

    def reads(self):
        return [_act(self._v, self._u) + "g", "W", f"stash_a_{self._v}",
                f"stash_z_{self._v}", f"dW_{self._v}"]

    def writes(self):
        return [f"gout_{self._v}", f"dW_{self._v}"]

    def scratch_for(self, shapes):
        d = shapes["W"][-1]
        return {f"pt_dz_{self._v}": (tuple(shapes[f"gout_{self._v}"]),
                                     "float32"),
                f"pt_dw_{self._v}": ((d, d), "float32")}

    def apply(self, bufs, ctx):
        import torch

        a = self._args
        m = self._u - (a.n_pp - 1 - ctx.mesh.index(AXIS))
        valid = 0 <= m < a.chain_microbatches
        idx = min(max(m, 0), a.chain_microbatches - 1)
        g = bufs[_act(self._v, self._u) + "g"]  # (B, d) incoming dL/dout
        z = bufs[f"stash_z_{self._v}"][idx]
        dz = ctx.scratch[f"pt_dz_{self._v}"]
        torch.ops.aten.gelu_backward(g, z, approximate="tanh", grad_input=dz)
        w = bufs["W"][0]
        if valid:
            dw = ctx.scratch[f"pt_dw_{self._v}"]
            torch.matmul(bufs[f"stash_a_{self._v}"][idx].T, dz, out=dw)
            bufs[f"dW_{self._v}"][0].add_(dw)
        torch.matmul(dz, w.T, out=bufs[f"gout_{self._v}"])


class AddGrads(DeviceOp):
    """Sum the chains' weight-gradient accumulators (per-chain buffers keep
    the chains' backward passes independent in the DAG)."""

    def __init__(self, name: str, args: PipelineArgs):
        super().__init__(name)
        self._args = args

    def reads(self):
        return [f"dW_{v}" for v in range(self._args.n_chains)]

    def writes(self):
        return ["dW"]

    def apply(self, bufs, ctx):
        out = bufs["dW"]
        out.copy_(bufs["dW_0"])
        for v in range(1, self._args.n_chains):
            out.add_(bufs[f"dW_{v}"])


class PipelineTrain(CompoundOp):
    """A whole pipeline-parallel training step as one compound op: per
    chain the forward ticks (with stashes), then the reverse-ring backward
    seeding gradients at the last stage and accumulating dW per stage; the
    chains share nothing until the final gradient sum."""

    def __init__(self, args: PipelineArgs, name: str = "pipeline_train"):
        super().__init__(name)
        self._args = args

    def args(self) -> PipelineArgs:
        return self._args

    def graph(self) -> Graph:
        a = self._args
        g = Graph()
        add = AddGrads("pt_addgrads", a)
        for v in range(a.n_chains):
            mv, ticks = a.chain_microbatches, a.chain_ticks
            last_fwd, _ = _forward_chain(
                g, v, a,
                lambda vv, tt: TrainForward(f"fcompute_{vv}_{tt}", vv, tt, a),
                inject_prefix="finject", rotate_prefix="frotate",
                await_prefix="fawait", with_collect=False,
            )
            # backward: after the chain's forward (the stashes are complete);
            # other chains' forwards may overlap it
            prev_entry = last_fwd
            for u in range(ticks):
                bcomp = BwdCompute(f"bcompute_{v}_{u}", v, u, a)
                if u < mv:
                    binj = BwdInject(f"binject_{v}_{u}", v, u, a)
                    g.then(prev_entry, binj)
                    g.then(binj, bcomp)
                else:
                    g.then(prev_entry, bcomp)
                if u < ticks - 1:
                    post = PermuteStart(f"brotate_{v}_{u}", f"gout_{v}",
                                        _act(v, u + 1) + "g", AXIS, shift=-1)
                    await_ = AwaitTransfer(f"bawait_{v}_{u}",
                                           _act(v, u + 1) + "g")
                    g.then(bcomp, post)
                    g.then(post, await_)
                    prev_entry = await_
            g.then(bcomp, add)
        g.then_finish(add)
        return g


def microbatch_dw64(x: np.ndarray, w64: np.ndarray,
                    target: np.ndarray) -> np.ndarray:
    """One microbatch's float64 gradient of 0.5 * sum((stack(x) -
    target)^2) by every stage's weight (``w64``: (stages, d, d)); the
    expected dW is its sum over the microbatches."""
    acts, zs = [x.astype(np.float64)], []
    for st in range(w64.shape[0]):
        zs.append(acts[-1] @ w64[st])
        acts.append(gelu_tanh(zs[-1]))
    g = acts[-1] - target.astype(np.float64)
    dw = np.zeros_like(w64)
    for st in reversed(range(w64.shape[0])):
        dz = g * gelu_tanh_grad(zs[st])
        dw[st] = acts[st].T @ dz
        g = dz @ w64[st].T
    return dw


def make_train_buffers(
    args: PipelineArgs, seed: int = 0
) -> Tuple[Dict[str, np.ndarray], Dict[str, object], np.ndarray]:
    """(buffers, specs, expected dW) for the training step on a ``("pp",)``
    mesh: the reference's arrays for the same seed, bit for bit.  The
    expected dW is the host float64 backward of the L2 loss
    0.5 * sum((stack(x_m) - target_m)^2) over every microbatch, stacked per
    stage (rank p's block is stage p's gradient)."""
    rng = np.random.default_rng(seed)
    s, m, v = args.n_pp, args.n_microbatches, args.n_chains
    b, d = args.mb_size, args.d_model
    mv = args.chain_microbatches
    dt = np.dtype(args.dtype)
    x = rng.standard_normal((m, b, d)).astype(dt)
    w = rng.standard_normal((s, d, d)).astype(dt) / np.sqrt(d)
    target = rng.standard_normal((m, b, d)).astype(dt)

    w64 = w.astype(np.float64)
    dw = np.zeros((s, d, d), np.float64)
    for mb in range(m):
        dw += microbatch_dw64(x[mb], w64, target[mb])

    bufs: Dict[str, np.ndarray] = {"W": w, "dW": np.zeros((s, d, d), dt)}
    specs: Dict[str, object] = {"W": (AXIS, None, None),
                                "dW": (AXIS, None, None)}
    for c in range(v):
        bufs[f"X_{c}"] = x[c::v]
        specs[f"X_{c}"] = (None, None, None)
        bufs[f"target_{c}"] = target[c::v]
        specs[f"target_{c}"] = (None, None, None)
        for par in (0, 1):
            for nm in (f"act_{c}_{par}", f"act_{c}_{par}g"):
                bufs[nm] = np.zeros((s * b, d), dt)
                specs[nm] = (AXIS, None)
        for nm in (f"out_{c}", f"gout_{c}"):
            bufs[nm] = np.zeros((s * b, d), dt)
            specs[nm] = (AXIS, None)
        for nm in (f"stash_a_{c}", f"stash_z_{c}"):
            bufs[nm] = np.zeros((s * mv, b, d), dt)
            specs[nm] = (AXIS, None, None)
        bufs[f"dW_{c}"] = np.zeros((s, d, d), dt)
        specs[f"dW_{c}"] = (AXIS, None, None)
    return bufs, specs, dw.astype(dt)


def make_pipeline_buffers(
    args: PipelineArgs, seed: int = 0
) -> Tuple[Dict[str, np.ndarray], Dict[str, object], np.ndarray]:
    """(buffers, specs, expected Y) for the forward on a ``("pp",)`` mesh:
    the reference's arrays for the same seed, bit for bit.  The expected Y
    is zero but in the last stage's block, where microbatch m's slot holds
    the float64 stage stack applied to its input."""
    rng = np.random.default_rng(seed)
    s, m, v = args.n_pp, args.n_microbatches, args.n_chains
    b, d = args.mb_size, args.d_model
    mv = args.chain_microbatches
    dt = np.dtype(args.dtype)
    x = rng.standard_normal((m, b, d)).astype(dt)
    w = rng.standard_normal((s, d, d)).astype(dt) / np.sqrt(d)

    y = x.astype(np.float64)
    for st in range(s):
        y = gelu_tanh(y @ w[st].astype(np.float64))

    bufs: Dict[str, np.ndarray] = {"W": w, "Y": np.zeros((s * m, b, d), dt)}
    specs: Dict[str, object] = {"W": (AXIS, None, None),
                                "Y": (AXIS, None, None)}
    for c in range(v):
        bufs[f"X_{c}"] = x[c::v]  # (M_v, B, d): chain c's microbatches
        specs[f"X_{c}"] = (None, None, None)  # replicated: stage 0 reads it
        for par in (0, 1):
            bufs[f"act_{c}_{par}"] = np.zeros((s * b, d), dt)
            specs[f"act_{c}_{par}"] = (AXIS, None)
        bufs[f"out_{c}"] = np.zeros((s * b, d), dt)
        specs[f"out_{c}"] = (AXIS, None)
        bufs[f"Y_{c}"] = np.zeros((s * mv, b, d), dt)
        specs[f"Y_{c}"] = (AXIS, None, None)

    want = np.zeros((s * m, b, d), dt)
    want[(s - 1) * m:s * m] = y.astype(dt)  # the last stage's block
    return bufs, specs, want
