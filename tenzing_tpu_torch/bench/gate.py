"""The integrity gate's comparison, split by buffer role.

The driver re-runs the reported schedule beside naive from the same initial
buffers (bench/driver.py).  The reference compares every output buffer of
the two runs with ``allclose(rtol=tol, atol=tol * 1e-3)``
(``tenzing_tpu/bench/driver.py:552``).  On the TPU both sides went through
the MXU's bf16 rounding, so that held.  On the card it does not: the f32
naive attention state differs from a fused winner's by summation order
alone, and a bf16 winner differs from the f32 naive by bf16 rounding, so
the reference's gate demotes every attention winner and every bf16-staged
MoE winner although their results are right (ROADMAP Queue 3 item 4).

The port's gate — a recorded deviation from the reference — holds each
kind of buffer to what it should be:

* **result buffers** are held, for the winner and for naive alike, against
  the float64 result at the tolerance of the precision the schedule ran:
  attention's ``O`` and ``acc / l_run`` against the dense float64 attention
  at ``F32_O_TOL`` or, where any fold ran a bf16 kernel slot,
  ``BF16_O_TOL`` (ops/attention_kernels.py); the MoE pipeline's ``Y`` and
  ``Y_<c>`` against the float64 routed result at ``F32_Y_TOL`` or, where any
  chain staged through bf16, ``BF16_Y_TOL`` (ops/ffn_kernels.py).  The
  running state (``acc``, ``m_run``, ``l_run``) is not compared raw;
* **every other buffer** keeps the reference's check against naive
  (:func:`mismatched_outputs`): a schedule that writes an input or a
  weight still fails;
* **halo and spmv** have no result buffers here: their verdicts are the
  reference's check, unchanged.

The precision is read from the ops the schedule ran (a ``_bf16`` kernel
slot; a ``pack16_<c>`` staging op), never from a label.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

# the attention state: not compared raw between runs (its rounding follows
# the summation order and the precision)
ATTN_STATE = ("acc", "m_run", "l_run")


def dense_attention64(q, k, v, scale: float):
    """Softmax attention of (b, n, d) ``q``/``k``/``v`` in float64 on their
    device, one batch element at a time (the reference's dense expected O,
    ``tenzing_tpu/models/ring_attention.py:593-598``).  At 8k context that
    is 512 MiB of float64 scores per element."""
    import torch

    outs = []
    for i in range(q.shape[0]):
        qi, ki, vi = (t[i].to(torch.float64) for t in (q, k, v))
        p = torch.softmax((qi @ ki.T) * scale, dim=-1)
        outs.append(p @ vi)
        del qi, ki, vi, p
    return torch.stack(outs)


def attn_bf16(seq) -> bool:
    """True when any fold of ``seq`` ran a bf16 kernel slot
    (``.pallas_bf16``, ``.fused_bf16``)."""
    return any(op.name().endswith("_bf16") for op in seq.vector())


def moe_bf16(seq) -> bool:
    """True when any chain of ``seq`` staged through bf16 (its
    ``pack16_<c>`` op ran)."""
    return any(op.name().startswith("pack16_") for op in seq.vector())


def held_errors(got, want) -> Dict[str, float]:
    """The largest absolute error of ``got`` against the float64 ``want``
    and the rms error relative to ``want``'s rms."""
    d = got.double() - want
    return {"max_abs": float(d.abs().max()),
            "rel_rms": float(d.square().mean().sqrt()
                             / want.square().mean().sqrt().clamp_min(1e-300))}


def within(got, want, tol) -> Tuple[bool, Dict[str, float]]:
    """(ok, errors) of ``got`` against ``want`` (taken in float64) at
    ``tol``: every limit the dict holds, an ``allclose`` (``rtol`` /
    ``atol``), a relative rms (``rel_rms``) and a largest error
    (``max_abs``): ``BF16_O_TOL`` and ``BF16_Y_TOL`` are the last two, the
    training step's dW (parallel/dryrun.py ``train_tol``) the first two.
    NaN anywhere fails."""
    import torch

    want = want.to(torch.float64)
    errs = held_errors(got, want)
    if got.shape != want.shape:
        return False, errs
    ok = True
    if "rtol" in tol:
        ok = bool(torch.allclose(got.double(), want, rtol=tol["rtol"],
                                 atol=tol["atol"]))
    if "rel_rms" in tol:
        ok = ok and errs["rel_rms"] <= tol["rel_rms"]
    if "max_abs" in tol:
        ok = ok and errs["max_abs"] <= tol["max_abs"]
    return bool(ok), errs


@dataclass
class ResultGate:
    """One workload's result buffers.  ``results(out) -> {name: tensor}``
    derives each held quantity from a run's outputs; ``expected`` holds
    their float64 values; ``tol_of(seq) -> (precision, tol)``; ``skip``
    lists the buffers the raw comparison leaves out (the results and the
    state)."""

    results: Callable[[Dict], Dict]
    expected: Dict
    tol_of: Callable
    skip: Tuple[str, ...]

    def check(self, out, seq) -> Tuple[List[str], Dict]:
        """(names outside the limit, the report block) of one run."""
        precision, tol = self.tol_of(seq)
        bad, block = [], {"precision": precision, "limit": dict(tol),
                          "buffers": {}}
        for name, got in self.results(out).items():
            ok, errs = within(got, self.expected[name], tol)
            block["buffers"][name] = {**errs, "ok": ok}
            if not ok:
                bad.append(name)
        return bad, block


def attn_gate(out_inputs, scale: float) -> ResultGate:
    """The attention gate: ``O`` and ``acc / l_run`` against the dense
    float64 O of ``out_inputs``' Q, K, V (computed once, on their
    device)."""
    from tenzing_tpu_torch.ops.attention_kernels import BF16_O_TOL, F32_O_TOL

    want = dense_attention64(out_inputs["Q"], out_inputs["K"],
                             out_inputs["V"], scale)
    return ResultGate(
        results=lambda out: {"O": out["O"],
                             "acc/l_run": out["acc"] / out["l_run"]},
        expected={"O": want, "acc/l_run": want},
        tol_of=lambda seq: (("bf16", BF16_O_TOL) if attn_bf16(seq)
                            else ("f32", F32_O_TOL)),
        skip=("O",) + ATTN_STATE)


def moe_gate(want64, n_chunks: int, device) -> ResultGate:
    """The MoE gate: ``Y`` and each chunk's ``Y_<c>`` against the float64
    routed result ``want64`` (numpy, ``make_pipe_buffers(...,
    expected_float64=True)``)."""
    import torch

    from tenzing_tpu_torch.ops.ffn_kernels import BF16_Y_TOL, F32_Y_TOL

    want = torch.as_tensor(want64, dtype=torch.float64, device=device)
    tc = want.shape[0] // n_chunks
    expected = {"Y": want}
    expected.update({f"Y_{c}": want[c * tc:(c + 1) * tc]
                     for c in range(n_chunks)})
    return ResultGate(
        results=lambda out: {n: out[n] for n in expected},
        expected=expected,
        tol_of=lambda seq: (("bf16", BF16_Y_TOL) if moe_bf16(seq)
                            else ("f32", F32_Y_TOL)),
        skip=tuple(expected))


def mismatched_outputs(out_a, out_b, tol: float, skip=()) -> List[str]:
    """The integrity gate's agreement policy: names (shared by both output
    dicts, minus ``skip``) whose tensors differ in shape or fail
    ``allclose(rtol=tol, atol=tol*1e-3, equal_nan=True)`` in float64.

    The driver skips the pinned host staging buffers: they are the host
    engine's transport scratch, which a device-engine schedule never
    touches, so comparing them would fail every winner whose engine differs
    from naive's (the reference's gate compares them and does;
    ROADMAP.md, Queue 3).  For moe it also skips the device-side staging
    buffers of both staging sets (``transport_buffer_names``): a schedule
    leaves the set its chains did not pick untouched, and a bf16 set holds
    rounded copies — transport, not results."""
    import torch

    bad = []
    for name in sorted((set(out_a) & set(out_b)) - set(skip)):
        a, b = out_a[name], out_b[name]
        if a.shape != b.shape or not torch.allclose(
                a.double(), b.double(), rtol=tol, atol=tol * 1e-3,
                equal_nan=True):
            bad.append(name)
    return bad


def gate_outputs(out_naive, out_winner, naive_seq, winner_seq, tol: float,
                 skip, result_gate: Optional[ResultGate]) -> Tuple[
                     List[str], Optional[Dict]]:
    """The gate's verdict on two runs: (names that fail, the ``gate``
    block or None).  Without a ``result_gate`` (halo, spmv) this is the
    reference's check, unchanged.  With one, the result buffers of both
    runs are held against float64 (a name fails if either run's fails) and
    every other buffer is compared raw, as before."""
    if result_gate is None:
        return mismatched_outputs(out_naive, out_winner, tol, skip=skip), None
    bad = set(mismatched_outputs(out_naive, out_winner, tol,
                                 skip=set(skip) | set(result_gate.skip)))
    block = {}
    for who, out, seq in (("winner", out_winner, winner_seq),
                          ("naive", out_naive, naive_seq)):
        wrong, block[who] = result_gate.check(out, seq)
        bad.update(wrong)
    return sorted(bad), block
