"""What decides ``correct``: the program's first training steps, taken by its
own ``train()``, against the plain reference from the same weights and
draws.

The program's readings (``Readings``) come from the steps the window's call
took: the losses of the first ``n`` steps from the eager first chunk and
from a replay of the captured chunk, the replay's five ELBO terms, each
leaf's gradient as AdamW took it at step 1 (its first moment over
``1 - b1``), and each leaf's change of the params and the EMA over the
first ``n`` steps. The reference (``reference/``) takes the same ``n``
steps. Compared:

- ``loss_gap``: the largest ``|L - L_ref| / |L_ref|`` over the steps and
  both passes;
- ``terms_gap``: the largest ``|t - t_ref| / max(|t_ref|, 1)`` over the
  replay's steps and five terms;
- ``grad_gap``, ``change_gap``: over the leaves, the largest gap of norms
  ``|n - n_ref| / max(n_ref, median leaf's n_ref)``;
- ``ema_gap``: that gap for the median leaf of the EMA's change. The EMA
  moves by a thousandth of the params' change a step, within a few float32
  ulps of a leaf whose values are near 1, so its largest leaf gap is
  rounding; the median leaf's is steady.

Leaves whose reference gradient is under ``GRAD_FLOOR`` of the median
leaf's (``kept``: nought to rounding) are left out: at step 1 for
``grad_gap``, summed over the steps for the changes.

Those numbers see the replay of the captured chunk only through its losses
and terms. The window runs nothing but replays, so one more number holds
the replay's whole update to the eager chunk's, which the reference holds:

- ``replay_gap``: after the ``steps_per_call`` steps of each pass, the
  params, the EMA and the AdamW first moments, leaf by leaf, the norm of
  the replay's difference from the eager pass over the norm of the eager
  pass's change (from the weights; for the moments from 0), or over the
  median leaf's where that is larger; the largest over the leaves. A
  replay that drops or stales a write reads about 1.
"""

from __future__ import annotations

import math
import statistics
from dataclasses import dataclass, field

import torch
from torch import Tensor

from portbench.reference import train as R
from portbench.reference.precision import Precision

GRAD_FLOOR = 1e-3
NUMBERS = ("loss_gap", "terms_gap", "grad_gap", "change_gap", "ema_gap", "replay_gap")


@dataclass
class Readings:
    """One side's readings of the first ``n`` steps."""

    losses: list[list[float]]  # per pass, per step: -ELBO
    terms: list[list[float]]  # per step: the five ELBO terms
    grad1: dict[str, float]  # per leaf: the norm of the step-1 gradient as AdamW took it
    change: dict[str, float]  # per leaf: the norm of the params' change after n steps
    ema_change: dict[str, float]
    grad_sum: dict[str, float] = field(default_factory=dict)  # reference only: summed gradient norms


def _norms(d: dict[str, Tensor]) -> dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in d.items()}


def program_readings(prog, w0: dict[str, Tensor], warm_losses: list[float], replay_rows: Tensor,
                     seen: dict[int, dict], n: int) -> Readings:
    """``warm_losses`` are the first pass's losses, ``replay_rows`` the
    second pass's metrics rows; ``seen`` the snapshots after steps 1 and
    ``n`` of the first pass."""
    mu1 = prog.unpack(seen[1]["mu"])
    p_n = prog.unpack(seen[n]["params"])
    e_n = prog.unpack(seen[n]["ema"])
    return Readings(
        losses=[list(warm_losses[:n]), [-float(r[0]) for r in replay_rows[:n]]],
        terms=[[float(v) for v in r[1:6]] for r in replay_rows[:n]],
        grad1=_norms({k: v / (1 - R.B1) for k, v in mu1.items()}),
        change=_norms({k: p_n[k] - w0[k].to(p_n[k].device) for k in w0}),
        ema_change=_norms({k: e_n[k] - w0[k].to(e_n[k].device) for k in w0}),
    )


def reference_readings(pb: R.Problem, w0: dict[str, Tensor], seed: int, n: int,
                       prec: Precision | None = None, batch_keep: float = 1.0) -> Readings:
    """The reference's ``n`` steps from ``w0`` with the program's draws of
    steps ``0 .. n - 1``."""
    prec = prec or Precision()
    st = R.init_state(w0)
    losses, terms, grad1, grad_sum = [], [], None, {k: 0.0 for k in w0}
    for k in range(n):
        theta_scale = 1.0 if k >= pb.theta_warmup_steps else 0.0
        out = R.step(pb, st, R.draws(pb, seed, k), theta_scale, prec, batch_keep=batch_keep)
        losses.append(-out.elbo)
        terms.append(out.terms)
        g = _norms(out.clipped)
        grad1 = grad1 or g
        for key, v in g.items():
            grad_sum[key] += v
    return Readings(
        losses=[losses],
        terms=terms,
        grad1=grad1,
        change=_norms({k: st.params[k] - w0[k] for k in w0}),
        ema_change=_norms({k: st.ema[k] - w0[k] for k in w0}),
        grad_sum=grad_sum,
    )


def kept(grads: dict[str, float]) -> list[str]:
    """The leaves whose gradient norm is at least ``GRAD_FLOOR`` of the
    median leaf's, the median taken over the leaves with any gradient."""
    med = statistics.median(v for v in grads.values() if v > 0)
    return [k for k, v in grads.items() if v >= GRAD_FLOOR * med]


def _leaf_gaps(mine: dict[str, float], ref: dict[str, float], keep: list[str]) -> list[float]:
    med = statistics.median(ref[k] for k in keep)
    gaps = [abs(mine[k] - ref[k]) / max(ref[k], med, 1e-30) for k in keep]
    return gaps if all(math.isfinite(g) for g in gaps) else [math.inf]


def _rel(a: float, b: float, floor: float = 0.0) -> float:
    if not (math.isfinite(a) and math.isfinite(b)):
        return math.inf
    return abs(a - b) / max(abs(b), floor, 1e-30)


def compare(mine: Readings, ref: Readings) -> dict[str, float]:
    """The numbers of ``NUMBERS`` (infinite where a reading is not finite)."""
    keep1, keep_sum = kept(ref.grad1), kept(ref.grad_sum)
    out = {
        "loss_gap": max(_rel(a, b) for losses in mine.losses for a, b in zip(losses, ref.losses[0])),
        "terms_gap": max(_rel(a, b, 1.0) for ta, tb in zip(mine.terms, ref.terms) for a, b in zip(ta, tb)),
        "grad_gap": max(_leaf_gaps(mine.grad1, ref.grad1, keep1)),
        "change_gap": max(_leaf_gaps(mine.change, ref.change, keep_sum)),
        "ema_gap": statistics.median(_leaf_gaps(mine.ema_change, ref.ema_change, keep_sum)),
    }
    return {k: (v if math.isfinite(v) else math.inf) for k, v in out.items()}


def replay_gap(eager: dict[str, dict[str, Tensor]], replay: dict[str, dict[str, Tensor]],
               w0: dict[str, Tensor]) -> float:
    """``replay_gap`` from each pass's leaves after its chunk:
    ``{"params" | "ema" | "mu": {path: leaf}}``."""
    gaps = []
    for group, leaves in eager.items():
        moved = _norms({k: v - w0[k].to(v.device) if group in ("params", "ema") else v for k, v in leaves.items()})
        med = statistics.median(moved.values())
        apart = _norms({k: replay[group][k] - v for k, v in leaves.items()})
        gaps += [apart[k] / max(moved[k], med, 1e-30) for k in leaves]
    return max(gaps) if all(math.isfinite(g) for g in gaps) else math.inf


def verdict(numbers: dict[str, float], limits: dict[str, float]) -> bool:
    return all(numbers[k] <= limits[k] for k in limits)
