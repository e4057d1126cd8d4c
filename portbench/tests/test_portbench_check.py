"""The check that decides ``correct``: the reference against the program at
a tiny size on the CPU, the controls, and the faults it has to catch."""

from __future__ import annotations

import pytest
import torch

from portbench import run
from portbench.harness import check, problem
from portbench.reference.precision import Precision, fp8_round
from portbench.tests.conftest import tiny

CELLS = ["lorenz_r3.bf16", "highdim_r5.bf16", "lorenz_r3.fp32"]
SEED = 2**31 + 77  # past 32 signed bits, as the driver's seeds are


def _limits(cell):
    return {k: float(v) for k, v in cell.traffic["limits"].items()}


@pytest.mark.parametrize("name", CELLS)
def test_reference_follows_the_program_in_fp32(name):
    """With the program in float32 the two sides agree to rounding: the
    reference is the same model, step and optimizer."""
    out = run.run_cell(tiny(name, compute_dtype="float32"), SEED, None, False, "cpu")
    assert out.finite
    assert max(out.numbers.values()) < 2e-3, out.numbers
    assert out.numbers["loss_gap"] < 1e-5 and out.numbers["grad_gap"] < 1e-4, out.numbers


@pytest.mark.parametrize("name", CELLS)
def test_the_cell_as_configured_is_correct(name):
    cell = tiny(name)
    out = run.run_cell(cell, SEED, 0.0, False, "cpu")
    res = run.result(cell, out, False, "cpu rehearsal")
    assert res["correct"], res["checks"]


def _unchanged(prog):
    """A step that returns its state unchanged."""
    t = prog.trainer
    inner = t._step_math

    def step_math(*args, **kwargs):
        saved = [x.clone() for x in t.state_tensors()]
        out = inner(*args, **kwargs)
        with torch.no_grad():
            for x, s in zip(t.state_tensors(), saved):
                x.copy_(s)
        return out

    t._step_math = step_math


def _half_batch(prog):
    """Half of the importance groups left out, the mean taken over the rest."""
    t = prog.trainer
    inner = t.draws

    def draws(step):
        return [(e[: e.shape[0] // 2], n[:, : n.shape[1] // 2].contiguous()) for e, n in inner(step)]

    t.draws = draws


@pytest.fixture
def altered(monkeypatch):
    """The ELBO of each step altered by 1% where its metrics row is made."""
    from viforsdes_tpu_torch.inference import chunk

    inner = chunk.pack_metrics

    def pack_metrics(metrics):
        row = inner(metrics)
        return torch.cat([row[:1] * 1.01, row[1:]])

    monkeypatch.setattr(chunk, "pack_metrics", pack_metrics)
    return None


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("fault", ["unchanged_state", "half_batch", "altered_answer"])
def test_each_fault_comes_out_not_correct(name, fault, request):
    """The run with its timed path broken underneath: ``correct`` false."""
    plant = {"unchanged_state": _unchanged, "half_batch": _half_batch}.get(fault)
    if fault == "altered_answer":
        request.getfixturevalue("altered")
    cell = tiny(name)
    out = run.run_cell(cell, SEED, 0.0, False, "cpu", plant=plant)
    res = run.result(cell, out, False, "cpu rehearsal")
    assert not res["correct"], res["checks"]


def _in_replay(held):
    """A fault of the replayed chunk alone: the eager chunk's
    ``steps_per_call`` steps run as they are, and every later step (on the
    card the steps captured into the graph, on the CPU the second pass)
    writes the tensors ``held(trainer)`` back as they were before it."""

    def plant(prog):
        t = prog.trainer
        inner = t._step_math
        k = int(prog.traffic["steps_per_call"])
        calls = [0]

        def step_math(*args, **kwargs):
            calls[0] += 1
            if calls[0] <= k:
                return inner(*args, **kwargs)
            kept = held(t)
            saved = [x.clone() for x in kept]
            out = inner(*args, **kwargs)
            with torch.no_grad():
                for x, v in zip(kept, saved):
                    x.copy_(v)
            return out

        t._step_math = step_math

    return plant


REPLAY_FAULTS = {
    "update_dropped": lambda t: list(t.flat_params.values()),  # AdamW's write of the params
    "ema_stale": lambda t: list(t.flat_ema.values()),
    "moments_stale": lambda t: [*t.opt_state["mu"].values(), *t.opt_state["nu"].values()],
}


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("fault", sorted(REPLAY_FAULTS))
def test_a_fault_of_the_replay_alone_comes_out_not_correct(name, fault):
    """The window runs only replays: a write that the replay drops or
    stales, while the eager chunk makes it, is caught by ``replay_gap``."""
    cell = tiny(name)
    out = run.run_cell(cell, SEED, 0.0, False, "cpu", plant=_in_replay(REPLAY_FAULTS[fault]))
    res = run.result(cell, out, False, "cpu rehearsal")
    assert not res["correct"], res["checks"]
    assert out.numbers["replay_gap"] > 0.5, out.numbers


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_a_replay_fault_fails_at_the_cells_size(name, card):
    """On the card, at the timed sizes: the params' update dropped from the
    captured graph alone reads past the cell's ``replay_gap`` limit."""
    from portbench.harness import spec

    cell = spec.load_cell(name)
    out = run.run_cell(cell, 2**31 + 9, None, False, card, plant=_in_replay(REPLAY_FAULTS["update_dropped"]),
                       reference=False)
    assert out.numbers["replay_gap"] > _limits(cell)["replay_gap"], out.numbers


def test_replay_gap_reads_the_largest_leaf():
    w0 = {"a": torch.zeros(4), "b": torch.ones(4)}
    eager = {"params": {"a": torch.full((4,), 0.5), "b": torch.full((4,), 1.5)},
             "mu": {"a": torch.ones(4), "b": torch.ones(4)}}
    same = {g: {k: v.clone() for k, v in d.items()} for g, d in eager.items()}
    assert check.replay_gap(eager, same, w0) == 0.0
    same["params"]["b"] = w0["b"].clone()  # one leaf's update dropped
    assert check.replay_gap(eager, same, w0) == pytest.approx(1.0)
    same["mu"]["a"] = torch.full((4,), float("nan"))
    assert check.replay_gap(eager, same, w0) == float("inf")


def _control_numbers(cell, device, seed=SEED):
    """The control, the reference one precision below the cell's, in the
    program's place: its numbers against the float32 reference."""
    pb = problem.problem(cell.config, cell.traffic, device)
    w0 = problem.make_weights(cell.config, pb.shapes, seed, device)
    n = cell.traffic["check_steps"]
    ref = check.reference_readings(pb, w0, seed, n)
    ctl = check.reference_readings(pb, w0, seed, n, Precision(cell.traffic["control"]))
    ctl.losses = ctl.losses * 2  # the program reports two passes
    return check.compare(ctl, ref)


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_at_the_cells_size(name, card):
    """At the timed sizes, on the card: the control is not correct."""
    from portbench.harness import spec

    cell = spec.load_cell(name)
    assert not check.verdict(_control_numbers(cell, card, 2**31 + 5), _limits(cell))


@pytest.mark.parametrize("name", ["lorenz_r3.bf16", "highdim_r5.bf16"])
def test_fp8_control_moves_the_change_further_than_bf16(name):
    """At a tiny size on the CPU the fp8 control moves the params' change
    at least three times as far from the reference as the bf16 program."""
    cell = tiny(name)
    program = run.run_cell(cell, SEED, None, False, "cpu").numbers
    assert _control_numbers(cell, "cpu")["change_gap"] > 3 * program["change_gap"]


def test_fp8_rounding():
    x = torch.tensor([0.0, 1.0, -3.0, 448.0, 1e-3])
    y = fp8_round(x)
    assert y[0] == 0 and torch.allclose(y[:4], x[:4], rtol=0.07)
    assert (fp8_round(torch.linspace(-1, 1, 1000)).unique().numel()) < 300


def test_reference_draws_are_the_programs():
    """The reference works the program's draws out again from the seed."""
    from portbench.reference import train as R

    cell = tiny("highdim_r5.bf16")
    pb = problem.problem(cell.config, cell.traffic, "cpu")
    from portbench.harness.program import Program

    sde = problem.make_sde(cell.config)
    times, values = problem.observations(cell.config)
    prog = Program(cell.config, cell.traffic, sde, times, values, SEED, "cpu")
    for step in (0, 7):
        for (a, b), (c, d) in zip(prog.trainer.draws(step), R.draws(pb, SEED, step)):
            assert torch.equal(a, c) and torch.equal(b, d)
