"""Several training steps per dispatch (``steps_per_call``) in the port, on the
CPU, against its own per-step dispatch and against the JAX package's
schedule: the port's twin of ``TestChunkedDispatch`` and
``TestObsVarianceAnneal`` in ``tests/test_inference.py``.

On a CUDA device a chunk of K steps is one CUDA graph; on the CPU the same
``TrainChunk`` runs its K steps eagerly from the same buffers, so these tests
hold that code path. A step's draws depend only on its index and both
dispatch paths run the same ops on the same inputs, so chunked training
equals per-step training to the bit: the ELBO history, params, EMA and AdamW
state. The trainer updates its state buffers in place (a captured graph holds
their addresses), which the ``data_ptr`` tests pin.
"""

import contextlib
import gc
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import viforsdes_tpu_torch as tvt
from viforsdes_tpu.config import TrainingConfig as JTrainingConfig
from viforsdes_tpu.core.observations import GaussianObservationLikelihood as JLikelihood
from viforsdes_tpu.inference.trainer import VariationalInferenceTrainer as JTrainer
from viforsdes_tpu_torch.inference.chunk import pack_metrics
from viforsdes_tpu_torch.inference.optimizer import GROUPS

from test_torch_elbo import OU


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    torch.set_num_threads(1)


OBS_TIMES = [0.0, 0.5, 1.0, 1.5, 2.0]
OBS_VALUES = [[2.0], [1.5], [0.8], [1.2], [0.9]]
ANNEAL = dict(obs_variance_final=1e-3, obs_variance_anneal_steps=100)


def _trainer(**training):
    cfg = tvt.TrainingConfig(**{"time_step": 0.25, "batch_size": 8, "n_iterations": 9, **training})
    return tvt.VariationalInferenceTrainer(
        OU(),
        tvt.Observations(times=OBS_TIMES, values=OBS_VALUES),
        tvt.GaussianObservationLikelihood(variance=0.1),
        tvt.Prior(type=tvt.PriorType.NORMAL, mean=0.0, std=1.0, dim=3),
        2.0,
        cfg,
        tvt.EncoderConfig(hidden_dim=16, cond_dim=16, num_heads=2, depth=1),
        tvt.HeadConfig(hidden_dim=8, num_layers=2),
        state_positive_dims=[],
        sde_param_positive_dims=[0, 2],
        console=tvt.Console(enabled=False),
        device="cpu",
    )


def _state(trainer):
    s = trainer.opt_state
    out = {f"params/{g}": trainer.flat_params[g] for g in GROUPS}
    out.update({f"ema/{g}": trainer.flat_ema[g] for g in GROUPS})
    out.update({f"mu/{g}": s["mu"][g] for g in GROUPS})
    out.update({f"nu/{g}": s["nu"][g] for g in GROUPS})
    out.update({k: s[k] for k in ("count", "notfinite_count", "total_notfinite")})
    return out


def _assert_same_state(a, b):
    sa, sb = _state(a), _state(b)
    for name in sa:
        assert torch.equal(sa[name], sb[name]), name


def test_chunked_matches_single_step():
    """A chunk of 3 over 9 steps, with the warmup boundary at 4 inside a chunk,
    gives per-step dispatch's history, params, EMA and AdamW state to the
    bit."""
    per_step, chunked = _trainer(theta_warmup_steps=4, steps_per_call=1), _trainer(
        theta_warmup_steps=4, steps_per_call=3)
    s1 = per_step.train(update_interval=10)
    s3 = chunked.train(update_interval=10)
    assert chunked._train_chunks.keys() == {3}
    assert per_step._train_chunks == {}
    assert s3.evidence_lower_bound_history == s1.evidence_lower_bound_history
    assert len(s3.evidence_lower_bound_history) == 9
    _assert_same_state(per_step, chunked)
    assert chunked.step == 8 and chunked._completed_steps == 9


def test_callback_sees_every_step_in_order():
    log = []
    trainer = _trainer(n_iterations=10, steps_per_call=4)
    trainer.train(callback=lambda step, elbo: log.append((step, elbo)), update_interval=10)
    assert [s for s, _ in log] == list(range(10))
    assert all(np.isfinite(e) for _, e in log)


@pytest.mark.parametrize("n_iterations,steps_per_call,expected", [(100, 0, 10), (5, 0, 1), (100, 64, 10)])
def test_auto_resolution(n_iterations, steps_per_call, expected):
    """Auto (0) chunks by the flush interval only for runs of at least three
    intervals; an explicit value is capped by the interval."""
    trainer = _trainer(n_iterations=n_iterations, steps_per_call=steps_per_call)
    assert trainer._resolve_steps_per_call(10) == expected


def test_chunked_checkpoint_resume_exact(tmp_path):
    """A chunked run checkpointed at step 4 and resumed gives the unbroken
    chunked run's history and state to the bit."""
    ckpt = tmp_path / "chunk_ckpt.npz"
    full = _trainer(n_iterations=8, steps_per_call=2)
    s_full = full.train(update_interval=4)
    half = _trainer(n_iterations=4, steps_per_call=2)
    half.train(update_interval=4, checkpoint_every=4, checkpoint_path=ckpt)
    resumed = _trainer(n_iterations=8, steps_per_call=2)
    resumed.restore_checkpoint(ckpt)
    s_resumed = resumed.train(update_interval=4)
    assert s_resumed.evidence_lower_bound_history == s_full.evidence_lower_bound_history
    _assert_same_state(full, resumed)


def test_anneal_inside_chunks_equals_per_step():
    """The annealed claimed variance and the warmup scale enter a chunk's
    steps from its buffers: the same bits as per-step dispatch."""
    runs = [_trainer(n_iterations=6, theta_warmup_steps=2, steps_per_call=k, **ANNEAL) for k in (1, 3)]
    histories = [t.train(update_interval=6).evidence_lower_bound_history for t in runs]
    assert histories[0] == histories[1]
    assert all(np.isfinite(histories[0]))
    _assert_same_state(*runs)


def test_anneal_values_equal_the_jax_schedule():
    """The port's fp32 schedule (per step, and as the chunk buffers' row)
    against the JAX trainer's ``_annealed_obs_variance``: the same fp32
    arithmetic up to the final exp, where XLA's CPU exp and numpy's differ by
    at most one unit in the last place (0.1 comes out as 0.09999999 in
    XLA)."""
    warmup = 2
    trainer = _trainer(theta_warmup_steps=warmup, **ANNEAL)
    j_self = SimpleNamespace(
        config=JTrainingConfig(time_step=0.25, batch_size=8, n_iterations=9, theta_warmup_steps=warmup, **ANNEAL),
        observation_likelihood=JLikelihood(variance=0.1),
    )
    steps = [0, warmup, warmup + 1, warmup + 50, warmup + 99, warmup + 100, 10_000]
    ref = [np.float32(JTrainer._annealed_obs_variance(j_self, jnp.int32(s))) for s in steps]
    got = [trainer._annealed_obs_variance(s) for s in steps]
    assert all(g.dtype == torch.float32 and g.dim() == 0 for g in got)
    got = np.array([g.item() for g in got], np.float32)
    np.testing.assert_array_max_ulp(got, np.array(ref), maxulp=1)
    # a chunk's buffer row holds the per-step values
    np.testing.assert_array_equal([trainer._step_schedule(s, 1)[1, 0] for s in steps], got)
    final = JTrainer._annealed_obs_variance(j_self, None)
    assert trainer._annealed_obs_variance(None).item() == np.float32(final)
    np.testing.assert_array_equal(trainer._step_schedule(0, 6)[0], [0, 0, 1, 1, 1, 1])


def test_one_chunk_on_two_step_ranges_equals_per_step():
    """One runner called on steps 0-2 and then 3-5 (with the warmup ending at
    2 and the anneal moving) equals steps 0-5 dispatched one by one: no input
    of a chunk is frozen at its first call, the CPU stand-in for a replayed
    graph."""
    per_step = _trainer(theta_warmup_steps=2, **ANNEAL)
    rows = [pack_metrics(per_step.train_step(s)) for s in range(6)]
    chunked = _trainer(theta_warmup_steps=2, **ANNEAL)
    chunk = chunked._get_train_chunk(3)
    got = [chunk(0).clone(), chunk(3).clone()]
    assert chunked._get_train_chunk(3) is chunk
    assert torch.equal(torch.cat(got), torch.stack(rows))
    _assert_same_state(per_step, chunked)
    assert chunked._completed_steps == 6


def test_restore_checkpoint_keeps_the_state_buffers(tmp_path):
    ckpt = tmp_path / "ckpt.npz"
    source = _trainer(n_iterations=3)
    source.train(update_interval=10)
    source.save_checkpoint(ckpt)
    target = _trainer(n_iterations=3)
    before = {name: t.data_ptr() for name, t in _state(target).items()}
    target.restore_checkpoint(ckpt)
    assert {name: t.data_ptr() for name, t in _state(target).items()} == before
    _assert_same_state(source, target)
    assert int(target.opt_state["count"]) == 3


def test_set_theta_mean_keeps_the_state_buffers():
    trainer = _trainer(n_iterations=2)
    trainer.train(update_interval=10)
    before = {name: t.data_ptr() for name, t in _state(trainer).items()}
    mean = torch.tensor([0.5, -0.25, 0.125])
    trainer.set_theta_mean(mean)
    assert {name: t.data_ptr() for name, t in _state(trainer).items()} == before
    assert torch.equal(trainer.params["theta"]["mean"], mean)
    s = trainer.opt_state
    assert all(not bool(s[k][g].any()) for k in ("mu", "nu") for g in GROUPS)
    assert int(s["count"]) == int(s["notfinite_count"]) == int(s["total_notfinite"]) == 0


class _Cycle:
    """A dead reference cycle whose finalizer records whether the collector
    was on, as a dead trainer <-> chunk cycle holding a CUDA graph is."""

    finalized: list = []

    def __init__(self):
        self.me = self

    def __del__(self):
        _Cycle.finalized.append(gc.isenabled())


def _fake_capture(monkeypatch, fail: bool = False) -> dict:
    """``torch.cuda``'s streams and graph capture, and the span markers'
    launches, faked in ``chunk``, so that ``TrainChunk._warm_and_capture``
    runs on the CPU; returns what the capture saw."""
    from viforsdes_tpu_torch.inference import chunk as chunk_mod

    seen: dict = {}

    class Stream:
        def wait_stream(self, other):
            pass

    class Capture:
        def __init__(self, graph, stream=None, capture_error_mode=None):
            seen["mode"] = capture_error_mode

        def __enter__(self):
            seen["collector_on"] = gc.isenabled()
            seen["finalized_before"] = len(_Cycle.finalized)

        def __exit__(self, *exc):
            if fail:
                raise RuntimeError("CUDA error: operation failed due to a previous error during capture")

    cuda = chunk_mod.torch.cuda
    monkeypatch.setattr(cuda, "current_stream", lambda dev=None: Stream())
    monkeypatch.setattr(cuda, "Stream", lambda dev=None: Stream())
    monkeypatch.setattr(cuda, "stream", lambda s: contextlib.nullcontext())
    monkeypatch.setattr(cuda, "CUDAGraph", object)
    monkeypatch.setattr(cuda, "graph", Capture)
    # the device spans' CUDA calls inside the capture: marker launches, node counts
    monkeypatch.setattr(chunk_mod.profiling, "_launch_marker", lambda *args: -1)
    monkeypatch.setattr(chunk_mod.profiling, "captured_nodes", lambda stream: -1)
    return seen


@pytest.mark.parametrize("collector_on", [False, True])
def test_capture_collects_the_dead_first_and_nothing_during(monkeypatch, collector_on):
    """On the card, a collection inside the capture that finalizes an earlier
    trainer's dead graph invalidates the capture. The chunk collects the dead
    before it captures, keeps the collector off during the capture, and
    leaves it as it found it."""
    from viforsdes_tpu_torch.inference.chunk import TrainChunk

    trainer = _trainer(n_iterations=4)
    chunk = TrainChunk(trainer, 2)
    chunk(0)  # the CPU path: fills the input buffers
    seen = _fake_capture(monkeypatch)
    _Cycle.finalized.clear()
    gc.disable()
    try:
        _Cycle()
        if collector_on:
            gc.enable()
        chunk._warm_and_capture(2)
        assert gc.isenabled() == collector_on
    finally:
        gc.enable()
    assert seen == {"mode": "global", "collector_on": False, "finalized_before": 1}
    assert _Cycle.finalized in ([False], [True]) and chunk.graph is not None
    if not collector_on:  # only the chunk's own collection could have run it
        assert _Cycle.finalized == [False]


def test_failed_capture_raises_and_turns_the_collector_back_on(monkeypatch):
    from viforsdes_tpu_torch.inference.chunk import TrainChunk

    trainer = _trainer(n_iterations=4)
    chunk = TrainChunk(trainer, 2)
    chunk(0)
    _fake_capture(monkeypatch, fail=True)
    assert gc.isenabled()
    with pytest.raises(RuntimeError, match="capturing the 2-step training chunk that starts at step 2"):
        chunk._warm_and_capture(2)
    assert gc.isenabled() and chunk.graph is None
