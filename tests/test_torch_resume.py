"""Trainer checkpoints and resume of the port.

A step's draws depend only on ``(seed, step)`` and the checkpoint holds the
params, AdamW state and EMA bit for bit, so on the CPU a resumed run is the
unbroken run to the bit: the ELBO history, the params, the EMA and the
moments. A JAX trainer checkpoint holds optax's optimizer state, which the
port refuses by name.
"""

import pytest
import torch

import viforsdes_tpu_torch as tvt
from viforsdes_tpu_torch.inference.trainer import VariationalInferenceTrainer as TTrainer
from viforsdes_tpu_torch.utils.tree import tree_items

from test_torch_elbo import ENC, HEAD, OBS_TIMES, OBS_VALUES, OU, make_pair


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    torch.set_num_threads(1)


def _problem():
    return (OU(), tvt.Observations(times=OBS_TIMES, values=OBS_VALUES),
            tvt.GaussianObservationLikelihood(variance=0.1),
            tvt.Prior(type=tvt.PriorType.NORMAL, mean=0.0, std=1.0, dim=3), 2.0)


def _trainer(n_iterations, seed=11):
    return TTrainer(
        *_problem(),
        tvt.TrainingConfig(time_step=0.1, batch_size=8, n_iterations=n_iterations, compute_dtype="float32"),
        tvt.EncoderConfig(**ENC), tvt.HeadConfig(**HEAD),
        state_positive_dims=[], sde_param_positive_dims=[0, 2],
        console=tvt.Console(enabled=False), seed=seed, device="cpu",
    )


def _assert_same_state(a, b):
    assert a.evidence_lower_bound_history == b.evidence_lower_bound_history
    assert a.best_evidence_lower_bound == b.best_evidence_lower_bound
    for g in a.flat_params:
        assert torch.equal(a.flat_params[g], b.flat_params[g]), g
        assert torch.equal(a.flat_ema[g], b.flat_ema[g]), g
        assert torch.equal(a.opt_state["mu"][g], b.opt_state["mu"][g]), g
        assert torch.equal(a.opt_state["nu"][g], b.opt_state["nu"][g]), g
    for k in ("count", "notfinite_count", "total_notfinite"):
        assert torch.equal(a.opt_state[k], b.opt_state[k]), k


def test_resume_equals_the_unbroken_run_bitwise(tmp_path):
    ckpt = tmp_path / "mid.npz"
    full = _trainer(6)
    full.train()

    first = _trainer(3)
    first.train()
    first.save_checkpoint(ckpt)

    resumed = _trainer(6)
    resumed.restore_checkpoint(ckpt)
    assert resumed._completed_steps == 3 and len(resumed.evidence_lower_bound_history) == 3
    resumed.train()
    assert len(resumed.evidence_lower_bound_history) == 6
    _assert_same_state(resumed, full)


def test_checkpoint_every_during_train(tmp_path):
    ckpt = tmp_path / "auto.npz"
    _trainer(5, seed=3).train(checkpoint_every=2, checkpoint_path=ckpt)
    fresh = _trainer(5, seed=3)
    fresh.restore_checkpoint(ckpt)
    # the last checkpoint was written after 4 completed steps
    assert fresh._completed_steps == 4
    assert len(fresh.evidence_lower_bound_history) == 4


def test_infer_resume_from_matches_the_unbroken_infer(tmp_path):
    ckpt = tmp_path / "mid.npz"

    def config(n_iterations, **kw):
        return tvt.InferenceConfig(
            training=tvt.TrainingConfig(time_step=0.5, batch_size=8, n_iterations=n_iterations),
            encoder=tvt.EncoderConfig(hidden_dim=16, cond_dim=16, num_heads=2, depth=1),
            head=tvt.HeadConfig(hidden_dim=8, num_layers=1),
            sde_param_positive_dims=[0, 2], console=tvt.Console(enabled=False), device="cpu", **kw,
        )

    continuous = tvt.infer(*_problem(), config(6))
    tvt.infer(*_problem(), config(3, checkpoint_every=3, checkpoint_path=ckpt))
    resumed = tvt.infer(*_problem(), config(6, checkpoint_every=3, checkpoint_path=ckpt, resume_from=ckpt))
    assert resumed.evidence_lower_bound_history == continuous.evidence_lower_bound_history
    for ours, ref in ((resumed.params, continuous.params), (resumed.ema_params, continuous.ema_params)):
        for (path, a), (_, b) in zip(tree_items(ours), tree_items(ref)):
            assert torch.equal(a, b), path


def test_a_jax_trainer_checkpoint_is_refused(tmp_path):
    jt, tt = make_pair()
    ckpt = tmp_path / "jax.npz"
    jt.save_checkpoint(ckpt)
    with pytest.raises(ValueError, match="structure mismatch.*opt_state/count.*opt_state/inner_state"):
        tt.restore_checkpoint(ckpt)
