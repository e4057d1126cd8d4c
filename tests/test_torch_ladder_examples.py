"""Each of the port's five examples (``examples_torch/``) runs its
``main()`` on the CPU: the example's own calls (``infer``, ``summary(500)``,
the console's summary table, ``plot(show=False).savefig``, ``save``), with
``infer`` cut to a tiny width and 2 steps."""

import dataclasses
import importlib

import pytest
import torch
import torch.distributed as dist

import viforsdes_tpu_torch as vtt


def tiny_infer(real_infer, n_iterations=None, horizon=None):
    """``infer`` at a tiny width on the CPU (and ``n_iterations`` steps, and
    the observations up to ``horizon`` only, when given); everything else as
    the caller asked."""

    def infer(**kw):
        if horizon is not None:
            obs = kw["observations"]
            keep = obs.times <= horizon
            kw["observations"] = vtt.Observations(times=obs.times[keep], values=obs.values[torch.from_numpy(keep)])
            kw["time_horizon"] = horizon
        c = kw["config"]
        training = dict(batch_size=8, iw_samples=1)
        if n_iterations is not None:
            training["n_iterations"] = n_iterations
        kw["config"] = dataclasses.replace(
            c,
            training=c.training.model_copy(update=training),
            encoder=vtt.EncoderConfig(hidden_dim=16, cond_dim=16, num_heads=2, depth=1),
            head=c.head.model_copy(update=dict(hidden_dim=8)),
            pretrain=vtt.PretrainConfig(n_iterations=3, batch_size=32, sweep_candidates=64, cem_rounds=1)
            if c.pretrain else False,
            device="cpu",
        )
        return real_infer(**kw)

    return infer


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    torch.set_num_threads(1)


EXAMPLES = {  # module -> the files its main() writes
    "ornstein_uhlenbeck": ("ou_posterior.png", "ou_posterior.npz"),
    "lotka_volterra": ("lotka_volterra_posterior.png", "lotka_volterra_posterior.npz"),
    "lorenz63": ("lorenz63_posterior.png", "lorenz63_posterior.npz"),
    "sir_epidemic": ("sir_posterior.png", "sir_posterior.npz"),
    "highdim_ou_dp": ("highdim_ou_posterior.npz",),
}


@pytest.mark.parametrize("module", sorted(EXAMPLES))
def test_example_main_runs(module, tmp_path, monkeypatch):
    example = importlib.import_module(f"examples_torch.{module}")
    seen = []
    # Lorenz-63's 2001-token grid is cut to its first 201 tokens: the
    # posterior's 500 samples at the full grid take minutes and tens of GB
    # on the CPU's plain attention
    real = tiny_infer(vtt.infer, 2, horizon=2.0 if module == "lorenz63" else None)

    def infer(**kw):
        posterior = real(**kw)
        seen.append(posterior)
        return posterior

    monkeypatch.setattr(vtt, "infer", infer)
    real_mesh = vtt.make_data_mesh
    monkeypatch.setattr(vtt, "make_data_mesh", lambda: real_mesh(device_type="cpu"))
    monkeypatch.chdir(tmp_path)
    try:
        example.main()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    (posterior,) = seen
    history = posterior.evidence_lower_bound_history
    assert len(history) == 2 and all(torch.isfinite(torch.tensor(history)))
    for name in EXAMPLES[module]:
        assert (tmp_path / name).stat().st_size > 0, name


def test_examples_without_a_gpu_refuse_cuda(monkeypatch):
    """No fallback hides the card: the examples' default device is CUDA, and
    without one the run raises instead of training on the CPU."""
    from examples_torch import quality_eval

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(Exception, match="(?i)cuda"):
        quality_eval.run_sir(2)
    with pytest.raises(Exception, match="(?i)cuda"):
        importlib.import_module("examples_torch.sir_epidemic").main()
