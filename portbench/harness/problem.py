"""A cell's inputs, made by the benchmark: the SDE, the observations, the
sizes, and the weights drawn from ``--seed`` on the device. Both the
program and the reference are handed these."""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import Tensor

from portbench.harness.spec import BENCH_DIR, load_json, load_module
from portbench.reference import model as M
from portbench.reference.train import Problem, stream_seed

KIND_CODES = {"const": 0, "uniform": 1, "normal": 2, "trunc": 3, "chol_bias": 0}


def make_sde(config: dict):
    return load_module(BENCH_DIR / "sdes" / f"{config['sde']}.py", config["sde"]).SDE()


def observations(config: dict) -> tuple[np.ndarray, np.ndarray]:
    """The configuration's observation times (float64) and values
    ``[T_obs, obs_dim]`` (float32), those within its time horizon."""
    record = load_json(BENCH_DIR / "data" / f"{config['data']}.json")
    times = np.asarray(record["times"], dtype=np.float64)
    keep = times <= config["time_horizon"] + 1e-9
    return times[keep], np.asarray(record["values"], dtype=np.float32)[keep]


def shapes(config: dict, obs_dim: int, sde) -> M.Shapes:
    enc, head = config["encoder"], config["head"]
    return M.Shapes(
        obs_dim=obs_dim,
        state_dim=sde.state_dim,
        param_dim=sde.sde_param_dim,
        hidden=enc["hidden_dim"],
        cond=enc["cond_dim"],
        heads=enc["num_heads"],
        depth=enc["depth"],
        mlp_hidden=int(enc["hidden_dim"] * enc["mlp_ratio"]),
        head_hidden=head["hidden_dim"],
        head_layers=head["num_layers"],
        n_grid=int(round(config["time_horizon"] / config["time_step"])) + 1,
    )


def problem(config: dict, traffic: dict, device: torch.device | str) -> Problem:
    """The reference's view of the cell, its tensors on ``device``."""
    sde = make_sde(config)
    times, values = observations(config)
    s = shapes(config, values.shape[-1], sde)
    pos = torch.zeros(s.param_dim, dtype=torch.bool)
    pos[config["sde_param_positive_dims"]] = True
    spos = torch.zeros(s.state_dim, dtype=torch.bool)
    spos[config["state_positive_dims"]] = True
    return Problem(
        shapes=s,
        sde=sde,
        obs_times=times,
        obs_values=torch.as_tensor(values, device=device),
        obs_variance=float(config["obs_variance"]),
        prior_type=config["prior"]["type"],
        prior_mean=float(config["prior"]["mean"]),
        prior_std=float(config["prior"]["std"]),
        param_positive=pos.to(device),
        state_positive=spos.to(device),
        time_step=float(config["time_step"]),
        batch_size=int(traffic["batch_size"]),
        iw_samples=int(traffic["iw_samples"]),
        grad_accum_steps=int(traffic["grad_accum_steps"]),
        learning_rate=float(config["learning_rate"]),
        sde_param_lr=float(config["sde_param_lr"]),
        grad_clip_norm=float(config["grad_clip_norm"]),
        theta_warmup_steps=int(config["theta_warmup_steps"]),
    )


def weight_specs(config: dict, s: M.Shapes) -> list[tuple[str, tuple[int, ...], str, float]]:
    return M.leaf_specs(s) + M.theta_specs(s.param_dim, float(config["sde_param_init_std"]))


def make_weights(config: dict, s: M.Shapes, seed: int, device: torch.device | str) -> dict[str, Tensor]:
    """Every parameter (``reference.model.leaf_specs``), fp32 on ``device``,
    from one uniform and one normal draw of a generator on the device seeded
    from ``seed``: uniform leaves
    ``(2u - 1) a``, normal ``n a``, truncated normal by the inverse CDF of
    ``u`` within two standard deviations, constants as given."""
    specs = weight_specs(config, s)
    sizes = [math.prod(shape) for _, shape, _, _ in specs]
    total = sum(sizes)
    gen = torch.Generator(device=device).manual_seed(stream_seed(seed, 0))
    u = torch.rand(total, generator=gen, device=device)
    n = torch.randn(total, generator=gen, device=device)
    counts = torch.tensor(sizes, device=device)
    code = torch.repeat_interleave(torch.tensor([KIND_CODES[k] for _, _, k, _ in specs], device=device), counts)
    arg = torch.repeat_interleave(torch.tensor([a for *_, a in specs], dtype=torch.float32, device=device), counts)
    lo = math.erf(-2.0 / math.sqrt(2.0))
    trunc = math.sqrt(2.0) * torch.erfinv(lo + u * (-2.0 * lo))
    flat = torch.where(code == 1, (2.0 * u - 1.0) * arg,
                       torch.where(code == 2, n * arg, torch.where(code == 3, trunc * arg, arg)))
    out = {path: piece.view(shape) for (path, shape, _, _), piece in zip(specs, torch.split(flat, sizes))}
    for path, _, kind, _ in specs:
        if kind == "chol_bias":
            out[path] = M.chol_bias(s.state_dim, device)
    return out
