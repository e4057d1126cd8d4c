"""Driving the program under test, ``viforsdes_tpu_torch``, from outside:
its trainer built for a cell, the benchmark's weights copied into it, its
own ``train()`` run for whole chunks of ``steps_per_call`` steps, and its
state read.

The trainer keeps its parameters, EMA and AdamW moments in flat buffers
that a captured CUDA graph holds by address, so every write here is an
in-place copy. The trainer has no public hooks for this yet, so the
harness reaches the names in ``TRAINER_NAMES``, private ones among them;
a trainer that lacks one is refused with its name.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import Tensor


TRAINER_NAMES = ("params", "layout", "flat_params", "flat_ema", "opt_state", "state_tensors", "draws", "step",
                 "train", "evidence_lower_bound_history", "best_evidence_lower_bound", "_step_math",
                 "_completed_steps", "_train_chunks")


def leaves(tree, prefix: str = "") -> dict[str, Tensor]:
    """``{path: leaf}`` of a nested dict/list tree, paths joined by "/"."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(leaves(tree[k], f"{prefix}{k}/"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, t in enumerate(tree):
            out.update(leaves(t, f"{prefix}{i}/"))
        return out
    return {prefix[:-1]: tree}


class Program:
    """One trainer of the program for a cell, built from the cell's inputs."""

    def __init__(self, config: dict, traffic: dict, sde, times: np.ndarray, values: np.ndarray, seed: int,
                 device: str) -> None:
        import viforsdes_tpu_torch as vtt

        self.traffic = traffic
        k = int(traffic["steps_per_call"])
        training = vtt.TrainingConfig(
            time_step=config["time_step"],
            batch_size=traffic["batch_size"],
            n_iterations=k,
            learning_rate=config["learning_rate"],
            sde_param_lr=config["sde_param_lr"],
            grad_clip_norm=config["grad_clip_norm"],
            compute_dtype=traffic["compute_dtype"],
            theta_warmup_steps=config["theta_warmup_steps"],
            iw_samples=traffic["iw_samples"],
            grad_accum_steps=traffic["grad_accum_steps"],
            steps_per_call=k,
            theta_full_covariance=config["theta_full_covariance"],
        )
        self.trainer = vtt.VariationalInferenceTrainer(
            sde=sde,
            observations=vtt.Observations(times=times, values=values),
            observation_likelihood=vtt.GaussianObservationLikelihood(variance=config["obs_variance"]),
            prior=vtt.Prior(type=vtt.PriorType[config["prior"]["type"]], mean=config["prior"]["mean"],
                            std=config["prior"]["std"], dim=sde.sde_param_dim),
            time_horizon=config["time_horizon"],
            config=training,
            encoder_config=vtt.EncoderConfig(**config["encoder"]),
            head_config=vtt.HeadConfig(**config["head"]),
            state_positive_dims=config["state_positive_dims"],
            sde_param_positive_dims=config["sde_param_positive_dims"],
            console=vtt.Console(enabled=False),
            sde_param_init_std=config["sde_param_init_std"],
            seed=seed,
            device=device,
        )
        missing = [a for a in TRAINER_NAMES if not hasattr(self.trainer, a)]
        if missing:
            raise AttributeError(f"the program's VariationalInferenceTrainer has no {', '.join(missing)}, which "
                                 "portbench/harness/program.py reaches: mend it to the trainer's names")

    # ------------------------------------------------------------- state

    def params(self) -> dict[str, Tensor]:
        return leaves(self.trainer.params)

    def unpack(self, flats: dict[str, Tensor]) -> dict[str, Tensor]:
        return leaves(self.trainer.layout.unpack(flats))

    def snapshot(self) -> dict[str, dict[str, Tensor]]:
        """Copies of the flat params, EMA and AdamW first moments, on the
        host, so that they add nothing to the card's peak."""
        t = self.trainer
        groups = {"params": t.flat_params, "ema": t.flat_ema, "mu": t.opt_state["mu"]}
        return {name: {g: v.detach().to("cpu", copy=True) for g, v in flats.items()}
                for name, flats in groups.items()}

    @torch.no_grad()
    def load(self, weights: dict[str, Tensor]) -> None:
        """Start from ``weights``: the params and the EMA equal to them, the
        AdamW moments and counters zero, no step taken."""
        mine = self.params()
        if set(mine) != set(weights):
            raise ValueError(f"the program's leaves differ from the benchmark's: "
                             f"{sorted(set(mine) ^ set(weights))[:8]}")
        for path, leaf in mine.items():
            if tuple(leaf.shape) != tuple(weights[path].shape):
                raise ValueError(f"{path}: the program's shape {tuple(leaf.shape)}, "
                                 f"the benchmark's {tuple(weights[path].shape)}")
            leaf.copy_(weights[path])
        t = self.trainer
        for g in t.flat_params:
            t.flat_ema[g].copy_(t.flat_params[g])
            t.opt_state["mu"][g].zero_()
            t.opt_state["nu"][g].zero_()
        for k in ("count", "notfinite_count", "total_notfinite"):
            t.opt_state[k].zero_()
        t.step = 0
        t._completed_steps = 0
        t.evidence_lower_bound_history = []
        t.best_evidence_lower_bound = float("-inf")

    # ------------------------------------------------------------ running

    @property
    def completed(self) -> int:
        return self.trainer._completed_steps

    def train_to(self, n_steps: int):
        """The program's ``train()`` from its next step to ``n_steps``."""
        t = self.trainer
        t.config = t.config.model_copy(update={"n_iterations": int(n_steps)})
        return t.train(update_interval=int(self.traffic["update_interval"]))

    def observe(self, at: tuple[int, ...]) -> dict[int, dict]:
        """Snapshots after each step in ``at`` (1-based) of the trainer's
        next steps, taken as the program's own step returns (the step's
        work is enqueued on the stream that runs it, and so is the copy).
        The hook steps aside after the last of them."""
        t = self.trainer
        inner = t._step_math
        planted = t.__dict__.get("_step_math")
        seen: dict[int, dict] = {}
        calls = [0]

        def step_math(*args, **kwargs):
            out = inner(*args, **kwargs)
            calls[0] += 1
            if calls[0] in at:
                seen[calls[0]] = self.snapshot()
                if calls[0] == max(at):
                    if planted is None:
                        del t._step_math
                    else:
                        t._step_math = planted
            return out

        t._step_math = step_math
        return seen

    def chunk(self):
        """The trainer's runner of ``steps_per_call`` steps (its CUDA graph,
        and in ``metrics`` the rows ``[K, 8 + P]`` of its latest call: ELBO,
        its five terms, the gradient norm, the non-finite count, theta's
        means), or None before the first chunk."""
        return self.trainer._train_chunks.get(int(self.traffic["steps_per_call"]))
