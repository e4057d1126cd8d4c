"""Result containers for the inference pipeline (twin of
``viforsdes_tpu/inference/types.py``)."""

from dataclasses import dataclass
from typing import NamedTuple, TYPE_CHECKING

from torch import Tensor

if TYPE_CHECKING:
    from viforsdes_tpu_torch.core.state_space import StateSpace


@dataclass(frozen=True)
class DiffusionPathSample:
    """A batch of sampled latent paths plus their transition parameters.

    z: [B, T+1, D] latent paths; transition_means [B, T, D];
    transition_cholesky [B, T, D, D] (full) or [B, T, D] (diag).
    """

    z: Tensor
    transition_means: Tensor
    transition_cholesky: Tensor
    state_space: "StateSpace"

    @property
    def x(self) -> Tensor:
        return self.state_space.to_state(self.z)

    def log_jacobian(self) -> Tensor:
        """Sum over time of per-step log-Jacobians of z->x."""
        return self.state_space.log_jacobian(self.z[:, 1:]).sum(dim=-1)


class EvidenceLowerBoundComponents(NamedTuple):
    observation_log_prob: Tensor
    sde_log_prob: Tensor
    generative_log_prob: Tensor
    prior_log_prob: Tensor
    posterior_log_prob: Tensor


class EvidenceLowerBoundResult(NamedTuple):
    evidence_lower_bound: Tensor
    components: EvidenceLowerBoundComponents
