from viforsdes_tpu_torch.core.observations import (
    GaussianObservationLikelihood,
    ObservationLikelihood,
    Observations,
)
from viforsdes_tpu_torch.core.priors import Prior, PriorType
from viforsdes_tpu_torch.core.sde import SDE, FunctionalSDE, make_sde
from viforsdes_tpu_torch.core.solvers import euler_maruyama
from viforsdes_tpu_torch.core.state_space import StateSpace

__all__ = [
    "SDE",
    "FunctionalSDE",
    "make_sde",
    "Observations",
    "ObservationLikelihood",
    "GaussianObservationLikelihood",
    "Prior",
    "PriorType",
    "StateSpace",
    "euler_maruyama",
]
