"""viforsdes_tpu_torch: the PyTorch/CUDA port of viforsdes_tpu.

Black-box variational inference for SDEs (Ryder et al., ICML 2018) on an
NVIDIA GPU: the same API, ELBO and parameter layout as the JAX package, with
the fused path sampler, the QK-prep pass and flash attention as hand-written
CUDA kernels (``csrc/``). The JAX package is the reference the port is tested
against.
"""

from viforsdes_tpu_torch.config import (
    ComputeDtype,
    EncoderConfig,
    HeadConfig,
    PretrainConfig,
    TrainingConfig,
)
from viforsdes_tpu_torch.core import (
    SDE,
    FunctionalSDE,
    GaussianObservationLikelihood,
    ObservationLikelihood,
    Observations,
    Prior,
    PriorType,
    StateSpace,
    euler_maruyama,
    make_sde,
)
from viforsdes_tpu_torch.infer import InferenceConfig, infer
from viforsdes_tpu_torch.inference.trainer import TrainingState, VariationalInferenceTrainer
from viforsdes_tpu_torch.models.model import VariationalSDEPosterior
from viforsdes_tpu_torch.parallel.mesh import make_data_mesh
from viforsdes_tpu_torch.posterior.posterior import VariationalPosterior
from viforsdes_tpu_torch.utils.console import Console

__version__ = "0.1.0"

__all__ = [
    "SDE",
    "FunctionalSDE",
    "make_sde",
    "euler_maruyama",
    "Observations",
    "ObservationLikelihood",
    "GaussianObservationLikelihood",
    "Prior",
    "PriorType",
    "StateSpace",
    "InferenceConfig",
    "infer",
    "VariationalInferenceTrainer",
    "TrainingState",
    "VariationalPosterior",
    "VariationalSDEPosterior",
    "TrainingConfig",
    "EncoderConfig",
    "HeadConfig",
    "PretrainConfig",
    "ComputeDtype",
    "Console",
    "make_data_mesh",
]
