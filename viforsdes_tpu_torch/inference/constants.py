"""Shared constants (the values of ``viforsdes_tpu/inference/constants.py``)."""

from __future__ import annotations

from typing import Final

LOSS_EMA_DECAY: Final = 0.98
DIAG_MIN: Final = 1e-2
DEFAULT_EMA_DECAY: Final = 0.999

# Learnable observation variance (TrainingConfig.learn_obs_variance) is
# parameterized as ``floor + exp(log_variance)``: for noiseless data its
# honest optimum is 0, and an unbounded exp collapses the Gaussian likelihood
# to a point mass (obs term -> +inf). std = 1e-3 is far below every claimed
# variance in the benchmark ladder.
OBS_VARIANCE_FLOOR: Final = 1e-6

# Host-side divergence abort: training raises after this many CONSECUTIVE
# non-finite update steps (the optimizer keeps params at their last finite
# values meanwhile and never applies a non-finite update).
MAX_CONSECUTIVE_NONFINITE_STEPS: Final = 100
