"""``dense_ops_ms`` (ms/step): the device time per traced step of every
kernel that neither the path sampler's nor the attention's list names: the
encoder's projections, norms, modulations and elementwise ops (cuBLAS and
PyTorch's kernels), the ELBO, AdamW and the EMA. Layer: dense ops
(``models/encoder.py``, ``ops/sit.py``, ``ops/cond.py``, ``ops/mlp.py``,
``ops/norms.py``, ``inference/elbo.py``, ``inference/optimizer.py``,
``inference/ema.py``)."""

import re

SAMPLER = "sde_sampler::"
ATTENTION = ("K3", "K4", "K5", "K6", "K7")


def read(run):
    patterns = [re.compile(run.work.KERNEL_NAMES[k]) for k in ATTENTION]

    def dense(name):
        return SAMPLER not in name and not any(p.search(name) for p in patterns)

    s = run.trace.kernel_s(dense)
    return None if s <= 0 else s * 1e3 / run.trace.steps
