"""``sampler_ms`` (ms/step): the device time per traced step of every
kernel in the path sampler's ``sde_sampler::`` namespace (K1's forward, K2's
gate pass, BPTT and weight gradients). Layer: the path sampler
(``models/head.py``, ``ops/sde_sampler.py``, ``csrc/sde_sampler_*.cu``)."""

PATTERN = "sde_sampler::"


def read(run):
    s = run.trace.kernel_s(lambda name: PATTERN in name)
    return None if s <= 0 else s * 1e3 / run.trace.steps
