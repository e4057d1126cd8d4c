"""``unspanned_ms`` (ms/step): the device time per traced step of the
window's kernels outside the encoder, attention, sampler, ELBO and
optimizer spans: the draws and the copies before each replay, ``theta``
(rsample, repeat), ``grads.tail`` (theta's backward and the flat gradient
buffers), the step's own (gradient sums, the metrics row) and anything
unmarked. Markers excluded. Layer: whole step."""

from portbench.harness.spans import FAMILIES, split


def read(run):
    s = split(run.trace)
    if s is None:
        return None
    return (s.total_s() - sum(s.family_s(f) for f in FAMILIES)) * 1e3 / run.trace.steps
