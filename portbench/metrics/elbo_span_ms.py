"""``elbo_span_ms`` (ms/step): the device time per traced step of every
kernel in the program's ``elbo`` and ``elbo.bwd`` device spans: the
observation, SDE-transition, prior and posterior log-densities and the
importance weights, and their backward down to the head's outputs. Layer:
ELBO (``inference/elbo.py``)."""

from portbench.harness.spans import family_ms


def read(run):
    return family_ms(run, "elbo")
