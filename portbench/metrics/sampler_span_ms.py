"""``sampler_span_ms`` (ms/step): the device time per traced step of every
kernel in the program's ``sampler`` and ``sampler.bwd`` device spans: the
gate projections of the context and theta, K1, K2's gate pass, BPTT and
weight gradients, and the head's weight packing. Layer: path sampler
(``models/head.py``, ``ops/sde_sampler.py``)."""

from portbench.harness.spans import family_ms


def read(run):
    return family_ms(run, "sampler")
