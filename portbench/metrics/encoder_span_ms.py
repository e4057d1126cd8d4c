"""``encoder_span_ms`` (ms/step): the device time per traced step of the
kernels in the program's ``encoder`` and ``encoder.bwd`` device spans,
their own (the ``attention`` and ``attention.bwd`` children excluded): the
encoder's grid and cond setup, projections, norms, modulations, residuals
and MLPs, forward and backward. Layer: encoder (dense) (``models/encoder.py``,
``ops/sit.py``, ``ops/cond.py``, ``ops/mlp.py``, ``ops/norms.py``)."""

from portbench.harness.spans import family_ms


def read(run):
    return family_ms(run, "encoder")
