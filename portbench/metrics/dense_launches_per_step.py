"""``dense_launches_per_step`` (launches/step): the device operations per
traced step in the ``encoder`` and ``encoder.bwd`` spans' own (their
attention children excluded), the ``elbo`` and ``elbo.bwd`` spans and the
``optimizer`` span: the launches that fusing the dense ops would lower.
Layer: encoder (dense)."""

from portbench.harness.spans import DENSE, split


def read(run):
    s = split(run.trace)
    return None if s is None else sum(s.ops[span] for span in DENSE) / run.trace.steps
