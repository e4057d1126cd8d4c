"""``launches_per_step`` (launches/step): the device operations (kernels,
copies, fills) of the traced window per step, the program's span markers
excluded; read only where the markers show the program's spans. Layer:
whole step."""

from portbench.harness.spans import split


def read(run):
    s = split(run.trace)
    return None if s is None else s.total_ops() / run.trace.steps
