"""The program's device spans in one traced window: the training step split
into its layers by the marker kernels the program captures at each span
boundary (``viforsdes_tpu_torch/utils/profiling.py``, ``csrc/spans.cu``).

A marker's kernel name carries its span, by the span's index in ``SPANS``,
and whether it begins or ends it: ``spans::begin<i>``, ``spans::end<i>``.
The window's device operations are walked in time order with a stack of
open spans. Each operation that is not a marker goes to the innermost open
span, its self: a span's self is its operations less its children's. An
end marker closes its span and any span opened inside it that is still
open (its end was dropped); an end whose span is not open (its begin was
dropped) is passed over, so a dropped record moves no later operation.
Times count kernels alone, as ``Trace.kernel_s`` does; launch counts take
every device operation (kernels, copies, fills). Markers count in neither.

The benchmark keeps its own copy of the program's span table (a CPU test
holds the two equal), so it reads a program that has no spans, or other
ones, without importing them: there it finds no marker and reads None.
"""

from __future__ import annotations

import re
from collections import defaultdict
from dataclasses import dataclass, field

from portbench.harness.trace import Trace

SPANS = (
    "step", "theta", "encoder", "attention", "sampler", "elbo",
    "elbo.bwd", "sampler.bwd", "encoder.bwd", "attention.bwd", "grads.tail", "optimizer",
)
MARKER = re.compile(r"\bspans::(begin|end)<(\d+)>")

# the layers the per-layer metrics read, each the self of its spans
FAMILIES = {
    "encoder": ("encoder", "encoder.bwd"),
    "attention": ("attention", "attention.bwd"),
    "sampler": ("sampler", "sampler.bwd"),
    "elbo": ("elbo", "elbo.bwd"),
    "optimizer": ("optimizer",),
}
# the spans whose launches the fusion of the dense ops would lower
DENSE = ("encoder", "encoder.bwd", "elbo", "elbo.bwd", "optimizer")


@dataclass
class SpanSplit:
    """Per span (None: outside every span), the kernel seconds and the
    device operations of its self over the window, and the markers seen."""

    kernel_s: dict = field(default_factory=lambda: defaultdict(float))
    ops: dict = field(default_factory=lambda: defaultdict(int))
    markers: int = 0

    def family_s(self, family: str) -> float:
        return sum(self.kernel_s[s] for s in FAMILIES[family])

    def total_s(self) -> float:
        return sum(self.kernel_s.values())

    def total_ops(self) -> int:
        return sum(self.ops.values())


def split(trace: Trace) -> SpanSplit | None:
    """The window split by span; None where it holds no marker."""
    out = SpanSplit()
    stack: list[str] = []
    for op in sorted(trace.device, key=lambda op: (op.start, op.end)):
        m = MARKER.search(op.name) if op.cat == "kernel" else None
        if m is not None:
            out.markers += 1
            index = int(m.group(2))
            span = SPANS[index] if index < len(SPANS) else f"span{index}"
            if m.group(1) == "begin":
                stack.append(span)
            elif span in stack:
                while stack.pop() != span:
                    pass
            continue
        owner = stack[-1] if stack else None
        out.ops[owner] += 1
        if op.cat == "kernel":
            out.kernel_s[owner] += op.dur * 1e-6
    return out if out.markers else None


def family_ms(run, family: str) -> float | None:
    """ms per step of the kernels in ``family``'s spans."""
    s = split(run.trace)
    return None if s is None else s.family_s(family) * 1e3 / run.trace.steps
