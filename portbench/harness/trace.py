"""Reading one traced window: the device's operations and the host's spans
on one timeline, from the profiler's Chrome trace.

The traced window is a ``record_function`` span named ``WINDOW`` on the
host. Device operations (kernels, copies, fills) are clipped to it; the
device is busy on the union of their intervals, and idle elsewhere inside
the window. Each idle gap is named by the innermost host span that holds
its start: what the host was doing while the device waited.
"""

from __future__ import annotations

import json
from collections import defaultdict
from dataclasses import dataclass, field
from pathlib import Path

WINDOW = "portbench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation", "python_function")


@dataclass
class Op:
    name: str
    start: float  # microseconds
    end: float
    cat: str = "kernel"

    @property
    def dur(self) -> float:
        return self.end - self.start


@dataclass
class Trace:
    """The window ``[start, end]`` (microseconds), the device operations
    and the host spans inside it, and the training steps it held."""

    start: float
    end: float
    device: list[Op]
    host: list[Op]
    steps: int
    busy: list[tuple[float, float]] = field(default_factory=list)

    def __post_init__(self) -> None:
        self.busy = union(self.device)

    @property
    def window_s(self) -> float:
        return (self.end - self.start) * 1e-6

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy) * 1e-6

    def kernel_s(self, match) -> float:
        """Device seconds of the kernels (not copies or fills) whose names
        ``match`` accepts."""
        return sum(op.dur for op in self.device if op.cat == "kernel" and match(op.name)) * 1e-6

    def gaps(self) -> list[tuple[float, float]]:
        """The idle intervals of the window, longest first."""
        out = []
        t = self.start
        for a, b in [*self.busy, (self.end, self.end)]:
            if a > t:
                out.append((t, a))
            t = max(t, b)
        return sorted(out, key=lambda g: g[0] - g[1])

    def named_gaps(self, n: int) -> list[tuple[str, float]]:
        """The ``n`` longest idle intervals in seconds, each named by the
        innermost host span that holds its start ("none" where no span
        does)."""
        return [(self._host_at(a), (b - a) * 1e-6) for a, b in self.gaps()[:n]]

    def _host_at(self, t: float) -> str:
        best = None
        for op in self.host:
            if op.start <= t < op.end and op.name != WINDOW and (best is None or op.dur < best.dur):
                best = op
        return "none" if best is None else best.name

    def breakdown(self, n: int = 10) -> dict:
        by_name: dict[str, float] = defaultdict(float)
        for op in self.device:
            by_name[op.name] += op.dur * 1e-6
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:n]
        return {"device_ops": [[k, v] for k, v in ops], "idle_gaps": [[k, v] for k, v in self.named_gaps(n)]}


def union(ops: list[Op]) -> list[tuple[float, float]]:
    """The union of the operations' intervals, as sorted disjoint pieces."""
    out: list[tuple[float, float]] = []
    for a, b in sorted((op.start, op.end) for op in ops):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def from_events(events: list[dict], steps: int) -> Trace:
    """A ``Trace`` from Chrome-trace events (``traceEvents``)."""
    windows = [e for e in events if e.get("name") == WINDOW and e.get("cat") == "user_annotation"]
    if len(windows) != 1:
        raise RuntimeError(f"expected one {WINDOW!r} span in the trace, found {len(windows)}")
    w0 = float(windows[0]["ts"])
    w1 = w0 + float(windows[0]["dur"])
    device, host = [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        a = float(e["ts"])
        b = a + float(e["dur"])
        cat = e.get("cat")
        if cat in DEVICE_CATS:
            a, b = max(a, w0), min(b, w1)
            if b > a:
                device.append(Op(e["name"], a, b, cat))
        elif cat in HOST_CATS and b > w0 and a < w1:
            host.append(Op(e["name"], a, b, cat))
    return Trace(w0, w1, device, host, steps)


def read_chrome_trace(path: Path, steps: int) -> Trace:
    return from_events(json.loads(Path(path).read_text())["traceEvents"], steps)
