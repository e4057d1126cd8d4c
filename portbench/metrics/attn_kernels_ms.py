"""``attn_kernels_ms`` (ms/step): the device time per traced step of the
encoder attention's kernels K3-K7 (QK prep forward and backward, the flash
forward and its two backward kernels), by the profiler's kernel names.
Layer: encoder attention (``ops/attention.py``, ``ops/qk_prep.py``,
``ops/flash_attention.py``)."""

import re

KERNELS = ("K3", "K4", "K5", "K6", "K7")


def read(run):
    patterns = [re.compile(run.work.KERNEL_NAMES[k]) for k in KERNELS]
    s = run.trace.kernel_s(lambda name: any(p.search(name) for p in patterns))
    return None if s <= 0 else s * 1e3 / run.trace.steps
