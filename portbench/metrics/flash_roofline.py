"""``flash_roofline`` (%): the encoder's attention forward and backward as
functions (``work.flash_work``: six ``[S, S] x D`` products per block and
step, the bytes of q, k, v, o and their gradients in the compute dtype) at
their bound (bf16 989 or TF32 495 TFLOP/s by the cell's dtype, or device
memory), over K5-K7's device time per step. Layer: encoder attention."""

import re

KERNELS = ("K5", "K6", "K7")
ELEM_BYTES = {"bfloat16": 2, "float32": 4}


def read(run):
    s, t, w = run.shapes, run.traffic, run.work
    patterns = [re.compile(w.KERNEL_NAMES[k]) for k in KERNELS]
    device_s = run.trace.kernel_s(lambda name: any(p.search(name) for p in patterns))
    if device_s <= 0:
        return None
    dtype = t["compute_dtype"]
    micro = t["batch_size"] // t["grad_accum_steps"]
    flop, n_bytes = w.flash_work(micro, s.heads, s.n_grid, s.head_dim, ELEM_BYTES[dtype])
    per_step = s.depth * t["grad_accum_steps"] * w.bound(flop, n_bytes, w.TENSOR_PEAK[dtype])["bound_ms"]
    return 100.0 * per_step / (device_s * 1e3 / run.trace.steps)
