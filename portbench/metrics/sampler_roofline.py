"""``sampler_roofline`` (%): the path sampler's forward and backward as
functions (``work.sampler_work``: FLOP and fp32 bytes from the head's
shapes, once per microbatch of a step) at their bound (TF32 tensor-core
rate for the fp32 inputs, or device memory), over the ``sde_sampler::``
kernels' device time per step. Layer: the path sampler."""

PATTERN = "sde_sampler::"


def read(run):
    s, t, w = run.shapes, run.traffic, run.work
    device_s = run.trace.kernel_s(lambda name: PATTERN in name)
    if device_s <= 0:
        return None
    micro = t["batch_size"] // t["grad_accum_steps"]
    flop, n_bytes = w.sampler_work(s.state_dim, s.head_hidden, s.head_layers, s.n_out, micro, s.n_grid - 1)
    per_step = w.bound(flop, n_bytes, "tf32")["bound_ms"] * t["grad_accum_steps"]
    return 100.0 * per_step / (device_s * 1e3 / run.trace.steps)
