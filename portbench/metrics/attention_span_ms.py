"""``attention_span_ms`` (ms/step): the device time per traced step of every
kernel in the program's ``attention`` and ``attention.bwd`` device spans (one
per block and microbatch): the QKV and output projections, the gate, the QK
prep (K3/K4 or the plain norms and RoPE), the flash kernels K5-K7 or the
dense SDPA, forward and backward. Layer: encoder attention
(``ops/attention.py``)."""

from portbench.harness.spans import family_ms


def read(run):
    return family_ms(run, "attention")
