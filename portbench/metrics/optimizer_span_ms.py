"""``optimizer_span_ms`` (ms/step): the device time per traced step of every
kernel in the program's ``optimizer`` device span: the gradient's global
norm, AdamW, the theta scale, the update, the EMA and theta's means. Layer:
optimizer and EMA (``inference/optimizer.py``, ``inference/ema.py``)."""

from portbench.harness.spans import family_ms


def read(run):
    return family_ms(run, "optimizer")
