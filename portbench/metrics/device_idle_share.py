"""``device_idle_share`` (%): the share of the traced window's wall span in
which no operation runs on the device, from the union of the device's
operation intervals on the one traced timeline. Layer: the trainer's host
loop (``inference/trainer.py``, ``inference/chunk.py``)."""


def read(run):
    if run.trace.window_s <= 0 or run.trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
