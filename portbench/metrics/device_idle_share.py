"""device_idle_share: the share of the traced segment's wall in which no
operation ran on the card, %: one less the union of the profiler's device
intervals over the segment's length."""


def read(run):
    if run.device is None or run.device.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.device.busy_s / run.device.window_s)
