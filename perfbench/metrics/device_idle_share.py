"""device_idle_share: the share of the traced slice's wall in which no
operation ran on the device (1 - union of the profiler's device
intervals over the slice), in %; on several cards, the mean of each
card's."""


def read(run):
    if run.device is None or run.device.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.device.busy_s / run.device.window_s)
