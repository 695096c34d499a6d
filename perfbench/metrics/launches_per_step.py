"""launches_per_step: device kernels in the profiler's trace of the slice
(copies and fills not counted) per model step of the slice."""


def read(run):
    steps = [s for s in run.slice_steps if s.kind != "idle"]
    if run.device is None or not steps:
        return None
    return len(run.device.kernels()) / len(steps)
