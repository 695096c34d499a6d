"""launches_per_step: device kernels in the profiler's trace of the slice,
on every card (copies and fills not counted), per cluster step of the
slice (every instance's engine step)."""


def read(run):
    steps = [s for s in run.slice_steps if s.kind != "idle"]
    if run.device is None or not steps:
        return None
    return len(run.device.kernels()) / len(steps)
