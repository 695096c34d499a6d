"""moe_syncs_per_step: host syncs of the routed MoE FFN (the program's
``layers.MOE_STATS["host_syncs"]``, one a routed call) per model step of
the window."""


def read(run):
    steps = [s for s in run.steps if s.kind != "idle"]
    if not steps:
        return None
    return sum(s.moe_syncs for s in steps) / len(steps)
