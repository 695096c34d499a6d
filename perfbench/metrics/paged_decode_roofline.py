"""paged_decode_roofline: the paged decode kernel's bound over its device
time in the traced slice, in %. The bound of each call is the larger of
its operations over peak operations a second and its bytes (q, the valid
K and V, out, each once) over peak bandwidth, summed over the slice's
calls: one an attention layer a step for each instance that had decode
lanes, the lanes and their valid keys as the harness saw them. The
device time is that of the kernels named below in the profiler's trace,
on every card."""

from benchlib.flops import bound_seconds, paged_decode_call

KERNELS = ("paged_split_kernel",)


def read(run):
    if run.device is None:
        return None
    kernel_s = sum(e - s for n, s, e in run.device.kernels()
                   if any(k in n for k in KERNELS))
    bound = 0.0
    for s in run.slice_steps:
        for lens in s.decode_calls():
            bound += run.dims.n_attn_layers * bound_seconds(
                *paged_decode_call(run.dims, lens))
    if kernel_s <= 0 or bound <= 0:
        return None
    return 100.0 * bound / kernel_s
