"""world_kernels_ms_per_cycle: device ms a cycle of the world layer's
kernels in the traced stretch: the wavefront (csrc/wavefront.cu,
wavefront_kernel) and the SFC face expansion (csrc/corridor.cu,
expand_kernel).  None where the stretch ran neither."""
import tracing

KERNELS = ("wavefront_kernel", "expand_kernel")


def read(rec):
    t = rec.trace
    if not t:
        return None
    hits = [v for key, v in t["kernels"].items()
            if tracing.own_kernel(key) and tracing.kernel_name(key) in KERNELS]
    if not hits:
        return None
    return 1e3 * sum(v[0] for v in hits) / t["cycles"]
