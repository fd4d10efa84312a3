"""aten_ms_per_cycle: device ms a cycle of every kernel in the traced
stretch that is not one of the port's own csrc/ kernels (PyTorch's
kernels of the cycle's tensor operations)."""
import tracing


def read(rec):
    t = rec.trace
    if not t or not t["kernels"]:
        return None
    s = sum(v[0] for key, v in t["kernels"].items()
            if not tracing.own_kernel(key))
    return 1e3 * s / t["cycles"]
