"""device_idle_share: the share of the traced stretch's host wall (its
outer span) in which nothing ran on the device, in %: 100 * (1 - the
union of the device's kernel, copy and set intervals in the trace, clipped
to that wall / the wall).  Gaps between kernels inside a replay count as
idle.  None without device intervals in the trace (a CPU run)."""


def read(rec):
    t = rec.trace
    if not t or t["window_s"] <= 0 or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
