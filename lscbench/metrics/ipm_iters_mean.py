"""ipm_iters_mean: the mean over the QPs of the fused IPM call of one
cycle from the window's last state of each QP's own iteration count (the
kernel's qp_counts; probes.fused_call).  None where the cycle made no
fused call."""
import probes


def probe(ctx):
    return probes.fused_call(ctx)


def read(rec):
    call = rec.probes.get("ipm_iters_mean")
    if not call:
        return None
    return float(call["qp_iters"].mean())
