"""fused_ipm_roofline: the fused IPM kernel's (csrc/ipm.cu) share of its
roofline, in %: roofline.fused_bound of the fused call of one cycle from
the window's last state (each QP at its own iteration count) over that
call's device time (CUDA events, relaunched; probes.fused_call).  None
where the cycle made no fused call."""
import probes
import roofline


def probe(ctx):
    return probes.fused_call(ctx)


def read(rec):
    call = rec.probes.get("fused_ipm_roofline")
    if not call or call["ms"] <= 0:
        return None
    bound_ms, _ = roofline.fused_bound(call["args"], call["kw"],
                                       call["outputs"],
                                       float(call["qp_iters"].sum()))
    return 100.0 * bound_ms / call["ms"]
