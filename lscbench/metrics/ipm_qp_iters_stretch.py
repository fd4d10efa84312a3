"""ipm_qp_iters_stretch: the mean over every QP of every cycle of the
fused IPM kernel's own per-QP iteration count (the program's counter
ipm.qp_iters) over the stretch of a counters-only graph
(program_trace.py).  None where the program has no tracer or the cycle
made no fused call."""
import torch

import program_trace


def probe(ctx):
    return program_trace.run(ctx)


def read(rec):
    r = program_trace.result(rec)
    counts = r.counters.get("ipm.qp_iters") if r else None
    if not counts:
        return None
    return float(torch.cat([c.reshape(-1) for c in counts]).double().mean())
