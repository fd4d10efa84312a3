"""ipm_ms_per_cycle (random1024) and ipm_ms_per_cycle.forest: device ms a
cycle of the IPM stage (solve_qp_lsc's fused kernel, or _ipm on the chol
kernels with its PyTorch ops, and the solution's recovery), from the
program's stage stamps (program_trace.py).  None where the program has no
tracer."""
import program_trace


def probe(ctx):
    return program_trace.run(ctx)


def read(rec):
    return program_trace.stage_ms(rec, "ipm")
