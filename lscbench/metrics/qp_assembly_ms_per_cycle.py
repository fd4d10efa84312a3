"""qp_assembly_ms_per_cycle (random1024) and qp_assembly_ms_per_cycle.forest:
device ms a cycle of the QP's assembly (the warm start, the cost, the
static and plane rows, up to the solve's call), from the program's stage
stamps (program_trace.py).  None where the program has no tracer."""
import program_trace


def probe(ctx):
    return program_trace.run(ctx)


def read(rec):
    return program_trace.stage_ms(rec, "qp_assembly")
