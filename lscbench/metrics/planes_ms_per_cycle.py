"""planes_ms_per_cycle (random1024) and planes_ms_per_cycle.forest: device
ms a cycle of the cycle's planes stage (K-NN pruning, the dynamic
obstacles' columns, the LSC planes), from the program's stage stamps over
the stretch of a stamps-only graph (program_trace.py).  None where the
program has no tracer."""
import program_trace


def probe(ctx):
    return program_trace.run(ctx)


def read(rec):
    return program_trace.stage_ms(rec, "planes")
