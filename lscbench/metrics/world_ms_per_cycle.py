"""world_ms_per_cycle.forest: device ms a cycle of the world's stages, the
goal planner's (grid search and wavefront) and the SFC corridor's
(update_sfc, its planes), from the program's stage stamps
(program_trace.py).  None where the program has no tracer."""
import program_trace


def probe(ctx):
    return program_trace.run(ctx)


def read(rec):
    return program_trace.stage_ms(rec, "goal", "sfc")
