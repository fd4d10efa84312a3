"""ipm_iters_after_converged.forest: the IPM iterations a cycle run after
every QP of the call met the exit test, sum over the _ipm calls of
ipm.iters_run - ipm.iters_converged (the program's counters) over the
cycles of the stretch of a counters-only graph (program_trace.py).  None
where the program has no tracer or the cycle made no _ipm call."""
import program_trace


def probe(ctx):
    return program_trace.run(ctx)


def read(rec):
    r = program_trace.result(rec)
    if r is None or "ipm.iters_run" not in r.counters:
        return None
    extra = sum(float((run.double() - conv.double()).sum())
                for run, conv in zip(r.counters["ipm.iters_run"],
                                     r.counters["ipm.iters_converged"]))
    return extra / r.cycles
