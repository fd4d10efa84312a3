"""replay_launch_ms (random1024) and replay_launch_ms.forest: the median
host span of a graph replay call (the program's span graph.replay, the
host's cudaGraphLaunch) over the stretch of a stamps-only graph
(program_trace.py), in ms.  None where the program has no tracer or ran
no graph."""
import statistics

import program_trace


def probe(ctx):
    return program_trace.run(ctx)


def read(rec):
    r = program_trace.result(rec)
    if r is None or not r.replay_ms:
        return None
    return statistics.median(r.replay_ms)
