"""setup_graph_s: seconds of the window graph's warm-up cycle and capture
(the program's set-up spans graph.warm_up and graph.capture of the first
graph the process captured), a part of setup_s (program_trace.py).  None
where the program has no tracer or captured no graph."""
import program_trace


def probe(ctx):
    return program_trace.run(ctx)


def read(rec):
    r = program_trace.result(rec)
    return None if r is None else r.setup_graph_s
