"""Host spans and the traced stretch's arithmetic.

The benchmark records its own spans around each call into the program
(``Spans``); the program has none of its own yet.  In a ``--trace 1`` run
``profile`` runs a stretch of dispatches under ``torch.profiler`` (CPU and
CUDA activities) with the same spans as ``record_function`` ranges, and
reduces the trace in memory (no chrome trace is written) to: device time
and count by kernel, copies and sets apart; the union of the device's busy
intervals; and the device's idle gaps, each named by the innermost span
the host was in when it began.  The per-kernel sums and the picking out of
the port's own kernels by their ``(anonymous namespace)::`` names are
``scripts/profile_forest20_torch.py:63-67, 155-176`` (``device_us``,
``trace``).
"""
from __future__ import annotations

import contextlib
import time

import torch

SPAN_PREFIX = "lscbench."


class Spans:
    """(name, start s, end s) on the host clock, kept in memory; inside a
    profiled stretch each span is also a ``record_function`` range."""

    def __init__(self):
        self.items = []
        self.profiling = False

    @contextlib.contextmanager
    def __call__(self, name: str):
        t0 = time.perf_counter()
        if self.profiling:
            with torch.profiler.record_function(SPAN_PREFIX + name):
                yield
        else:
            yield
        self.items.append((name, t0, time.perf_counter()))


def device_us(evt) -> float:
    """An event's own device microseconds, under either attribute name
    of the PyTorch versions (profile_forest20_torch.py:63-67)."""
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def _is_device(evt) -> bool:
    return str(getattr(evt, "device_type", "")).endswith("CUDA")


def kernel_name(key: str) -> str:
    """The bare function name of a kernel's trace key: "void (anonymous
    namespace)::resolve_kernel<float, 2>(...)" -> "resolve_kernel"."""
    k = key.removeprefix("void ")
    k = k.split("(anonymous namespace)::", 1)[-1]
    for stop in ("<", "("):
        k = k.split(stop, 1)[0]
    return k


def own_kernel(key: str) -> bool:
    """Is the trace key one of the port's own csrc/ kernels (compiled in
    anonymous namespaces)?"""
    return key.removeprefix("void ").startswith("(anonymous namespace)::")


def profile(fn) -> dict:
    """Runs fn under torch.profiler and reduces the trace (see the module
    docstring).  Returns {"kernels": {key: [device s, count]}, "copies":
    {key: [device s, count]}, "busy_s", "window_s", "gaps": [(span, s)]
    longest first}."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
    kernels, copies = {}, {}
    for e in prof.key_averages():
        # the spans' record_function ranges come back as device-side
        # annotations too: they are the host's, not the device's work
        if not _is_device(e) or e.key.startswith(SPAN_PREFIX):
            continue
        into = copies if e.key.startswith(("Memcpy", "Memset")) else kernels
        into[e.key] = [device_us(e) * 1e-6, int(e.count)]
    dev, spans = [], []
    for e in prof.events():
        tr = getattr(e, "time_range", None)
        if tr is None:
            continue
        if e.name.startswith(SPAN_PREFIX):
            if not _is_device(e):
                spans.append((tr.start, tr.end, e.name[len(SPAN_PREFIX):]))
        elif _is_device(e):
            dev.append((tr.start, tr.end))
    dev.sort()
    merged = []
    for a, b in dev:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    outer = [s for s in spans if s[2] == "traced"]
    w0, w1 = (outer[0][0], outer[0][1]) if outer else (
        merged[0][0], merged[-1][1]) if merged else (0.0, 0.0)
    # busy time inside the stretch's own wall only
    merged = [[max(a, w0), min(b, w1)] for a, b in merged
              if min(b, w1) > max(a, w0)]
    busy = sum(b - a for a, b in merged)
    gaps = []
    inner = sorted((s for s in spans if s[2] != "traced"),
                   key=lambda s: s[1] - s[0])
    edges = [(w0, merged[0][0])] if merged else []
    edges += [(merged[i][1], merged[i + 1][0])
              for i in range(len(merged) - 1)]
    if merged:
        edges.append((merged[-1][1], w1))
    for a, b in edges:
        if b <= a:
            continue
        name = next((s[2] for s in inner if s[0] <= a < s[1]), "outside")
        gaps.append((name, (b - a) * 1e-6))
    gaps.sort(key=lambda g: -g[1])
    return {"kernels": kernels, "copies": copies, "busy_s": busy * 1e-6,
            "window_s": (w1 - w0) * 1e-6, "gaps": gaps}
