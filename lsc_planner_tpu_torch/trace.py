"""The port's tracer: host spans, device stage stamps and device counters.

Tracing is off by default and switched by API only: ``enable(stamps=...,
counters=...)``, ``disable()`` and the context manager ``tracing(...)``.
While it is off ``span`` returns one shared null context, ``mark`` and
``count`` return at once, nothing is allocated and no ``record_function``
range is opened, so a graph captured then is node for node the untraced
cycle.  ``SyncSimulator.cycle_graph`` keys its graphs by ``graph_key()``:
an untraced dispatch never replays a stamped graph.

- **Spans** (``span(name)``): host intervals on ``perf_counter_ns``, kept
  in a bounded ring with the name of the span they nest in; while a
  profiler is active each is also a ``record_function("lsc." + name)``
  range, so the program's spans sit on the device trace's clock.  Set-up
  spans (``setup_span``: ``build.nvcc``, ``build.load``, ``sim.tables``,
  ``graph.warm_up``, ``graph.capture``) run once a process or a graph and
  are kept even with tracing off, in a ring of their own.
- **Stage stamps** (``mark(stage)``, with ``stamps`` on): each
  names the stage that starts at it (``STAGES``, then ``END`` after a
  dispatch), so consecutive marks tile the cycle.  On a CUDA device a mark
  launches ``csrc/trace.cu``'s one-thread kernel, which writes the
  device's ``%globaltimer`` into the mark's own int64 slot; a mark taken
  while a graph is captured owns a slot of that graph, and each replay
  rewrites it.  On the CPU, where ops are synchronous, a mark takes
  ``perf_counter_ns``.  ``calibrate`` pairs a synchronised stamp with the
  host clock, so device stamps also land on the host's timeline.
- **Counters** (``count(name, value)``, with ``counters`` on): a copy of a
  device tensor (or a host number) a call, stacked by ``counters``.
  Counting may add device work; stamps add one launch a mark and nothing
  else, so stage times are read from a graph captured with stamps only.

Marks and counts go to the innermost active ``Recording``: a captured
graph's own (``_CycleGraph.trace``), or one opened with ``recording`` for
an eager stretch; outside any they are dropped.  ``stamps`` and
``counters`` read a recording (or a graph's) in one copy each.
"""
from __future__ import annotations

import collections
import contextlib
import threading
import time
from typing import NamedTuple, Optional

import torch

STAGES = ("propagate", "predict", "goal", "planes", "sfc", "qp_assembly",
          "ipm", "audit")
END = "end"
SPAN_PREFIX = "lsc."
RING = 1 << 14
CHUNK = 1024            # stamp slots a device buffer


class Span(NamedTuple):
    name: str
    parent: Optional[str]       # the span it nests in, None at the top
    start_ns: int               # perf_counter_ns
    end_ns: int

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-9


class _Switch(NamedTuple):
    stamps: bool
    counters: bool


_on: Optional[_Switch] = None
_NULL = contextlib.nullcontext()
_ring = collections.deque(maxlen=RING)
_setup = collections.deque(maxlen=1024)
_local = threading.local()          # .stack: the open spans' names
_active = []                        # the recordings marks go to, innermost last
_calibration = (0, 0)


# ---------------------------------------------------------------- switch
def enable(stamps: bool = True, counters: bool = False) -> None:
    """Turns tracing on: spans, and stage stamps and/or counters."""
    global _on
    _on = _Switch(bool(stamps), bool(counters))


def disable() -> None:
    global _on
    _on = None


def counting() -> bool:
    return _on is not None and _on.counters


def graph_key():
    """What a captured graph depends on: None while tracing is off."""
    return None if _on is None else tuple(_on)


@contextlib.contextmanager
def tracing(stamps: bool = True, counters: bool = False):
    """Tracing on inside the block; the switch as it was after it."""
    global _on
    before = _on
    enable(stamps, counters)
    try:
        yield
    finally:
        _on = before


# ----------------------------------------------------------------- spans
def _profiling() -> bool:
    return torch._C._autograd._profiler_enabled()


class _Span:
    __slots__ = ("name", "into", "parent", "t0", "rf")

    def __init__(self, name, into):
        self.name, self.into = name, into

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        self.parent = stack[-1] if stack else None
        stack.append(self.name)
        self.rf = None
        if _on is not None and _profiling():
            self.rf = torch.profiler.record_function(SPAN_PREFIX + self.name)
            self.rf.__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        _local.stack.pop()
        self.into.append(Span(self.name, self.parent, self.t0, t1))
        return False


def span(name: str):
    """A host span while tracing is on; the shared null context else."""
    if _on is None:
        return _NULL
    return _Span(name, _ring)


def setup_span(name: str):
    """A set-up span, recorded with tracing on or off."""
    return _Span(name, _setup)


def spans() -> list:
    """Every kept span (set-up and dispatch), in order of start."""
    return sorted(list(_setup) + list(_ring), key=lambda s: s.start_ns)


def last_seconds(name: str) -> Optional[float]:
    """Seconds of the latest span called `name`; None when there is none."""
    hits = [s for s in spans() if s.name == name]
    return hits[-1].seconds if hits else None


def clear() -> None:
    """Forgets every kept span."""
    _ring.clear()
    _setup.clear()


# ---------------------------------------------------------- recordings
def _stamp_entry():
    from .ops import _build
    return _build.load_library().lsc_trace_stamp


class Recording:
    """The stage stamps and counters of an eager stretch or of one captured
    graph: ``stages`` names each mark in order; the times are in
    ``_slots`` (CUDA: int64 device buffers of CHUNK slots, made outside
    any capture where they can be) or ``_host`` (CPU)."""

    def __init__(self, device):
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        self.device = device
        self.stages = []
        self.counts = {}
        self._host = []
        self._slots = []

    def reset(self) -> None:
        """Forgets the marks and counts (the slots stay allocated)."""
        self.stages, self.counts, self._host = [], {}, []

    def mark(self, stage: str) -> None:
        i = len(self.stages)
        if self.device.type == "cuda":
            from .ops import _build
            c, j = divmod(i, CHUNK)
            if c == len(self._slots):
                self._slots.append(torch.empty(CHUNK, dtype=torch.int64,
                                               device=self.device))
            err = _build.launch(_stamp_entry(), self.device,
                                self._slots[c].data_ptr() + 8 * j)
            if err:
                raise RuntimeError(f"trace stamp launch failed: CUDA error "
                                   f"{err}")
        else:
            self._host.append(time.perf_counter_ns())
        self.stages.append(stage)

    def count(self, name: str, value) -> None:
        self.counts.setdefault(name, []).append(
            value.detach().clone() if torch.is_tensor(value) else value)

    def stamps(self) -> list:
        """[(stage, ns)] of every mark: the device's global timer on CUDA
        (the last replay's, for a graph), perf_counter_ns on the CPU."""
        n = len(self.stages)
        if self.device.type != "cuda":
            return list(zip(self.stages, self._host))
        if not n:
            return []
        flat = (self._slots[0] if len(self._slots) == 1
                else torch.cat(self._slots))
        return list(zip(self.stages, flat[:n].cpu().tolist()))

    def counters(self) -> dict:
        """{name: CPU tensor of the calls' values stacked}."""
        out = {}
        for name, vals in self.counts.items():
            ts = [v if torch.is_tensor(v) else torch.tensor(v)
                  for v in vals]
            out[name] = torch.stack(ts).cpu()
        return out


def new_recording(device) -> Optional[Recording]:
    """A recording for a graph about to be captured; None while tracing is
    off."""
    return None if _on is None else Recording(device)


@contextlib.contextmanager
def _into(rec: Recording):
    _active.append(rec)
    try:
        yield rec
    finally:
        _active.remove(rec)


def recording(target):
    """Marks and counts inside the block go to `target`: a Recording, or a
    device for a new one (yielded).  None: the shared null context."""
    if target is None:
        return _NULL
    if not isinstance(target, Recording):
        target = Recording(target)
    return _into(target)


def mark(stage: str) -> None:
    """A stage stamp in the innermost recording: `stage` starts here (see
    the module docstring).  Returns at once unless stamps are on."""
    if _on is None or not _on.stamps or not _active:
        return
    _active[-1].mark(stage)


def count(name: str, value) -> None:
    """Keeps a copy of `value` under `name`; at once unless counters are
    on."""
    if _on is None or not _on.counters or not _active:
        return
    _active[-1].count(name, value)


def _source(src) -> Recording:
    return getattr(src, "trace", src)


def stamps(src) -> list:
    """[(stage, ns)] of a Recording or of a captured graph (its last
    replay's), read in one copy; [] for a graph captured untraced."""
    rec = _source(src)
    return [] if rec is None else rec.stamps()


def counters(src) -> dict:
    """{name: stacked values} of a Recording or a captured graph."""
    rec = _source(src)
    return {} if rec is None else rec.counters()


def durations(marks) -> list:
    """[(stage, seconds)] from consecutive marks; the stretch after an END
    mark (between dispatches) is left out."""
    return [(a[0], (b[1] - a[1]) * 1e-9) for a, b in zip(marks, marks[1:])
            if a[0] != END]


# ------------------------------------------------------------ calibration
def calibrate(device, tries: int = 16) -> tuple:
    """(offset ns, uncertainty ns) of the device's stamp clock against
    perf_counter_ns: a stamp between two host reads, the device idle on
    both sides, the try with the narrowest bracket kept; host ns = device
    ns - offset.  Kept for ``to_host_ns``.  (0, 0) on the CPU."""
    global _calibration
    device = torch.device(device)
    if device.type != "cuda":
        _calibration = (0, 0)
        return _calibration
    rec = Recording(device)
    brackets = []
    for _ in range(tries):
        torch.cuda.synchronize(device)
        h0 = time.perf_counter_ns()
        rec.mark("calibrate")
        torch.cuda.synchronize(device)
        brackets.append((h0, time.perf_counter_ns()))
    best = min(((g - (h0 + h1) // 2, (h1 - h0) // 2)
                for (_, g), (h0, h1) in zip(rec.stamps(), brackets)),
               key=lambda ou: ou[1])
    _calibration = best
    return best


def to_host_ns(device_ns: int) -> int:
    """A device stamp on the host's perf_counter_ns clock (calibrate)."""
    return device_ns - _calibration[0]
