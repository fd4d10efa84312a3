"""CPU tests of the program trace (program_trace.py) and its per-layer
readers: on the tiny cells of test_lscbench.py, on a record as the card
gives one, on a program without a tracer, and their imports.

    python -m pytest lscbench/ -q
"""
from __future__ import annotations

import json
import subprocess
import sys
import types
from pathlib import Path

import pytest
import torch

BENCH = Path(__file__).resolve().parent
sys.path.insert(0, str(BENCH))

import cell as cell_mod  # noqa: E402
import program_trace  # noqa: E402
import run  # noqa: E402
from test_lscbench import (one_thread, port_on_cpu, run_line,  # noqa: E402,F401
                           tiny_root)

STAGE_METRICS = ("planes_ms_per_cycle", "qp_assembly_ms_per_cycle",
                 "ipm_ms_per_cycle")
READERS = STAGE_METRICS + ("world_ms_per_cycle.forest",
                           "ipm_qp_iters_stretch",
                           "ipm_iters_after_converged.forest",
                           "replay_launch_ms", "setup_graph_s")


@pytest.mark.parametrize("cell", ["tiny_empty", "tiny_forest"])
def test_program_trace_readers_on_the_tiny_cells(tmp_path, capsys, cell):
    """The stage and counter readers read the port's stamps and counters on
    the CPU; the graph's spans (replay, set-up) and the fused kernel's
    counts are not there to read (no graph, no fused call on the CPU)."""
    root, bench = tiny_root(tmp_path, k=2)
    rc, line = run_line(capsys, root, bench, cell, port_on_cpu(), trace=1)
    assert rc == 0 and line["correct"] is True
    got = line["metrics"]
    forest = cell == "tiny_forest"
    sfx = ".forest" if forest else ""
    names = [m + sfx for m in STAGE_METRICS]
    if forest:
        names.append("world_ms_per_cycle.forest")
        iters = got["ipm_iters_after_converged.forest"]["value"]
        assert 0 < iters < 40
    for name in names:
        assert got[name]["value"] > 0, name
        assert got[name]["unit"] == "ms/cycle"
    for name in ("replay_launch_ms" + sfx, "setup_graph_s",
                 "ipm_qp_iters_stretch"):
        assert name not in got


def test_program_trace_readers_on_a_record():
    """Each reader's arithmetic on a program trace as the card gives one,
    and None where the program has no tracer."""
    c = cell_mod.find("forest20")
    r = program_trace.Result(
        stage_ms={"planes": 1.0, "goal": 0.25, "sfc": 0.5, "ipm": 2.0,
                  "qp_assembly": 0.5}, cycles=4,
        counters={"ipm.qp_iters": [torch.tensor([[2, 4], [6, 8]])] * 2,
                  "ipm.iters_run": [torch.tensor([40, 40])] * 2,
                  "ipm.iters_converged": [torch.tensor([10, 30])] * 2},
        replay_ms=[3.0, 1.0, 2.0], setup_graph_s=1.5)
    want = {"planes_ms_per_cycle": 1.0, "qp_assembly_ms_per_cycle": 0.5,
            "ipm_ms_per_cycle.forest": 2.0, "world_ms_per_cycle.forest": 0.75,
            "ipm_qp_iters_stretch": 5.0,
            "ipm_iters_after_converged.forest": 20.0,
            "replay_launch_ms": 2.0, "setup_graph_s": 1.5}
    for name, value in want.items():
        rec = types.SimpleNamespace(probes={"any": {}, name: r})
        assert c.reader(name).read(rec) == pytest.approx(value), name
        rec = types.SimpleNamespace(probes={name: None})
        assert c.reader(name).read(rec) is None, name
    older = types.SimpleNamespace(
        program=types.SimpleNamespace(package=json), cache={})
    assert program_trace.run(older) is None


_IMPORT_READERS = """
import json, sys
sys.path[:0] = [{bench!r}, {root!r}]
import program_trace
import cell
c = cell.find('random1024')
for m in {readers!r}:
    c.reader(m)
import lsc_planner_tpu_torch.trace
print(json.dumps(sorted({{m.split('.', 1)[0] for m in sys.modules}})))
"""


def test_the_program_trace_loads_no_jax():
    """program_trace, its readers and the port's tracer load nothing with
    the top-level name jax, jaxlib, flax or lsc_planner_tpu."""
    p = subprocess.run([sys.executable, "-c", _IMPORT_READERS.format(
        bench=str(BENCH), root=str(BENCH.parent), readers=READERS)],
        capture_output=True, text=True, timeout=300,
        env={"PATH": "/usr/bin:/bin", "USE_FLAX": "0"})
    assert p.returncode == 0, p.stderr
    top = set(json.loads(p.stdout.strip().splitlines()[-1]))
    assert "lsc_planner_tpu_torch" in top
    assert not top & set(run.FORBIDDEN), top & set(run.FORBIDDEN)
