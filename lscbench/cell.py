"""A cell's pieces, found by name, and each side's inputs built from them.

``BENCHMARK.json`` (at the checkout's root) maps a cell to its
configuration and traffic; the files hold the rest:

- ``configs/<config>.json``: the deployment (agent class, planner
  parameters, dtype, guarantees), the ``file`` of its BENCHMARK.json entry;
- ``traffic/<traffic>.json``: the generator's parameters and the dispatch
  pattern (cycles a dispatch, the restart cap);
- ``workloads/<cell>.json``: what the harness does in the cell besides
  (which dispatches the check keeps, how many the traced run profiles) and
  the limits of the numbers ``check.py`` compares;
- ``metrics/<metric>.py``: one reader a metric (``read(record)``).

Nothing here imports the program or the reference: ``build_mission`` and
``build_param`` take the package's ``missions`` and ``config`` modules.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
from pathlib import Path

import numpy as np

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent


def load_benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _load(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _in_cell(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    workload: dict
    end_to_end: list
    per_layer: list
    run_seconds: int
    bench_dir: Path = BENCH_DIR

    @property
    def k(self) -> int:
        """Planning cycles a dispatch (one CUDA graph replay)."""
        return int(self.traffic["cycles_per_dispatch"])

    def mission_arrays(self, seed: int) -> dict:
        """The mission of this cell's traffic at `seed` (plain arrays)."""
        gen = _module(self.bench_dir / "traffic" /
                      f"{self.traffic['generator']}.py")
        return gen.generate(self.traffic, seed)

    def reader(self, metric: str):
        """The reader of `metric`: metrics/<metric>.py, or, where there is
        none, metrics/<the name before its first dot>.py (one quantity
        split by the cells that report it, as cycle_ms and cycle_ms.forest);
        its ``read(record)`` returns the metric's value, or None where the
        run holds nothing to read (and, optionally, its ``probe(ctx)``
        gathers what it reads after the window of a traced run)."""
        path = self.bench_dir / "metrics" / f"{metric}.py"
        if not path.exists():
            path = path.with_name(f"{metric.split('.', 1)[0]}.py")
        return _module(path)


def _module(path: Path):
    """The module of a Python file of the benchmark, loaded by its path
    (once a process: later calls return the same module)."""
    key = f"lscbench_{path.parent.name}_{path.stem}_{abs(hash(str(path)))}"
    if key not in sys.modules:
        spec = importlib.util.spec_from_file_location(key, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[key] = mod
        spec.loader.exec_module(mod)
    return sys.modules[key]


def find(name: str, root: Path = ROOT, bench_dir: Path = BENCH_DIR) -> Cell:
    """The cell `name` of BENCHMARK.json; KeyError when there is none."""
    bench = load_benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json "
                       f"(cells: {sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _load(root / configs[w["config"]]["file"])
    return Cell(
        name=name, chips=int(w["chips"]), config=config,
        traffic=_load(bench_dir / "traffic" / f"{w['traffic']}.json"),
        workload=_load(bench_dir / "workloads" / f"{name}.json"),
        end_to_end=[m for m in bench["end_to_end"] if _in_cell(m, name)],
        per_layer=[m for m in bench["per_layer"] if _in_cell(m, name)],
        run_seconds=int(bench["run_seconds"]), bench_dir=bench_dir)


def build_mission(missions, arrays: dict, agent: dict):
    """A ``Mission`` of the package whose ``missions`` module is given,
    from generate()'s arrays and the configuration's agent class; tree
    columns become ``static`` boxes (world geometry, audited exactly)."""
    agents = []
    for i, (s, g) in enumerate(zip(arrays["start"], arrays["goal"])):
        agents.append(missions.AgentSpec(
            id=i, cid=i + 1, start=np.array(s), goal=np.array(g),
            radius=float(agent["radius"]), downwash=float(agent["downwash"]),
            nominal_velocity=float(agent["nominal_velocity"]),
            max_vel=np.asarray(agent["max_vel"], np.float64),
            max_acc=np.asarray(agent["max_acc"], np.float64)))
    boxes = np.asarray(arrays["boxes"], np.float64).reshape(-1, 6)
    obstacles = [missions.ObstacleSpec(
        kind="static", pose=0.5 * (b[:3] + b[3:]),
        dimensions=0.5 * (b[3:] - b[:3])) for b in boxes]
    world = np.asarray(arrays["world"], np.float64)
    return missions.Mission(world_min=world[:3].copy(),
                            world_max=world[3:].copy(), agents=agents,
                            obstacles=obstacles)


def build_param(config_module, config: dict):
    """The configuration's ``Param`` of the package whose ``config``
    module is given."""
    return config_module.Param.from_dict(config["param"])
