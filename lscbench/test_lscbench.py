"""CPU tests of the benchmark (lscbench/): discovery by name, the
generator and arithmetic copies, the metrics' response to a stall, the
reference against the port, the check's faults and the imports.  The
card's tests carry the ``cuda`` marker and skip without one.

    python -m pytest lscbench/ -q
"""
from __future__ import annotations

import json
import shutil
import subprocess
import sys
import time
import types
from pathlib import Path

import numpy as np
import pytest
import torch

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
sys.path.insert(0, str(BENCH))
sys.path.insert(1, str(ROOT))

import cell as cell_mod  # noqa: E402
import check  # noqa: E402
import roofline  # noqa: E402
import run  # noqa: E402
from traffic import swarm  # noqa: E402

SEED = 3000000019       # larger than 32 signed bits hold


def tiny_root(tmp_path, k=10):
    """A copy of the benchmark with two tiny cells beside the real ones
    (the real configurations, workload files and metrics, few agents and
    trees, k cycles a dispatch), as files and BENCHMARK.json entries
    alone."""
    bench = tmp_path / "lscbench"
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns(
        "_cache", "__pycache__"))
    b = json.loads((ROOT / "BENCHMARK.json").read_text())
    for name, real_cfg, real_cell, upd in (
            ("tiny_empty", "empty1024", "random1024",
             dict(agents=10, world=[-3, -3, 0, 3, 3, 2.5])),
            ("tiny_forest", "forest20", "forest20",
             dict(agents=5, trees=12))):
        cfg = json.loads((BENCH / "configs" / f"{real_cfg}.json").read_text())
        if name == "tiny_empty":
            cfg["param"]["max_neighbors"] = 4
        (bench / "configs" / f"{name}.json").write_text(json.dumps(cfg))
        real = next(w for w in b["workloads"] if w["name"] == real_cell)
        tr = json.loads((BENCH / "traffic" /
                         f"{real['traffic']}.json").read_text())
        tr.update(upd, cycles_per_dispatch=k)
        (bench / "traffic" / f"{name}.json").write_text(json.dumps(tr))
        wl = json.loads((BENCH / "workloads" /
                         f"{real_cell}.json").read_text())
        wl["check"] = {"count": 2, "from": [1, 3]}
        (bench / "workloads" / f"{name}.json").write_text(json.dumps(wl))
        b["configs"].append(dict(next(c for c in b["configs"]
                                      if c["name"] == real_cfg),
                                 name=name,
                                 file=f"lscbench/configs/{name}.json"))
        b["workloads"].append(dict(real, name=name, config=name,
                                   traffic=name))
        for m in b["end_to_end"] + b["per_layer"]:
            if real_cell in m.get("workloads", []):
                m["workloads"].append(name)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    return tmp_path, bench


def port_on_cpu(**overrides):
    import lsc_planner_tpu_torch as port
    from lsc_planner_tpu_torch import config, missions
    from lsc_planner_tpu_torch.sim import simulator
    prog = dict(package=port, config=config, missions=missions,
                SyncSimulator=simulator.SyncSimulator, device="cpu")
    prog.update(overrides)
    return types.SimpleNamespace(**prog)


def run_line(capsys, root, bench, cell, program, trace=0, seconds=1.0):
    """main() of run.py on the CPU; returns (exit code, the JSON line)."""
    rc = run.main(["--workload", cell, "--seed", str(SEED), "--seconds",
                   str(seconds), "--trace", str(trace)], program=program,
                  root=root, bench_dir=bench)
    out = capsys.readouterr().out.strip().splitlines()
    return rc, (json.loads(out[-1]) if out else None)


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# traffic and arithmetic copies


@pytest.mark.parametrize("seed", [0, 7, SEED])
def test_generator_reproduces_the_ports_missions(seed):
    """The vectorised generator gives make_random_mission's points (the
    port's loop) and chip_smoke's forest, point for point."""
    from lsc_planner_tpu_torch.missions import make_random_mission
    m = make_random_mission(40, seed=seed).agent_arrays()
    g = swarm.generate({"world": [-5, -5, 0, 5, 5, 2.5], "agents": 40}, seed)
    assert np.array_equal(m["start"], g["start"])
    assert np.array_equal(m["goal"], g["goal"])
    g = swarm.generate({"world": [-5, -5, 0, 5, 5, 2.5], "agents": 20,
                        "trees": 60, "tree_half": 0.15}, seed)
    centres = 0.5 * (g["boxes"][:, :2] + g["boxes"][:, 3:5])
    keep = np.concatenate([g["start"][:, :2], g["goal"][:, :2]])
    assert g["boxes"].shape == (60, 6)
    assert (np.linalg.norm(keep[None] - centres[:, None], axis=-1) >
            0.5).all()
    d = np.linalg.norm(g["start"][:, None] - g["start"][None], axis=-1)
    assert (d[~np.eye(20, dtype=bool)] > 0.7).all()


def test_random1024_density():
    """random1024's world keeps the 60-agent corpus density."""
    tr = json.loads((BENCH / "traffic" / "random_pairs_1024.json")
                    .read_text())
    w = np.asarray(tr["world"])
    vol = lambda lo, hi: float(np.prod(hi - lo))   # noqa: E731
    inset = tr["inset"]
    corpus = 60 / vol(np.array([-4.5, -4.5, 0.5]), np.array([4.5, 4.5, 2.0]))
    here = tr["agents"] / vol(w[:3] + inset, w[3:] - inset)
    assert abs(here / corpus - 1) < 2e-3


def test_chol_bound_hand_counts():
    # B = 2 systems of n = 3: factor_solve moves tri 6 + full 9 + 2 n = 21
    # elements a system and computes 27 / 3 + 2 * 9 = 27 operations
    ms, by = roofline.chol_bound("factor_solve", 2, 3)
    assert by == "bytes"
    assert ms == pytest.approx(1e3 * 4 * 2 * 21 / 3.35e12)
    ms, by = roofline.chol_bound("resolve", 1000, 64, elem=8)
    want = max(8 * 1000 * (2080 + 128) / 3.35e12,
               1000 * 2 * 64 * 64 / 67e12)
    assert ms == pytest.approx(1e3 * want)
    ms, by = roofline.bound(0, 67e9)
    assert (ms, by) == (pytest.approx(1.0), "operations")


def test_fused_ops_hand_count():
    """One iteration of a 1-D QP with one segment of two control points,
    one plane row a point and no static rows (nf = 2, MI = 2, C = 1)."""
    P_blk, U, F_seg = (torch.zeros(1, 2, 2), torch.zeros(1, 0, 2),
                       torch.zeros(1, 2, 2))
    # Gram 4*1*2 + 2*2*(1*3) = 20; factor 8/3; rows 2*2*2 + 2*2 + 0 +
    # 2*2*1 + 2*2*(0 + 2) = 24; two KKT solves 2 * (24 + 8) and the test 24
    assert roofline.fused_ops_per_iter(P_blk, U, F_seg, C=1) == \
        pytest.approx(20 + 8 / 3 + 2 * (24 + 8) + 24)


def test_percentile_and_cycle_readers():
    """An injected stall moves cycle_ms and dispatch_p95_ms (readers on a
    record)."""
    c = cell_mod.find("random1024")
    base = [0.1] * 200
    stalled = list(base)
    for i in range(0, 200, 10):
        stalled[i] += 0.5
    recs = [types.SimpleNamespace(window_s=sum(d), cycles=2000, dispatch_s=d)
            for d in (base, stalled)]
    for metric in ("cycle_ms", "dispatch_p95_ms"):
        a, b = (c.reader(metric).read(r) for r in recs)
        assert b > a * 1.2, metric


# ---------------------------------------------------------------------------
# runs on the CPU


def test_run_without_a_card_fails():
    """Without a card the run exits non-zero and prints no result."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    p = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload",
                        "random1024", "--seed", str(SEED), "--seconds", "1",
                        "--trace", "0"], capture_output=True, text=True,
                       timeout=120)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "cuda" in p.stderr.lower()


def test_run_outside_the_repo_fails(tmp_path):
    """With only BENCHMARK.json and the benchmark's files, the run exits
    non-zero and prints no result."""
    shutil.copytree(BENCH, tmp_path / "lscbench",
                    ignore=shutil.ignore_patterns("_cache", "__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    p = subprocess.run([sys.executable, "lscbench/run.py", "--workload",
                        "random1024", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=tmp_path, capture_output=True,
                       text=True, timeout=120)
    assert p.returncode != 0
    assert p.stdout.strip() == ""


def test_a_cell_a_config_and_a_metric_added_as_files(tmp_path, capsys):
    """A cell, its configuration and a per-layer metric added as files and
    BENCHMARK.json entries alone are found and reported."""
    root, bench = tiny_root(tmp_path)
    (bench / "metrics" / "restarts_a_window.py").write_text(
        "def read(rec):\n    return float(rec.restarts)\n")
    b = json.loads((root / "BENCHMARK.json").read_text())
    b["per_layer"].append({"name": "restarts_a_window", "unit": "missions",
                           "better": "lower", "source": "program_counter",
                           "layer": "host loop", "moves": "cycle_ms",
                           "workloads": ["tiny_empty"]})
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    rc, line = run_line(capsys, root, bench, "tiny_empty", port_on_cpu(),
                        trace=1)
    assert rc == 0 and line["correct"] is True
    assert "restarts_a_window" in line["metrics"]
    assert list(line)[-1] == "checks"
    rc, line = run_line(capsys, root, bench, "tiny_empty", port_on_cpu())
    want = {m["name"] for m in b["end_to_end"]
            if "tiny_empty" in m.get("workloads", ["tiny_empty"])}
    assert rc == 0 and set(line["metrics"]) == want
    assert line["attempted"] > 0 and line["attempted"] % 30 == 0


def stalled(every, seconds):
    """The port on the CPU whose every `every`-th dispatch stalls."""
    from lsc_planner_tpu_torch.sim import simulator

    class Sim(simulator.SyncSimulator):
        def make_scan_cycle(self, k):
            multi, n = super().make_scan_cycle(k), [0]

            def stall(state):
                n[0] += 1
                if n[0] % every == 0:
                    time.sleep(seconds)
                return multi(state)
            return stall
    return port_on_cpu(SyncSimulator=Sim)


def test_an_injected_stall_moves_both_timings(tmp_path, capsys):
    root, bench = tiny_root(tmp_path, k=3)
    got = []
    for prog in (port_on_cpu(), stalled(3, 1.0)):
        rc, line = run_line(capsys, root, bench, "tiny_empty", prog,
                            seconds=2.0)
        assert rc == 0 and line["correct"] is True
        got.append(line["metrics"])
    for metric in ("cycle_ms", "dispatch_p95_ms"):
        assert got[1][metric]["value"] > 1.3 * got[0][metric]["value"]


# ---------------------------------------------------------------------------
# the reference and the check


def test_reference_follows_the_port_in_f64():
    """The reference's cycles equal the port's plain ones in float64 on a
    tiny forest mission (the same arithmetic), and a perturbed result
    fails the check."""
    c = cell_mod.find("forest20")
    arrays = swarm.generate(dict(c.traffic, agents=5, trees=12), SEED)
    import lsc_planner_tpu_torch as port
    from lsc_planner_tpu_torch.sim.simulator import SyncSimulator
    rconfig, rmissions, rsim_mod, _ = check.reference_modules(c)
    f64 = torch.float64
    sims = [SyncSimulator(cell_mod.build_mission(port.missions, arrays,
                                                 c.config["agent"]),
                          cell_mod.build_param(port.config, c.config),
                          device="cpu", dtype=f64),
            rsim_mod.SyncSimulator(
                cell_mod.build_mission(rmissions, arrays, c.config["agent"]),
                cell_mod.build_param(rconfig, c.config), device="cpu",
                dtype=f64)]
    states = [s.initial_state() for s in sims]
    for _ in range(4):
        states = [s.cycle(st)[0] for s, st in zip(sims, states)]
    for a, b in zip(*states):
        if a is not None:
            assert torch.equal(a, b)


def faulty(kind):
    """The port on the CPU with its timed path broken underneath: a
    dispatch that returns the state it was given ("unchanged"), half of the
    agents' QPs left unsolved, their previous plans flown ("half"), every
    QP solution moved 0.3 m where the optimizer produces it ("altered")."""
    from lsc_planner_tpu_torch.sim import simulator

    class Unchanged(simulator.SyncSimulator):
        def make_scan_cycle(self, k):
            multi = super().make_scan_cycle(k)
            return lambda state: (state, multi(state)[1])

    class Broken(simulator.SyncSimulator):
        def __post_init__(self):
            super().__post_init__()
            solve = self.optimizer.solve

            def broken(pos, vel, acc, current_goal, *args, **kw):
                res = solve(pos, vel, acc, current_goal, *args, **kw)
                if kind == "altered":
                    return res._replace(traj=res.traj + 0.3)
                # the warm start, the previous plan shifted, for half the
                # agents (the IPM's unchanged iterate)
                half = pos.shape[0] // 2
                traj = torch.cat([res.traj[:half], self._init[half:]])
                return res._replace(traj=traj)
            self.optimizer.solve = broken

        def predict_and_init(self, *args, **kw):
            init, prediction = super().predict_and_init(*args, **kw)
            self._init = init
            return init, prediction
    return port_on_cpu(SyncSimulator=Unchanged if kind == "unchanged"
                       else Broken)


@pytest.mark.parametrize("cell", ["tiny_empty", "tiny_forest"])
@pytest.mark.parametrize("kind", ["sound", "unchanged", "half", "altered"])
def test_faults_make_correct_false(tmp_path, capsys, cell, kind):
    """Each fault the cells can have, under the real cells' limits, makes
    correct false; the sound port passes.  (A replay covers one card: no
    exchange between cards to leave out.)"""
    root, bench = tiny_root(tmp_path)
    prog = port_on_cpu() if kind == "sound" else faulty(kind)
    rc, line = run_line(capsys, root, bench, cell, prog)
    assert rc == 0
    assert line["correct"] is (kind == "sound"), line["checks"]


# ---------------------------------------------------------------------------
# the configuration's reference

_MOVED_CYCLE = """


_planned_cycle = SyncSimulator.cycle


def _moved_cycle(self, state):
    new, info = _planned_cycle(self, state)
    return new._replace(traj=new.traj + 0.3), info


SyncSimulator.cycle = _moved_cycle
"""


def name_reference(bench, reference):
    """tiny_empty's configuration with its "reference" set to
    `reference` (taken out where None)."""
    path = bench / "configs" / "tiny_empty.json"
    cfg = json.loads(path.read_text())
    cfg.pop("reference", None)
    if reference is not None:
        cfg["reference"] = reference
    path.write_text(json.dumps(cfg))


def twin_root(tmp_path):
    """tiny_root with reference/lsc_twin/: a copy of reference/lsc/ whose
    SyncSimulator.cycle moves every planned trajectory by 0.3 m, a
    package that exists only in this copy of the benchmark."""
    root, bench = tiny_root(tmp_path)
    twin = bench / "reference" / "lsc_twin"
    shutil.copytree(bench / "reference" / "lsc", twin)
    sim = twin / "sim" / "simulator.py"
    sim.write_text(sim.read_text() + _MOVED_CYCLE)
    return root, bench


def test_the_check_judges_by_the_configurations_reference(tmp_path, capsys):
    """A configuration that names reference/lsc_twin/ is judged by it (the
    sound port reads correct false against the moved plans); without the
    key the same cell is judged by reference/lsc/ and reads true."""
    root, bench = twin_root(tmp_path)
    for reference, want in (("lsc_twin", False), (None, True)):
        name_reference(bench, reference)
        rc, line = run_line(capsys, root, bench, "tiny_empty", port_on_cpu())
        assert rc == 0
        assert line["correct"] is want, (reference, line["checks"])


@pytest.mark.parametrize("reference", ["rsfc", "lsc.ops", "../lsc", 3])
def test_a_missing_reference_ends_the_run(tmp_path, capsys, reference):
    """A configuration naming no package under reference/ ends the run
    before the window: non-zero, no result, a message naming it."""
    root, bench = tiny_root(tmp_path)
    name_reference(bench, reference)
    rc = run.main(["--workload", "tiny_empty", "--seed", str(SEED),
                   "--seconds", "1", "--trace", "0"], program=port_on_cpu(),
                  root=root, bench_dir=bench)
    out, err = capsys.readouterr()
    assert rc != 0
    assert out.strip() == ""
    assert len(err.strip().splitlines()) == 1
    assert repr(reference) in err and "tiny_empty" in err


def test_the_control_runs_the_configurations_reference(tmp_path):
    """control.reference_program puts the named package's simulator in
    the program's place (reference/lsc/ where the key is absent), loaded
    from the cell's own benchmark folder."""
    import control
    root, bench = twin_root(tmp_path)
    for reference, folder in (("lsc_twin", "lsc_twin"), (None, "lsc")):
        name_reference(bench, reference)
        c = cell_mod.find("tiny_empty", root, bench)
        prog = control.reference_program(c, device="cpu")
        pkg = bench / "reference" / folder
        assert Path(prog.package.__file__) == pkg / "__init__.py"
        base = c.reference("sim.simulator")
        assert Path(base.__file__) == pkg / "sim" / "simulator.py"
        assert issubclass(prog.SyncSimulator, base.SyncSimulator)
        assert Path(prog.config.__file__) == pkg / "config.py"


# ---------------------------------------------------------------------------
# imports

_IMPORT_ALL = """
import json, sys
sys.path[:0] = [{bench!r}, {root!r}]
import {mods}
import cell
c = cell.find('random1024')
for m in ('cycle_ms', 'dispatch_p95_ms', 'setup_s', 'device_idle_share',
          'launches_per_cycle', 'aten_ms_per_cycle', 'ipm_iters_mean',
          'fused_ipm_roofline', 'chol_roofline',
          'world_kernels_ms_per_cycle'):
    c.reader(m)
print(json.dumps(sorted({{m.split('.', 1)[0] for m in sys.modules}})))
"""


def _top_level(mods):
    p = subprocess.run([sys.executable, "-c", _IMPORT_ALL.format(
        bench=str(BENCH), root=str(ROOT), mods=", ".join(mods))],
        capture_output=True, text=True, timeout=300,
        env={"PATH": "/usr/bin:/bin", "USE_FLAX": "0"})
    assert p.returncode == 0, p.stderr
    return set(json.loads(p.stdout.strip().splitlines()[-1]))


def test_the_harness_loads_no_jax():
    """Nothing a run loads (the harness, the port, the reference) has the
    top-level name jax, jaxlib, flax or lsc_planner_tpu; the port's name
    begins with the JAX package's and is compared whole."""
    top = _top_level(["run", "window", "check", "control", "tracing",
                      "probes", "roofline", "traffic.swarm",
                      "lsc_planner_tpu_torch.sim.simulator",
                      "reference.lsc.sim.simulator"])
    assert "lsc_planner_tpu_torch" in top
    assert not top & set(run.FORBIDDEN), top & set(run.FORBIDDEN)


def _reference_modules(package):
    """Every module of reference/<package>/, by its dotted name."""
    folder = BENCH / "reference"
    return sorted(".".join(("reference",) + p.relative_to(folder)
                           .with_suffix("").parts).removesuffix(".__init__")
                  for p in (folder / package).rglob("*.py"))


@pytest.mark.parametrize("package", sorted(
    p.name for p in (BENCH / "reference").iterdir()
    if (p / "__init__.py").is_file()))
def test_the_reference_loads_nothing_of_the_program(package):
    """Every module of every reference package loads nothing of the port,
    of JAX or of the JAX package."""
    top = _top_level(["check", *_reference_modules(package)])
    assert "reference" in top
    assert not top & {"lsc_planner_tpu_torch", *run.FORBIDDEN}


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "lsc_planner_tpu_torch_x", types)
    assert "lsc_planner_tpu_torch_x" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jaxlib.fake", types)
    assert "jaxlib.fake" in run.forbidden_modules()


# ---------------------------------------------------------------------------
# on the card


@pytest.mark.cuda
def test_control_fails_on_the_card(tmp_path):
    """The TF32 control at a small size on the card: correct is false."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import control
    root, bench = tiny_root(tmp_path, k=10)
    for cell in ("tiny_empty", "tiny_forest"):
        correct, checks, _ = control.run_control(cell, SEED, "tf32",
                                                 root=root, bench_dir=bench)
        assert correct is False, checks
