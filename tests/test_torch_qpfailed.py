"""rsfc64's QPFAILED, classed: the state before the card's failing cycle.

chip_smoke.py's rsfc64 (64 agents, RECIPROCAL_RSFC, the slack-relaxed QP
at n = 365, f32) fails agent 25 at cycle 3 on an NVIDIA H100; the JAX
package's own CPU f32 run of the mission fails no agent.  The state before
that cycle came back from the card
(`scripts/qpfailed_state_torch.py`, tests/data/rsfc64_cycle3_state.npz).
From it, on the CPU, both packages fail agent 25 in f32 (JAX fails agent
39 as well) and solve every QP in f64: the card's f32 run had drifted into
a state that f32 cannot solve, in either package.

The cycle's four runs take ~1.5 min together on 8 cores (the slack QP's
dense Gram at (64, 2934, 365), 40 iterations), so this module gives
torch a few threads instead of torch_parity's one.
"""
import enum
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from lsc_planner_tpu import config as jcfg
from lsc_planner_tpu import missions as jmis
from lsc_planner_tpu.sim.simulator import SyncSimulator as JSim
from lsc_planner_tpu_torch.convert import state_from_numpy
from lsc_planner_tpu_torch.sim.simulator import SyncSimulator as TSim
from torch_parity import jax_state

STATE = Path(__file__).parent / "data" / "rsfc64_cycle3_state.npz"
# At Param's slack weight (1e5) the KKT systems' conditioning amplifies the
# order of the reductions: the port's own f64 cycle from this state on an
# NVIDIA H100 (cuBLAS and the card's kernels) and on the CPU (the plain
# versions), the same code, differ by 8.0e-6 m
# (`scripts/qpfailed_state_torch.py gap`), and the two packages' f64
# cycles here by 7.2e-6 m (printed under `pytest -s`).
F64_TOL = 2e-5


@pytest.fixture(scope="module", autouse=True)
def torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(min(4, before))
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def runs():
    """{(package, dtype name): (QPFAILED agents, trajectories)} of the
    cycle from the card's state, each package on the CPU."""
    fields = dict(np.load(STATE))
    assert int(fields.pop("cycle")) == 3
    tm, kw, _ = chip_smoke.mode_case("rsfc64")
    jm = chip_smoke.mode_case("rsfc64", jmis)[0]
    jkw = {k: getattr(jcfg, type(v).__name__)[v.name]
           if isinstance(v, enum.Enum) else v for k, v in kw.items()}
    out = {}
    for name, jdt, tdt in (("f32", jnp.float32, torch.float32),
                           ("f64", jnp.float64, torch.float64)):
        jsim = JSim(jm, jcfg.Param(**jkw), dtype=jdt)
        js, jinfo = jsim._cycle_jit(jax_state(fields, jdt))
        out["jax", name] = (np.nonzero(np.asarray(jinfo.qp_failed))[0]
                            .tolist(), np.asarray(js.traj))
        tsim = TSim(tm, chip_smoke.Param(**kw), device="cpu", dtype=tdt)
        ts, tinfo = tsim.cycle(state_from_numpy(fields, device="cpu",
                                                dtype=tdt))
        out["port", name] = (tinfo.qp_failed.nonzero().flatten().tolist(),
                             ts.traj.numpy())
    return out


def test_state_is_f32_hard(runs):
    """Agent 25 fails in both packages' f32 runs, and the port fails no
    agent that JAX solves."""
    jfail, pfail = runs["jax", "f32"][0], runs["port", "f32"][0]
    assert 25 in jfail and 25 in pfail, (jfail, pfail)
    assert set(pfail) <= set(jfail), (jfail, pfail)


def test_f64_solves_it_in_both_packages(runs):
    """No agent fails in f64, and the port's trajectories are JAX's within
    F64_TOL."""
    assert runs["jax", "f64"][0] == [] and runs["port", "f64"][0] == []
    err = np.abs(runs["port", "f64"][1] - runs["jax", "f64"][1]).max()
    print(f"port - JAX f64 trajectories: max {err:.3e} m")   # pytest -s
    assert err <= F64_TOL, err
