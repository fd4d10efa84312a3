"""Port parity: whole obstacle-world missions flown in float32 by both
packages on the CPU.

Float32 rounding alone moves a mission's cycle count, and on the 2-agent
wall swaps it moves the JAX package itself far (111 cycles in f64, 151 in
f32 on test_static_obstacles.py's wall), so test_torch_grid.py holds the
port's f32 run of that wall to the f64 count, which the port's f64 run
matches exactly.  Here the port's f32 run is held to the JAX package's
f32 run, on missions of the same kinds: finished, agent and obstacle
safety >= 1, 0 QPFAILED, cycles within max(20 %, 10) of JAX's.
Run as a script, it prints each package's f32 and f64 cycle counts for
every case of CASES.
"""
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lsc_planner_tpu import missions as jmis
from lsc_planner_tpu.config import GoalMode
from lsc_planner_tpu.sim.simulator import SyncSimulator as JSim
from lsc_planner_tpu_torch import missions as tmis
from lsc_planner_tpu_torch.sim.simulator import SyncSimulator as TSim
from test_torch_cuda import forest_mission
from torch_parity import params, torch_one_thread  # noqa: F401

WORLD = (-3.0, -3.0, 0.0, 3.0, 3.0, 2.5)


def _wall(mis, half=3.0, dy=0.0, hy=2.0):
    """test_static_obstacles.py:23-30's wall (half 3, dy 0, hy 2), or the
    swap at another half width, the wall moved by dy along y or hy its
    half length."""
    m = mis.make_square_mission(2, half=half, world=(-5, -5, 0, 5, 5, 2.5))
    m.obstacles = [mis.ObstacleSpec(kind="static",
                                    pose=np.array([0.0, dy, 1.25]),
                                    dimensions=np.array([0.3, hy, 1.25]))]
    return m


# name -> (kind, arguments): the test's cases and the table's
CASES = {"wall": ("wall", {}), "wall_dy0.2": ("wall", dict(dy=0.2)),
         "wall_dy0.4": ("wall", dict(dy=0.4)),
         "wall_dy-0.6": ("wall", dict(dy=-0.6)),
         "wall_half2.5": ("wall", dict(half=2.5)),
         "wall_half3.5": ("wall", dict(half=3.5)),
         "wall_hy1.5": ("wall", dict(hy=1.5)),
         "forest1": ("forest", dict(seed=1)),
         "forest2": ("forest", dict(seed=2)),
         "forest4": ("forest", dict(seed=4))}


def _case(name):
    """(JAX mission, port mission, Param keywords) of a named case: a
    4-agent forest of 12 trees, or a wall swap at qp_iterations 20."""
    kind, kw = CASES[name]
    if kind == "forest":
        return (forest_mission(jmis, kw["seed"], 4, 12, WORLD),
                forest_mission(tmis, kw["seed"], 4, 12, WORLD),
                dict(goal_mode=GoalMode.PRIOR_BASED))
    return (_wall(jmis, **kw), _wall(tmis, **kw),
            dict(goal_mode=GoalMode.PRIOR_BASED, qp_iterations=20))


@pytest.mark.parametrize("name", ["forest1", "forest2", "wall_half3.5"])
def test_f32_mission_cycles_match_jax_f32(name):
    jm, tm, kw = _case(name)
    jp, tp = params(**kw)
    j = JSim(jm, jp, dtype=jnp.float32).run()
    t = TSim(tm, tp, device="cpu", dtype=torch.float32).run()
    assert j["iterations"] < jp.multisim_max_planner_iteration
    assert t["iterations"] < tp.multisim_max_planner_iteration
    assert t["safety_ratio_agent"] >= 1.0 and not t["is_collided"]
    assert t["safety_ratio_obs"] >= 1.0
    assert t["qp_failures"] == 0
    band = max(0.2 * j["iterations"], 10)
    assert abs(t["iterations"] - j["iterations"]) <= band, \
        (t["iterations"], j["iterations"])


def main(names):
    """Print, a JSON line a case, the cycles, safety and distance of the
    JAX package's and the port's CPU runs in f32 and f64."""
    import json
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    torch.set_num_threads(1)
    for name in names:
        jm, tm, kw = _case(name)
        jp, tp = params(**kw)
        out = {"case": name}
        for key, run in (
                ("jax_f32", lambda: JSim(jm, jp, dtype=jnp.float32).run()),
                ("jax_f64", lambda: JSim(jm, jp, dtype=jnp.float64).run()),
                ("port_f32", lambda: TSim(tm, tp, device="cpu",
                                          dtype=torch.float32).run()),
                ("port_f64", lambda: TSim(tm, tp, device="cpu",
                                          dtype=torch.float64).run())):
            r = run()
            out[key] = dict(cycles=int(r["iterations"]),
                            safety=float(r["safety_ratio_agent"]),
                            obstacle_safety=float(r["safety_ratio_obs"]),
                            qp_failures=int(r["qp_failures"]),
                            distance=float(r["total_flight_distance"]))
        print(json.dumps(out), flush=True)


if __name__ == "__main__":
    # JAX_PLATFORMS=cpu JAX_ENABLE_X64=1 PYTHONPATH=. \
    #     python tests/test_torch_f32_missions.py [case ...]
    main(sys.argv[1:] or list(CASES))
