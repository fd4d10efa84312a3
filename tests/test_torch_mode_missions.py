"""Port parity: whole missions in the BVC, reciprocal RSFC, 2-D and
right-hand modes.

Stated tolerance (float64 on both sides): at every cycle of the JAX
package's mission, the port's cycle from JAX's state within 1e-6 m of
JAX's; flown alone, the port's mission finishes in JAX's cycle count (or
its band, where a tie of the reference's own geometry breaks apart: see
the BVC case).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lsc_planner_tpu.config import GoalMode, PlannerMode
from lsc_planner_tpu.sim.simulator import SyncSimulator as JSim
from lsc_planner_tpu_torch.sim.simulator import SyncSimulator as TSim
from torch_parity import (fly_alone, follow_jax, missions, params,  # noqa
                          straight_obstacles, torch_one_thread)

CYCLE_TOL = 1e-6


@pytest.mark.parametrize("case,cycles,jax_cycles", [
    ("bvc", 400, 95), ("2d", 300, 59), ("right_hand", 60, 48)])
def test_mode_missions_match_jax(case, cycles, jax_cycles):
    """BVC on tests/test_modes.py's 6-agent circle and the 2-D mode on
    tests/test_misc_modes.py's, the right-hand rule on the same circle
    (GoalMode.RIGHT_HAND, Param defaults), each flown to the finish by the
    JAX package: at every cycle the port's cycle from JAX's state within
    1e-6 m (measured <= 8e-10).  Flown alone, the port finishes in the
    same number of cycles (2-D, right-hand) or, for BVC, within max(20 %,
    10) of it: on the symmetric circle two agents tie in the priority
    rule's back-away test at cycle 11 (their distances equal to 1e-13),
    and the packages' last bits break the tie apart (JAX 95, the port
    83; ROADMAP, divergences)."""
    world, mkw = (-5, -5, 0, 5, 5, 2.5), {}
    if case == "bvc":
        kw = dict(planner_mode=PlannerMode.BVC, qp_iterations=14)
    elif case == "2d":
        kw = dict(world_dimension=2, world_z_2d=0.6, qp_iterations=12)
        world, mkw = (-5, -5, 0, 5, 5, 1.2), dict(z=0.6)
    else:
        kw = dict(goal_mode=GoalMode.RIGHT_HAND)
    kw.setdefault("goal_mode", GoalMode.PRIOR_BASED)
    jp, tp = params(**kw)
    jm, tm = missions("make_circle_mission", 6, radius=3.0, world=world,
                      **mkw)
    jsim = JSim(jm, jp, dtype=jnp.float64)
    tsim = TSim(tm, tp, device="cpu", dtype=torch.float64)
    errs, jdone, _ = follow_jax(jsim, tsim, cycles)
    assert jdone == jax_cycles
    assert errs.max() <= CYCLE_TOL, (errs.argmax(), errs.max())
    tdone, ts = fly_alone(tsim, cycles, lambda it, s: tsim.cycle(s))
    assert tdone is not None and float(ts.safety_agent_min) >= 1.0
    if case == "bvc":
        assert abs(tdone - jdone) <= max(0.2 * jdone, 10), (tdone, jdone)
    else:
        assert tdone == jdone
    if case == "2d":
        np.testing.assert_allclose(ts.pos[:, 2].numpy(), 0.6, atol=0.05)


def test_rsfc_mission_matches_jax():
    """tests/test_modes.py's RSFC mission (4-agent circle, STATIC goals,
    qp_iterations 16) with two straight obstacles crossing it: every slack
    QP with the obstacles' inflated sizes (non-agent rows), to the
    finish."""
    jp, tp = params(planner_mode=PlannerMode.RECIPROCAL_RSFC,
                    goal_mode=GoalMode.STATIC, qp_iterations=16)
    jm, tm = straight_obstacles(*missions(
        "make_circle_mission", 4, radius=2.5, world=(-5, -5, 0, 5, 5, 2.5)),
        [((0.0, -4.0, 1.0), (0.0, 4.0, 1.0)),
         ((-4.0, 0.6, 1.2), (4.0, 0.6, 1.2))])
    jsim = JSim(jm, jp, dtype=jnp.float64)
    tsim = TSim(tm, tp, device="cpu", dtype=torch.float64)
    dt = tp.multisim_time_step

    def dyn(it):
        dp, dv = tsim.obstacle_generator.update(it * dt)
        return dp.copy(), dv.copy()
    errs, jdone, _ = follow_jax(jsim, tsim, 400, dyn=dyn)
    assert jdone is not None
    assert errs.max() <= CYCLE_TOL, (errs.argmax(), errs.max())
    tdone, ts = fly_alone(tsim, 400, lambda it, s: tsim.cycle(
        s, *tsim.dynamic_inputs(it * dt, s)[:2]))
    assert tdone == jdone
    assert float(ts.safety_agent_min) > 0.9
