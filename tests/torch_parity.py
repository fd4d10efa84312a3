"""Shared helpers of the port's parity tests: each side's Param and Mission
built from the same keyword arguments, with each package's own enums, and
a fixture that runs a module's torch CPU ops on one thread."""
import enum

import numpy as np

import pytest
import torch

from lsc_planner_tpu import config as jcfg
from lsc_planner_tpu import missions as jmis
from lsc_planner_tpu_torch import config as tcfg
from lsc_planner_tpu_torch import missions as tmis


def port_value(v):
    """A JAX-package enum member -> the port's member of the same name."""
    if isinstance(v, enum.Enum):
        return getattr(tcfg, type(v).__name__)[v.name]
    return v


def params(**kw):
    """(JAX Param, port Param) from the same keyword arguments."""
    return (jcfg.Param(**kw),
            tcfg.Param(**{k: port_value(v) for k, v in kw.items()}))


def missions(maker: str, *args, **kw):
    """(JAX Mission, port Mission) from the same generator and arguments."""
    return getattr(jmis, maker)(*args, **kw), getattr(tmis, maker)(*args,
                                                                    **kw)


@pytest.fixture(scope="module", autouse=True)
def torch_one_thread():
    """The port's CPU tensors are small, and the tier-1 run puts several
    test processes on the machine's cores at once: torch's own thread pool
    in each of them only oversubscribes the cores.  Imported into a test
    module, this runs that module's torch ops on one thread."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def port_state(jstate, dtype=torch.float64):
    """A JAX SwarmState as the port's, on the CPU."""
    from lsc_planner_tpu_torch.convert import state_from_numpy
    return state_from_numpy({k: None if v is None else np.asarray(v)
                             for k, v in jstate._asdict().items()},
                            device="cpu", dtype=dtype)


def jax_state(fields, dtype):
    """The reverse of port_state: a dict of numpy arrays (SwarmState fields
    by name; a missing field stays None) as the JAX package's SwarmState,
    floats in `dtype` (int32 counters and bool flags as they are)."""
    import jax.numpy as jnp
    from lsc_planner_tpu.sim.simulator import SwarmState
    ints = {"seq", "stall_count", "rescue_phase"}
    bools = {"sfc_initialized", "rescue_active", "slack_flags"}
    out = {}
    for name in SwarmState._fields:
        v = fields.get(name)
        out[name] = None if v is None else jnp.asarray(
            np.asarray(v), jnp.int32 if name in ints else
            bool if name in bools else dtype)
    return SwarmState(**out)


def follow_jax(jsim, tsim, cycles, dyn=None, before=None):
    """The JAX package's mission, cycle by cycle; at each cycle the port's
    cycle from JAX's state (converted).  dyn(it) gives the cycle's dynamic
    obstacle inputs as numpy arrays (dyn_pos, dyn_vel), before(it, state)
    may change JAX's state first (a pose injection).  Returns (each cycle's
    max trajectory difference, the cycle JAX finished or None, JAX's last
    state)."""
    import jax.numpy as jnp
    js = jsim.initial_state()
    errs = []
    for it in range(cycles):
        if before is not None:
            js = before(it, js)
        args = () if dyn is None else dyn(it)
        ts, _ = tsim.cycle(port_state(js, tsim.dtype),
                           *[torch.as_tensor(a, dtype=tsim.dtype)
                             for a in args])
        js, _ = jsim._cycle_jit(js, *[jnp.asarray(a) for a in args])
        errs.append(float(np.abs(ts.traj.numpy() -
                                 np.asarray(js.traj)).max()))
        if jsim.is_finished(js):
            return np.asarray(errs), it + 1, js
    return np.asarray(errs), None, js


def fly_alone(sim, cycles, step):
    """sim's own mission for up to `cycles` cycles, step(it, state) ->
    (state, info) a cycle: (the cycle it finished or None, last state)."""
    state = sim.initial_state()
    for it in range(cycles):
        state, _ = step(it, state)
        if sim.is_finished(state):
            return it + 1, state
    return None, state


def straight_obstacles(jm, tm, specs, size=0.3, speed=0.3):
    """Both missions with straight dynamic obstacles from (start, goal)
    pairs (max_acc 1, downwash 1)."""
    for m, mis in ((jm, jmis), (tm, tmis)):
        m.obstacles = [mis.ObstacleSpec(kind="straight", size=size,
                                        max_acc=1.0, downwash=1.0,
                                        start=np.asarray(s),
                                        goal=np.asarray(g), speed=speed)
                       for s, g in specs]
    return jm, tm
