"""The plain references that ``check.py`` judges the program by, one
package a planner: ``reference/<name>/``, which a configuration names
under its key ``"reference"`` (``lsc`` where it has none;
``cell.Cell.reference`` loads it from the cell's own benchmark folder).

What ``check.judge`` and ``control.reference_program`` reach in a
package, and so what each package provides:

- ``config.Param.from_dict(d)``: the configuration's ``"param"`` as the
  package's ``Param`` (``dt``, ``n``, ``goal_threshold``,
  ``multisim_record_time_step``, ``multisim_time_step`` read), refusing a
  mode or a key the package does not run;
- ``missions.Mission``, ``missions.AgentSpec``, ``missions.ObstacleSpec``:
  built by ``cell.build_mission`` with the port's keywords;
- ``sim.simulator.SyncSimulator(mission, param, device=, dtype=)``, with
  ``param``, ``N``, ``radius``, ``downwash``, ``max_vel``, ``max_acc``,
  ``static_boxes``, ``initial_state()`` and ``cycle(state)`` returning
  ``(state, info)`` (``info.qp_failed``, ``info.safety_step_min``);
- ``sim.simulator.SwarmState``: a NamedTuple whose fields stand in the
  port's order (the check casts the program's state into it field by
  field);
- ``sim.simulator._stack_cycles(cycle, state, k)``: k cycles, the infos
  stacked as a replay's (the control's dispatch);
- ``sim.audit.step_safety_ratio`` and
  ``sim.audit.static_box_safety_ratio``: the guarantees' audits.

Every reference package is plain PyTorch run in float64, and imports
nothing of the port (``lsc_planner_tpu_torch``), of JAX or of the JAX
package (``lsc_planner_tpu``).  It may import from a sibling package here
rather than copy it, by a relative import (``from ..lsc.ops import qp``
in a module at the package's top), so that a copy of the benchmark
judges by its own files.
"""
