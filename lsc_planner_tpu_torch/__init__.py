"""lsc_planner_tpu_torch: the LSC swarm planner in PyTorch, for one GPU.

A port of ``lsc_planner_tpu`` (JAX on a TPU, kept beside it as the
reference).  Module paths mirror the JAX package; plain tensor code is
PyTorch, and the TPU kernels on the ported path are CUDA kernels written
for Hopper (``csrc/``), built with nvcc at first use.

The package imports torch and numpy and never jax.  It reuses the JAX
package's two jax-free host modules, ``config`` and ``missions``.
"""
from lsc_planner_tpu.config import (GoalMode, InitialTrajMode, Param,
                                    PlannerMode, PredictionMode, SlackMode)
from lsc_planner_tpu.missions import (AgentSpec, Mission, load_mission,
                                      make_circle_mission,
                                      make_random_mission,
                                      make_square_mission)

from .device import exact_float32

exact_float32()

__all__ = ["AgentSpec", "GoalMode", "InitialTrajMode", "Mission", "Param",
           "PlannerMode", "PredictionMode", "SlackMode", "exact_float32",
           "load_mission", "make_circle_mission", "make_random_mission",
           "make_square_mission"]
