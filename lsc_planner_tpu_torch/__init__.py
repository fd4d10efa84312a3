"""lsc_planner_tpu_torch: the LSC swarm planner in PyTorch, for one GPU.

A port of ``lsc_planner_tpu`` (JAX on a TPU, kept beside it as the
reference).  Module paths mirror the JAX package; plain tensor code is
PyTorch, and the TPU kernels on the ported path are CUDA kernels written
for Hopper (``csrc/``), built with nvcc at first use.

The package imports torch, numpy and scipy, and nothing of jax or of the
JAX package: ``config`` and ``missions`` are the port's own copies of the
JAX package's host modules.  Entry points run on the CUDA device unless
the caller passes ``device="cpu"``.
"""
from .config import (GoalMode, InitialTrajMode, Param, PlannerMode,
                     PredictionMode, SlackMode)
from .missions import (AgentSpec, Mission, ObstacleSpec, load_mission,
                       make_circle_mission, make_random_mission,
                       make_square_mission)

from .device import exact_float32

exact_float32()

__all__ = ["AgentSpec", "GoalMode", "InitialTrajMode", "Mission",
           "ObstacleSpec", "Param", "PlannerMode", "PredictionMode",
           "SlackMode", "exact_float32", "load_mission",
           "make_circle_mission", "make_random_mission",
           "make_square_mission"]
