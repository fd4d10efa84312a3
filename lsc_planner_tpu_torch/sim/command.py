"""Hardware-bridge analog: 50 Hz full-state command sampling (port of
lsc_planner_tpu/sim/command.py).

Reference: CmdPublisher (src/cmd_publisher.cpp) -- subscribes the planner's
per-cycle trajectory batches with start times, pops each batch when its
start time arrives, samples flat-output full states at 50 Hz, and publishes
cmd_full_state per Crazyflie.  Here the queue and the sampling are kept;
the transport is a callback instead of ROS.  States are sampled in float64
on the CPU.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Callable, Deque, Optional

import numpy as np
import torch

from ..config import Param
from ..ops import bernstein as bz


@dataclasses.dataclass
class TrajectoryBatch:
    start_time: float
    trajs: np.ndarray           # (N, M, n+1, 3)


@dataclasses.dataclass
class CommandSampler:
    """Queues trajectory batches and samples full states at a fixed rate
    (trajsCallback/update_traj/publish_traj, cmd_publisher.cpp:27-127)."""
    param: Param
    rate_hz: float = 50.0
    sink: Optional[Callable] = None     # sink(t, states dict) per tick

    def __post_init__(self):
        self.queue: Deque[TrajectoryBatch] = deque()
        self.current: Optional[TrajectoryBatch] = None

    def push(self, start_time: float, trajs):
        """trajsCallback: queue a new batch (numpy, or a tensor read back)
        with its activation time."""
        if isinstance(trajs, torch.Tensor):
            trajs = trajs.detach().cpu().numpy()
        self.queue.append(TrajectoryBatch(start_time, np.asarray(trajs)))

    def _update(self, t: float):
        """update_traj: pop the newest batch whose start time has passed."""
        while self.queue and self.queue[0].start_time <= t:
            self.current = self.queue.popleft()

    def sample(self, t: float):
        """Full states of all agents at wall time t (pos/vel/acc/jerk/omega
        from the flat outputs, polynomial.hpp:63-121), as numpy arrays."""
        self._update(t)
        if self.current is None:
            return None
        tau = np.clip(t - self.current.start_time, 0.0,
                      self.param.M * self.param.dt - 1e-9)
        out = bz.traj_state_batch(
            torch.as_tensor(self.current.trajs, dtype=torch.float64),
            float(tau), self.param.dt)
        states = {k: v.numpy() for k, v in out.items()}
        if self.sink is not None:
            self.sink(t, states)
        return states

    def run_span(self, t0: float, t1: float):
        """Sample the [t0, t1) span at the configured rate."""
        ts = np.arange(t0, t1, 1.0 / self.rate_hz)
        return [self.sample(float(t)) for t in ts]
