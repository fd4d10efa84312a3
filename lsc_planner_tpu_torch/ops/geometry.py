"""Batched closest-point geometry (port of collision_time_linear from
lsc_planner_tpu/ops/geometry.py; the other helpers come with ORCA, ROADMAP
queue 1, item 13)."""
from __future__ import annotations

import torch


def collision_time_linear(obs_start, obs_goal, agent_start, agent_goal,
                          collision_dist, horizon, eps=1e-12):
    """First time in [0, horizon] when two linearly moving points get closer
    than collision_dist; +inf if never (computeCollisionTime,
    geometry.hpp:553-642, linear-path case).  The relative motion
    r(t) = r0 + (t / T)(r1 - r0) is solved for ||r(t)|| = R; parallel and
    zero-length relative paths (a <= eps) never hit after t = 0."""
    r0 = agent_start - obs_start
    r1 = agent_goal - obs_goal
    d = r1 - r0
    a = (d * d).sum(-1)
    b = 2.0 * (r0 * d).sum(-1)
    c = (r0 * r0).sum(-1) - collision_dist ** 2
    inf = torch.full_like(a, float("inf"))
    t_hit0 = torch.where(c <= 0, torch.zeros_like(a), inf)   # already inside
    disc = b * b - 4 * a * c
    sqrt_disc = torch.sqrt(torch.clamp(disc, min=0.0))
    s1 = (-b - sqrt_disc) / torch.clamp(2 * a, min=eps)
    valid = (disc >= 0) & (a > eps) & (s1 >= 0.0) & (s1 <= 1.0)
    t_hit = torch.where(valid, s1 * horizon, inf)
    return torch.minimum(t_hit0, t_hit)
