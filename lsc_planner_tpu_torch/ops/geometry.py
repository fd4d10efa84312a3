"""Batched closest-point geometry (port of collision_time_linear, the
point-to-segment distance of the ORCA goal mode and the linear-path
helpers of RSFC from lsc_planner_tpu/ops/geometry.py; its other helpers
have no caller on the ported paths), and the K nearest neighbours of the
LSC planner's pruning and of ORCA."""
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


def closest_point_on_segment(point, a, b, eps=1e-12):
    """Closest point on segment [a, b] to `point`, all (..., 3): (closest,
    dist) (closestPointsBetweenPointAndLineSegment, geometry.hpp:57-93)."""
    ab = b - a
    denom = (ab * ab).sum(-1, keepdim=True)
    t = ((point - a) * ab).sum(-1, keepdim=True) / torch.clamp(denom,
                                                                min=eps)
    closest = a + torch.clamp(t, 0.0, 1.0) * ab
    return closest, torch.linalg.vector_norm(point - closest, dim=-1)


def closest_between_linear_paths(p1_start, p1_goal, p2_start, p2_goal,
                                 eps=1e-12):
    """The closest approach of two points moving together along their
    segments, min over alpha in [0, 1] of ||p1(alpha) - p2(alpha)||
    (closestPointsBetweenLinePaths, geometry.hpp:96-121).  Returns
    (closest1, closest2, dist)."""
    rel_start = p2_start - p1_start
    rel_goal = p2_goal - p1_goal
    rel_closest, dist = closest_point_on_segment(
        torch.zeros_like(rel_start), rel_start, rel_goal, eps)
    seg_len = torch.linalg.vector_norm(rel_goal - rel_start, dim=-1,
                                       keepdim=True)
    alpha = torch.where(
        seg_len > eps,
        torch.linalg.vector_norm(rel_closest - rel_start, dim=-1,
                                 keepdim=True) / torch.clamp(seg_len,
                                                             min=eps),
        torch.zeros_like(seg_len))
    closest1 = p1_start + (p1_goal - p1_start) * alpha
    closest2 = p2_start + (p2_goal - p2_start) * alpha
    return closest1, closest2, dist


def normal_vector_between_paths(obs_start, obs_goal, agent_start, agent_goal,
                                eps=1e-10):
    """The separating normal of linear predictions (TrajPlanner::
    normalVector, traj_planner.cpp:1869-1892): from the obstacle's to the
    agent's closest point, or, where the paths touch, (b - a) x z_hat with
    a, b the relative start and goal (x_hat when that vanishes too).
    Returns (normal (..., 3), closest_dist (...,))."""
    c1, c2, dist = closest_between_linear_paths(obs_start, obs_goal,
                                                agent_start, agent_goal)
    delta = c2 - c1
    nrm = torch.linalg.vector_norm(delta, dim=-1, keepdim=True)
    normal = delta / torch.clamp(nrm, min=eps)
    a = agent_start - obs_start
    b = agent_goal - obs_goal
    z_hat = torch.zeros_like(a)
    z_hat[..., 2].fill_(1.0)
    x_hat = torch.zeros_like(a)
    x_hat[..., 0].fill_(1.0)
    alt = torch.linalg.cross(b - a, z_hat, dim=-1)
    alt_n = torch.linalg.vector_norm(alt, dim=-1, keepdim=True)
    alt = torch.where(alt_n > eps, alt / torch.clamp(alt_n, min=eps), x_hat)
    return torch.where(nrm > eps, normal, alt), dist


def knn_select(pos, obs_pos, self_mask, K: int):
    """The K nearest obstacles of each agent: (squared distances ascending
    (L, K), indices (L, K)).  The squares are summed over the axes in the
    JAX order, and a stable sort breaks ties by the lower index as
    ``lax.top_k`` does (a circle puts neighbours i - k and i + k at equal
    distances, so the K-th pick depends on it)."""
    diff = obs_pos[None, :, :] - pos[:, None, :]
    d2 = diff[..., 0] ** 2 + diff[..., 1] ** 2 + diff[..., 2] ** 2
    d2 = torch.where(self_mask, float("inf"), d2)
    sel_d2, nbr = torch.sort(d2, dim=-1, stable=True)
    return sel_d2[:, :K], nbr[:, :K]
