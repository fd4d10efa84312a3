"""Batched closest-point geometry (port of lsc_planner_tpu/ops/geometry.py,
reference include/geometry.hpp), and the K nearest neighbours of the LSC
planner's pruning and of ORCA.

Every primitive is an elementwise function of fixed-shape inputs with
selects (torch.where) in place of branches.  The collision-time, closest
point and linear-path helpers serve the ORCA goal mode and RSFC; the
distance, swept-sphere and safe-distance helpers are the library surface
of the JAX module (its callers are tests and tools), kept at its results.
"""
from __future__ import annotations

import torch

_INF = float("inf")


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


def ellipsoidal_distance(p1, p2, downwash):
    """Downwash-aware inter-agent distance: z compressed by 1/downwash
    (util.hpp:225-229 distBetweenAgents through the transform of
    util.hpp:231-240)."""
    delta = p1 - p2
    dz = delta[..., 2] / downwash
    return torch.sqrt(delta[..., 0] ** 2 + delta[..., 1] ** 2 + dz ** 2)


def downwash_transform(points, downwash):
    """z scaled by 1/downwash: the transform of control points before the
    LSC normals (util.hpp:231-240, traj_planner.cpp:1347-1349).  points
    (..., 3), downwash a tensor broadcastable against points[..., 0]."""
    one = torch.ones_like(downwash)
    return points * torch.stack([one, one, 1.0 / downwash], dim=-1)


def pair_downwash(radius_i, downwash_i, radius_j, downwash_j):
    """The combined downwash coefficient of an agent pair
    (traj_planner.cpp:1339-1345)."""
    return (downwash_i * radius_i + downwash_j * radius_j) / \
        (radius_i + radius_j)


def point_box_distance(point, box_min, box_max):
    """Distance from points to axis-aligned boxes (0 inside)."""
    d = torch.clamp(box_min - point, min=0.0) + \
        torch.clamp(point - box_max, min=0.0)
    return torch.linalg.vector_norm(d, dim=-1)


def closest_between_segments(a0, a1, b0, b1, eps=1e-12):
    """Closest points between segments [a0, a1] and [b0, b1], batched:
    the clamped parametric solution with Ericson's two-pass clamp (the
    minimum that closestPointsBetweenLineSegments, geometry.hpp:172-235,
    finds by enumeration).  Returns (closest_a, closest_b, dist)."""
    d1 = a1 - a0
    d2 = b1 - b0
    r = a0 - b0
    A = (d1 * d1).sum(-1)
    e = (d2 * d2).sum(-1)
    f = (d2 * r).sum(-1)
    c = (d1 * r).sum(-1)
    b = (d1 * d2).sum(-1)
    denom = A * e - b * b
    zero = torch.zeros_like(denom)
    # the interior candidate (lines not parallel), else s = 0
    s = torch.where(denom > eps, (b * f - c * e) /
                    torch.where(denom > eps, denom, torch.ones_like(denom)),
                    zero)
    s = torch.clamp(s, 0.0, 1.0)
    # t from s, then s again from the clamped t
    t = torch.where(e > eps, (b * s + f) /
                    torch.where(e > eps, e, torch.ones_like(e)), zero)
    t_cl = torch.clamp(t, 0.0, 1.0)
    s = torch.where(A > eps, (b * t_cl - c) /
                    torch.where(A > eps, A, torch.ones_like(A)), zero)
    s = torch.clamp(s, 0.0, 1.0)
    pa = a0 + d1 * s[..., None]
    pb = b0 + d2 * t_cl[..., None]
    return pa, pb, torch.linalg.vector_norm(pa - pb, dim=-1)


def segment_box_distance(start, goal, box_min, box_max, iters: int = 48,
                         eps=1e-12):
    """Min distance between the segment [start, goal] and an AABB,
    batched: the point-to-box distance along a line is convex in the line
    parameter, so a fixed number of ternary-search steps converges (the
    replacement of the edge enumeration of
    closestPointsBetweenLineSegmentAndStaticObs, geometry.hpp:398-436)."""
    lo = torch.zeros(start.shape[:-1], dtype=start.dtype,
                     device=start.device)
    hi = torch.ones_like(lo)

    def dist_at(t):
        return point_box_distance(start + (goal - start) * t[..., None],
                                  box_min, box_max)

    for _ in range(iters):
        m1 = lo + (hi - lo) / 3.0
        m2 = hi - (hi - lo) / 3.0
        take_lo = dist_at(m1) <= dist_at(m2)
        hi = torch.where(take_lo, m2, hi)
        lo = torch.where(take_lo, lo, m1)
    return dist_at(0.5 * (lo + hi))


def _slab_entry(start, goal, box_min, box_max, radius, eps):
    """The slab test of a radius-sphere moving along [start, goal] against
    the radius-inflated box: (entry parameter, exit parameter, every
    motionless axis inside its slab)."""
    big_min = box_min - radius[..., None]
    big_max = box_max + radius[..., None]
    d = goal - start
    moving = torch.abs(d) > eps
    step = torch.where(moving, d, torch.ones_like(d))
    t1 = (big_min - start) / step
    t2 = (big_max - start) / step
    t_lo = torch.where(moving, torch.minimum(t1, t2),
                       torch.full_like(t1, -_INF))
    t_hi = torch.where(moving, torch.maximum(t1, t2),
                       torch.full_like(t1, _INF))
    inside_static = (start >= big_min) & (start <= big_max)
    ok_static = torch.where(moving, torch.ones_like(moving), inside_static)
    a_min = torch.clamp(t_lo.amax(-1), min=0.0)
    a_max = torch.clamp(t_hi.amin(-1), max=1.0)
    return a_min, a_max, ok_static.all(-1)


def segment_box_collision(start, goal, box_min, box_max, radius,
                          eps=1e-12):
    """Does the radius-sphere moving along [start, goal] hit the box?
    (checkCollisionBetweenLineSegmentAndBox, geometry.hpp:497-551: the
    slab test on the radius-inflated box, then the exact segment-box
    distance, which trims the inflated corners.)  Returns (...,) bool."""
    a_min, a_max, ok_static = _slab_entry(start, goal, box_min, box_max,
                                          radius, eps)
    slab_hit = (a_min <= a_max) & ok_static
    exact = segment_box_distance(start, goal, box_min, box_max) < radius
    return slab_hit & exact


def box_collision_time(start, goal, box_min, box_max, radius, horizon,
                       eps=1e-12):
    """First time in [0, horizon] at which the radius-sphere moving along
    [start, goal] reaches an AABB; +inf if never (computeCollisionTime's
    static-obstacle overload, geometry.hpp:598-642: the slab entry on the
    inflated box, then the sphere's collision time against the box's
    closest point at the entry)."""
    a_min, a_max, ok_static = _slab_entry(start, goal, box_min, box_max,
                                          radius, eps)
    miss = (a_min > a_max) | ~ok_static
    entry = start + (goal - start) * a_min[..., None]
    obs_pt = torch.minimum(torch.maximum(entry, box_min), box_max)
    t = collision_time_linear(obs_pt, obs_pt, start, goal, radius, horizon)
    return torch.where(miss, torch.full_like(t, _INF), t)


def safe_dist_in_direction(position, direction, obs_pos, obs_radius,
                           radius, boxes=None, eps=1e-12):
    """How far `position` can advance along the unit `direction` before it
    reaches an obstacle's safety sphere or a box (safeDistInDirection,
    geometry.hpp:651-708).  position, direction (..., 3); obs_pos (..., O,
    3); obs_radius (..., O); radius (...,); boxes (B, 6) or None.  Returns
    (...,) >= 0, +inf where the ray is clear."""
    rel = obs_pos - position[..., None, :]
    proj = (rel * direction[..., None, :]).sum(-1)            # (..., O)
    perp2 = (rel * rel).sum(-1) - proj * proj
    r_sum = obs_radius + radius[..., None]
    hit = (perp2 < r_sum * r_sum) & (proj > 0)
    back = torch.sqrt(torch.clamp(r_sum * r_sum - perp2, min=0.0))
    cand = torch.where(hit, torch.clamp(proj - back, min=0.0),
                       torch.full_like(proj, _INF))
    # a sphere that already overlaps the position blocks at once
    overlap = (rel * rel).sum(-1) < r_sum * r_sum
    cand = torch.where(overlap, torch.zeros_like(cand), cand)
    safe = cand.amin(-1) if cand.shape[-1] else \
        torch.full(position.shape[:-1], _INF, dtype=position.dtype,
                   device=position.device)
    if boxes is not None and boxes.shape[0]:
        # the reference's fake 10 m ray through box_collision_time
        fake = 10.0
        goal = position + direction * fake
        t = box_collision_time(position[..., None, :], goal[..., None, :],
                               boxes[..., :3], boxes[..., 3:],
                               radius[..., None], 1.0)
        safe = torch.minimum(safe, (fake * t).amin(-1))
    return safe
