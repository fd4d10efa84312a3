"""Collision constraints: LSC, BVC, reciprocal RSFC and SFC planes (port
of lsc_planner_tpu/planner/constraints.py).

Each generator is one batched tensor program over every (agent, obstacle,
segment) triple (generateLSC / generateBVC / generateReciprocalRSFC,
traj_planner.cpp:1254-1440); the LSC planes are one kernel launch on the
card (ops/lsc_planes.py, csrc/planes.cu).  Contractions over the 3-D
coordinate are written as products and sums, never as matmuls, so world
coordinates stay exact f32 on every device.  ``box_pair_planes``, the
planes of a two-box SFC transition, is host-side numpy, as in the JAX
package (no planner path calls it).
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops import geometry as geo
from ..ops import hull as hull_ops
from ..ops import lsc_planes as lsc_ops
from ..ops.lsc_planes import pair_downwash
from .optimizer import PlaneConstraints


def lsc_planes(init_traj, obs_pred, agent_radius, agent_downwash,
               obs_radius, obs_downwash, obs_is_agent, obs_mask,
               slack_flags=None, obs_pred_sizes=None,
               guard_margin: float = 0.0) -> PlaneConstraints:
    """Linear Safe Corridor planes for all (agent, obstacle, segment).

    init_traj: (N, M, n+1, 3); obs_pred: (N, O, M, n+1, 3);
    agent_radius/downwash: (N,); obs_radius/downwash, obs_is_agent,
    obs_mask: (N, O).  guard_margin inflates each row's margin by
    min(guard, s0/2), s0 its slack at the initial trajectory, which keeps
    the shifted previous solution feasible (see the JAX package).  With
    slack_flags (N, O) and obs_pred_sizes (N, O, M, n+1) (the disturbance
    path, traj_planner.cpp:1395-1400) a slack-flagged non-agent obstacle
    takes the RSFC margin, its inflated size plus the agent's radius.
    One kernel launch on the card, the plain PyTorch program on the CPU
    (ops/lsc_planes.py)."""
    return lsc_ops.lsc_planes(init_traj, obs_pred, agent_radius,
                              agent_downwash, obs_radius, obs_downwash,
                              obs_is_agent, obs_mask, slack_flags=slack_flags,
                              obs_pred_sizes=obs_pred_sizes,
                              guard_margin=guard_margin)


def bvc_planes(init_traj, obs_pred, agent_radius, agent_downwash,
               obs_radius, obs_downwash, obs_is_agent,
               obs_mask) -> PlaneConstraints:
    """Buffered Voronoi Cell planes (generateBVC, traj_planner.cpp:
    1409-1440): one normal an obstacle from the current relative position,
    the same on every segment.  The downwash mixes both coefficients for
    every obstacle, as the JAX package does."""
    N, O, M = obs_pred.shape[:3]
    dw = ((agent_downwash[:, None] * agent_radius[:, None] +
           obs_downwash * obs_radius) / (agent_radius[:, None] + obs_radius))
    scale = torch.stack([torch.ones_like(dw), torch.ones_like(dw),
                         1.0 / dw], dim=-1)                       # (N, O, 3)
    p_agent = init_traj[:, 0, 0, :]
    p_obs = obs_pred[:, :, 0, 0, :]
    rel = (p_agent[:, None] - p_obs) * scale
    nrm = torch.linalg.vector_norm(rel, dim=-1, keepdim=True)
    normal_t = rel / torch.clamp(nrm, min=1e-10)
    collision_dist = agent_radius[:, None] + obs_radius
    d = 0.5 * (collision_dist + (rel * normal_t).sum(-1))
    normal = torch.cat([normal_t[..., :2],
                        normal_t[..., 2:3] / dw[..., None]], dim=-1)
    normal_m = normal[:, :, None, :].expand(N, O, M, 3)
    rhs = d[:, :, None, None] + (obs_pred * normal_m[..., None, :]).sum(-1)
    mask = obs_mask[..., None].expand(N, O, M)
    return PlaneConstraints(normal=normal_m, rhs=rhs, mask=mask)


def rsfc_planes(init_traj, obs_pred, obs_pred_sizes, agent_radius,
                agent_downwash, obs_radius, obs_downwash, obs_is_agent,
                obs_mask) -> PlaneConstraints:
    """Reciprocal RSFC planes (generateReciprocalRSFC, traj_planner.cpp:
    1254-1307): the normal from the closest points of the linear relative
    paths between segment endpoints, the margin from the inflated obstacle
    sizes (half the gap for a near agent), z divided by downwash^2."""
    obs_start = obs_pred[..., 0, :]                      # (N, O, M, 3)
    obs_goal = obs_pred[..., -1, :]
    a_start = init_traj[:, None, :, 0, :].expand(obs_start.shape)
    a_goal = init_traj[:, None, :, -1, :].expand(obs_goal.shape)
    normal, closest_dist = geo.normal_vector_between_paths(
        obs_start, obs_goal, a_start, a_goal)
    r_sum = obs_pred_sizes + agent_radius[:, None, None, None]
    near = (obs_is_agent[..., None, None] &
            (closest_dist[..., None] < r_sum))
    d = torch.where(near, 0.5 * (r_sum + closest_dist[..., None]), r_sum)
    dw = pair_downwash(agent_radius[:, None], agent_downwash[:, None],
                       obs_radius, obs_downwash, obs_is_agent)
    normal = torch.cat([normal[..., :2],
                        normal[..., 2:3] / (dw ** 2)[..., None, None]],
                       dim=-1)
    rhs = d + (obs_pred * normal[..., None, :]).sum(-1)
    N, O, M = obs_pred.shape[:3]
    mask = obs_mask[..., None].expand(N, O, M)
    return PlaneConstraints(normal=normal, rhs=rhs, mask=mask)


def sfc_planes(boxes, active, init_traj=None,
               guard_margin: float = 0.0) -> PlaneConstraints:
    """Safe Flight Corridor box faces as planes (Box::convertToLSCs,
    collision_constraints.cpp:37-59): boxes (N, M, 6) [min, max]; active
    (N,) or scalar bool.  Six rows a segment box: +e_k >= box_min_k and
    -e_k >= -box_max_k.  With init_traj (N, M, n+1, 3) each face is pulled
    in by the lsc_planes guard band, min(guard, s0/2), s0 that control
    point's slack at the initial trajectory."""
    N, M = boxes.shape[:2]
    eye = torch.eye(3, dtype=boxes.dtype, device=boxes.device)
    normals = torch.cat([eye, -eye], dim=0)                  # (6, 3)
    normal = normals[None, :, None, :].expand(N, 6, M, 3)
    rhs = torch.cat([boxes[..., :3], -boxes[..., 3:]], dim=-1)   # (N, M, 6)
    rhs = rhs.permute(0, 2, 1)[..., None]                    # (N, 6, M, 1)
    if guard_margin > 0.0 and init_traj is not None:
        lhs0 = (normals[None, :, None, None, :] *
                init_traj[:, None]).sum(-1)                  # (N, 6, M, n+1)
        rhs = rhs + torch.clamp(0.5 * (lhs0 - rhs), 0.0, guard_margin)
    n1 = rhs.shape[-1]
    if isinstance(active, torch.Tensor):
        active = active.to(boxes.device).expand(N)
    else:       # a fill on the device, not a host copy
        active = torch.full((N,), bool(active), dtype=torch.bool,
                            device=boxes.device)
    mask = active[:, None, None].expand(N, 6, M)
    return PlaneConstraints(normal=normal, rhs=rhs.expand(N, 6, M, n1),
                            mask=mask)


def box_pair_planes(hull_points, box1_min, box1_max, box2_min, box2_max,
                    eps=1e-6):
    """Extra LSC planes of a two-box SFC transition (SFC::update,
    collision_constraints.cpp:232-331): for every edge of the two boxes'
    intersection that lies on both boxes' boundaries but not on their
    union's, a half-space that separates the control-point hull from the
    incut corner.  Host-side numpy in float64; the closest points go
    through hull.closest_point_to_hull on the CPU (its FISTA branch past 8
    points).

    Returns (points (E, 3), normals (E, 3)) of the planes
    {x : n . (x - p) >= 0}, or empty arrays when the transition is invalid
    (the boxes disjoint, or the hull outside both)."""
    hull_points = np.asarray(hull_points, float)
    b1 = (np.asarray(box1_min, float), np.asarray(box1_max, float))
    b2 = (np.asarray(box2_min, float), np.asarray(box2_max, float))
    inter_min = np.maximum(b1[0], b2[0])
    inter_max = np.minimum(b1[1], b2[1])
    uni_min = np.minimum(b1[0], b2[0])
    uni_max = np.maximum(b1[1], b2[1])
    empty = (np.zeros((0, 3)), np.zeros((0, 3)))
    if np.any(inter_min > inter_max - eps):
        return empty

    def in_box(p, lo, hi):
        return bool(np.all(p > lo - eps) and np.all(p < hi + eps))

    for pt in hull_points:
        if not (in_box(pt, *b1) or in_box(pt, *b2)):
            return empty

    def box_edges(lo, hi):
        edges = []
        for ax in range(3):
            o1, o2 = (ax + 1) % 3, (ax + 2) % 3
            for a in (lo[o1], hi[o1]):
                for b in (lo[o2], hi[o2]):
                    s, e = np.zeros(3), np.zeros(3)
                    s[ax], e[ax] = lo[ax], hi[ax]
                    s[o1] = e[o1] = a
                    s[o2] = e[o2] = b
                    edges.append((s, e))
        return edges

    def on_boundary(s, e, lo, hi):
        # the segment lies in a face plane of [lo, hi], inside the box
        for p in (s, e):
            if not in_box(p, lo, hi):
                return False
        for ax in range(3):
            if abs(s[ax] - e[ax]) < eps and (
                    abs(s[ax] - lo[ax]) < eps or abs(s[ax] - hi[ax]) < eps):
                return True
        return False

    verts = [np.asarray([ix, iy, iz])
             for ix in (inter_min[0], inter_max[0])
             for iy in (inter_min[1], inter_max[1])
             for iz in (inter_min[2], inter_max[2])]

    pts_out, nrm_out = [], []
    for (s, e) in box_edges(inter_min, inter_max):
        if not (on_boundary(s, e, *b1) and on_boundary(s, e, *b2)):
            continue
        if on_boundary(s, e, uni_min, uni_max):
            continue
        d = e - s
        dn = d / max(np.linalg.norm(d), eps)
        proj = []
        for pt in hull_points:
            r = pt - s
            proj.append(r - dn * dn.dot(r))
        for v in verts:
            if np.linalg.norm(s - v) < eps or np.linalg.norm(e - v) < eps:
                continue
            r = v - s
            proj.append(r - dn * dn.dot(r))
        proj = np.stack(proj)
        closest, dist = hull_ops.closest_point_to_hull(
            torch.as_tensor(proj[None]))
        closest = closest.numpy()[0]
        dist = float(dist[0])
        if dist > eps:
            normal = closest / dist
        else:
            # degenerate: a supporting direction from the projected set
            # (collision_constraints.cpp:290-327)
            normal = None
            for pr in proj:
                if np.linalg.norm(pr) < eps:
                    continue
                cand = np.cross(pr, dn)
                nc = np.linalg.norm(cand)
                if nc < eps:
                    continue
                cand = cand / nc
                for sign in (1.0, -1.0):
                    if np.all(proj.dot(sign * cand) > -eps):
                        normal = sign * cand
                        break
                if normal is not None:
                    break
            if normal is None:
                return empty
        pts_out.append(s)
        nrm_out.append(normal)
    if not pts_out:
        return empty
    return np.stack(pts_out), np.stack(nrm_out)


def concat_planes(*plane_sets, n_ctrl: int) -> PlaneConstraints:
    """Concatenate plane sets along the constraint axis, broadcasting rhs to
    (N, C, M, n_ctrl)."""
    normals, rhss, masks = [], [], []
    for ps in plane_sets:
        if ps is None:
            continue
        N, C, M = ps.normal.shape[:3]
        rhs = ps.rhs.expand(N, C, M, n_ctrl) \
            if ps.rhs.shape[-1] != n_ctrl else ps.rhs
        normals.append(ps.normal)
        rhss.append(rhs)
        masks.append(ps.mask)
    return PlaneConstraints(normal=torch.cat(normals, dim=1),
                            rhs=torch.cat(rhss, dim=1),
                            mask=torch.cat(masks, dim=1))
