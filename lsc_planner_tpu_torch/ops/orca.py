"""Batched 3-D ORCA (port of lsc_planner_tpu/ops/orca.py).

The math is the JAX package's (RVO2-3D's plane construction,
Agent.cpp:119-195, and its incremental linear programs lp1-lp4,
Agent.cpp:228-445, with the planner's non-reciprocal share for dynamic
obstacles), every branch a select.  Only the loops are restructured, so
that a solve dispatches O(O) sequential steps instead of the O(O^4) loop
bodies of the literal nesting:

- lp1's loop over the planes is a running max / min of the line parameter
  with a fail latch.  Max and min are exact and a failing prefix implies a
  failing whole, so it is a masked reduction over the planes: the same
  (ok, t_left, t_right) wherever ok holds (where it does not, every
  caller discards the result).
- lp2's per-plane lp1 calls depend only on planes i and plane_no, never on
  lp2's running (result, ok): all O of them run as one batch, and lp2's
  scan over i is a chain of selects.
- lp3's per-plane lp2 calls never read lp3's running (result, fail): one
  batch over i again (``_lp2_core`` with plane_no = i), then a scan of
  selects.
- lp4's projected problem for plane i depends only on (planes, i): all O
  projected plane sets are built and their lp3s solved in one batch, then
  lp4's scan over i selects.

Nothing reads the device from the host, so a CUDA graph of several cycles
holds ORCA cycles.  2-D worlds add two planes pinning v_z = 0, as in the
JAX package.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .geometry import knn_select

RVO_EPSILON = 1e-5


class OrcaPlanes(NamedTuple):
    normal: torch.Tensor   # (..., O, 3)
    point: torch.Tensor    # (..., O, 3)
    valid: torch.Tensor    # (..., O) bool


def _dot(a, b):
    """Sum over the last axis of 3, added in the JAX order ((x + y) + z)
    by elementwise kernels: a reduction kernel's order differs between the
    CPU and the card, and the linear programs amplify that ulp
    (tests/test_torch_cuda.py holds the card to the CPU)."""
    p = a * b
    return p[..., 0] + p[..., 1] + p[..., 2]


def _norm(v):
    return torch.sqrt(_dot(v, v))


def _cross(a, b):
    """jnp.cross over the last axis, each component's two products and
    their difference a kernel of its own, for the same reason: a fused
    multiply-add inside one cross kernel on the card would round them
    otherwise than the CPU."""
    a0, a1, a2 = a.unbind(-1)
    b0, b1, b2 = b.unbind(-1)
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2,
                        a0 * b1 - a1 * b0], dim=-1)


def _select(cond, a, b):
    """jnp.where over vectors: cond (...) picks a or b (..., 3)."""
    return torch.where(cond[..., None], a, b)


def build_orca_planes(pos, vel, radius, obs_pos, obs_vel, obs_radius,
                      obs_is_dynamic, obs_mask, time_horizon, time_step):
    """ORCA planes of one agent block against its neighbours
    (Agent::computeNewVelocity, RVO2-3D/Agent.cpp:119-195).

    pos/vel: (N, 3); radius: (N,); obs_*: (N, O, ...) per-agent neighbour
    views; obs_mask: (N, O) valid-neighbour mask."""
    rel_pos = obs_pos - pos[..., None, :]
    rel_vel = vel[..., None, :] - obs_vel
    dist_sq = _dot(rel_pos, rel_pos)
    comb_r = radius[..., None] + obs_radius
    comb_r_sq = comb_r ** 2
    inv_th = 1.0 / time_horizon
    inv_ts = 1.0 / time_step

    # no collision: the cut-off circle or the cone's side
    w = rel_vel - inv_th * rel_pos
    w_len_sq = _dot(w, w)
    dot1 = _dot(w, rel_pos)
    proj_cutoff = (dot1 < 0.0) & (dot1 ** 2 > comb_r_sq * w_len_sq)

    w_len = torch.sqrt(torch.clamp(w_len_sq, min=1e-20))
    unit_w = w / w_len[..., None]
    n_cut = unit_w
    u_cut = (comb_r * inv_th - w_len)[..., None] * unit_w

    a = dist_sq
    b = _dot(rel_pos, rel_vel)
    cr = _cross(rel_pos, rel_vel)
    gap = dist_sq - comb_r_sq
    denom = torch.where(torch.abs(gap) > 1e-12, gap,
                        torch.full_like(gap, 1e-12))
    c = _dot(rel_vel, rel_vel) - _dot(cr, cr) / denom
    disc = torch.clamp(b * b - a * c, min=0.0)
    t = (b + torch.sqrt(disc)) / torch.clamp(a, min=1e-12)
    w_cone = rel_vel - t[..., None] * rel_pos
    wc_len = torch.clamp(_norm(w_cone), min=1e-12)
    unit_wc = w_cone / wc_len[..., None]
    n_cone = unit_wc
    u_cone = (comb_r * t - wc_len)[..., None] * unit_wc

    n_nc = _select(proj_cutoff, n_cut, n_cone)
    u_nc = _select(proj_cutoff, u_cut, u_cone)

    # collision: leave the other's disc within one time step
    w_col = rel_vel - inv_ts * rel_pos
    wl_col = torch.clamp(_norm(w_col), min=1e-12)
    unit_col = w_col / wl_col[..., None]
    u_col = (comb_r * inv_ts - wl_col)[..., None] * unit_col

    collision = dist_sq <= comb_r_sq
    normal = _select(collision, unit_col, n_nc)
    u = _select(collision, u_col, u_nc)

    # half the avoidance for reciprocal agents, all of it for
    # non-reciprocal dynamic obstacles (the planner's RVO2 change)
    share = torch.where(obs_is_dynamic, 1.0, 0.5).to(u.dtype)
    point = vel[..., None, :] + share[..., None] * u
    return OrcaPlanes(normal=normal, point=point, valid=obs_mask)


# ---------------------------------------------------------------------------
# linear programs (Agent.cpp:228-445)
# ---------------------------------------------------------------------------

def _lp1(planes: OrcaPlanes, upto, line_pt, line_dir, radius, opt_vel,
         direction_opt: bool):
    """Clip a line against the sphere and planes[:upto]; optimize along it.
    Returns (ok, result).  planes' batch dims broadcast against the line's
    (...); upto is an int tensor broadcasting to (...)."""
    dot = _dot(line_pt, line_dir)
    disc = dot ** 2 + radius ** 2 - _dot(line_pt, line_pt)
    ok0 = disc >= 0.0
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    t_left0, t_right0 = -dot - sq, -dot + sq

    O = planes.valid.shape[-1]
    idx = torch.arange(O, device=line_pt.device)
    active = (idx < upto[..., None]) & planes.valid            # (..., O)
    num = _dot(planes.point - line_pt[..., None, :], planes.normal)
    den = _dot(line_dir[..., None, :], planes.normal)
    parallel = den ** 2 <= RVO_EPSILON
    t = num / torch.where(parallel, torch.ones_like(den), den)
    # the JAX loop's running max / min until its first failure: the
    # reductions over all active planes agree wherever no plane fails
    bound = active & ~parallel
    left = torch.where(bound & (den >= 0.0), t, float("-inf")).amax(-1)
    right = torch.where(bound & (den < 0.0), t, float("inf")).amin(-1)
    t_left = torch.maximum(t_left0, left)
    t_right = torch.minimum(t_right0, right)
    fail_par = (active & parallel & (num > 0.0)).any(-1)
    ok = ok0 & ~fail_par & ~(t_left > t_right)

    if direction_opt:
        t_star = torch.where(_dot(opt_vel, line_dir) > 0.0, t_right, t_left)
    else:
        t_star = torch.minimum(torch.maximum(
            _dot(line_dir, opt_vel - line_pt), t_left), t_right)
    return ok, line_pt + t_star[..., None] * line_dir


def _lp2_core(planes: OrcaPlanes, n_p, p_p, plane_no, radius, opt_vel,
              direction_opt: bool):
    """lp2 on plane (n_p, p_p) of index plane_no, batched: planes' batch
    dims broadcast against n_p's (...).  Returns (ok, result)."""
    plane_dist = _dot(p_p, n_p)
    ok0 = plane_dist ** 2 <= radius ** 2
    plane_r_sq = torch.clamp(radius ** 2 - plane_dist ** 2, min=0.0)
    plane_center = plane_dist[..., None] * n_p

    if direction_opt:
        # project the direction onto the plane
        pov = opt_vel - _dot(opt_vel, n_p)[..., None] * n_p
        pov_sq = _dot(pov, pov)
        result0 = _select(
            pov_sq <= RVO_EPSILON, plane_center,
            plane_center + torch.sqrt(plane_r_sq / torch.clamp(
                pov_sq, min=1e-20))[..., None] * pov)
    else:
        # project the point onto the plane, then onto the disc
        res_pt = opt_vel + _dot(p_p - opt_vel, n_p)[..., None] * n_p
        out = _dot(res_pt, res_pt) > radius ** 2
        pr = res_pt - plane_center
        pr_sq = torch.clamp(_dot(pr, pr), min=1e-20)
        res_pt_c = plane_center + torch.sqrt(plane_r_sq / pr_sq)[..., None] \
            * pr
        result0 = _select(out, res_pt_c, res_pt)

    # the line where plane i meets plane plane_no, for every i at once
    # (axis -2), and lp1 along each against planes[:i]
    n_i, p_i = planes.normal, planes.point                     # (..., O, 3)
    O = planes.valid.shape[-1]
    crossp = _cross(n_i, n_p[..., None, :])
    cross_sq = _dot(crossp, crossp)
    degen = cross_sq <= RVO_EPSILON
    line_dir = crossp / torch.sqrt(torch.clamp(cross_sq, min=1e-20))[..., None]
    line_n = _cross(line_dir, n_p[..., None, :])
    denom = _dot(line_n, n_i)
    coef = _dot(p_i - p_p[..., None, :], n_i) / torch.where(
        torch.abs(denom) > 1e-20, denom, torch.full_like(denom, 1e-20))
    line_pt = p_p[..., None, :] + coef[..., None] * line_n
    inner = OrcaPlanes(planes.normal[..., None, :, :],
                       planes.point[..., None, :, :],
                       planes.valid[..., None, :])
    ok1, res1 = _lp1(inner, torch.arange(O, device=n_p.device), line_pt,
                     line_dir, radius[..., None], opt_vel[..., None, :],
                     direction_opt)
    fail = degen | ~ok1                                        # (..., O)

    result, ok = result0, ok0
    for i in range(O):
        active = (i < plane_no) & planes.valid[..., i] & ok
        violated = _dot(n_i[..., i, :], p_i[..., i, :] - result) > 0.0
        run = active & violated
        result = _select(run & ~fail[..., i], res1[..., i, :], result)
        ok = ok & ~(run & fail[..., i])
    return ok, result


def _lp2(planes: OrcaPlanes, plane_no, radius, opt_vel,
         direction_opt: bool):
    """Optimize on plane `plane_no` inside the sphere, honouring
    planes[:plane_no].  Returns (ok, result)."""
    idx = plane_no[..., None, None].expand(*plane_no.shape, 1, 3)
    n_p = torch.gather(planes.normal, -2, idx)[..., 0, :]
    p_p = torch.gather(planes.point, -2, idx)[..., 0, :]
    return _lp2_core(planes, n_p, p_p, plane_no, radius, opt_vel,
                     direction_opt)


def _lp3(planes: OrcaPlanes, radius, opt_vel, direction_opt: bool):
    """Incremental LP over all planes.  Returns (fail_plane, result) with
    fail_plane == O when fully feasible."""
    O = planes.valid.shape[-1]
    vv = _dot(opt_vel, opt_vel)
    if direction_opt:
        result = opt_vel * radius[..., None]
    else:
        norm_ov = torch.sqrt(torch.clamp(vv, min=1e-20))
        res_out = opt_vel / norm_ov[..., None] * radius[..., None]
        result = _select(vv <= radius ** 2, opt_vel, res_out)

    # lp2 on every plane i at once (none reads this loop's state)
    each = OrcaPlanes(planes.normal[..., None, :, :],
                      planes.point[..., None, :, :],
                      planes.valid[..., None, :])
    ok2, res2 = _lp2_core(each, planes.normal, planes.point,
                          torch.arange(O, device=opt_vel.device),
                          radius[..., None], opt_vel[..., None, :],
                          direction_opt)

    fail = torch.full(radius.shape, O, dtype=torch.int32,
                      device=opt_vel.device)
    for i in range(O):
        n_i, p_i = planes.normal[..., i, :], planes.point[..., i, :]
        valid = planes.valid[..., i] & (fail == O)
        run = valid & (_dot(n_i, p_i - result) > 0.0)
        result = _select(run & ok2[..., i], res2[..., i, :], result)
        fail = torch.where(run & ~ok2[..., i], i, fail).to(torch.int32)
    return fail, result


def _lp4(planes: OrcaPlanes, begin_plane, radius, result):
    """Penetration-minimizing fallback when lp3 fails
    (Agent.cpp:396-444)."""
    O = planes.valid.shape[-1]
    dev = result.device
    # plane i's projected problem, for every i at once: axis -3 is i,
    # axis -2 the projected plane j
    n_i = planes.normal[..., :, None, :]
    p_i = planes.point[..., :, None, :]
    n_j = planes.normal[..., None, :, :]
    p_j = planes.point[..., None, :, :]
    crossp = _cross(n_j, n_i)
    cross_sq = _dot(crossp, crossp)
    degen = cross_sq <= RVO_EPSILON
    same_dir = _dot(n_j, n_i) > 0.0
    pp_degen = 0.5 * (p_i + p_j)
    line_n = _cross(crossp, n_i)
    denom = _dot(line_n, n_j)
    coef = _dot(p_j - p_i, n_j) / torch.where(
        torch.abs(denom) > 1e-20, denom, torch.full_like(denom, 1e-20))
    pp_reg = p_i + coef[..., None] * line_n
    proj_pt = _select(degen, pp_degen, pp_reg)
    pn = n_j - n_i
    pn = pn / torch.sqrt(torch.clamp(_dot(pn, pn), min=1e-20))[..., None]
    idx = torch.arange(O, device=dev)
    proj_valid = (planes.valid[..., None, :] &
                  (idx[None, :] < idx[:, None]) & ~(degen & same_dir))
    proj = OrcaPlanes(normal=pn, point=proj_pt, valid=proj_valid)
    fail_j, res4 = _lp3(proj, radius[..., None].expand(*radius.shape, O),
                        planes.normal, True)
    lp3_ok = fail_j >= O                                       # (..., O)

    distance = torch.zeros(radius.shape, dtype=result.dtype, device=dev)
    for i in range(O):
        n, p = planes.normal[..., i, :], planes.point[..., i, :]
        active = (i >= begin_plane) & planes.valid[..., i]
        run = active & (_dot(n, p - result) > distance)
        result = _select(run & lp3_ok[..., i], res4[..., i, :], result)
        distance = torch.where(run, _dot(n, p - result), distance)
    return result


def solve_orca(planes: OrcaPlanes, max_speed, pref_vel):
    """newVelocity = argmin ||v - pref|| s.t. ORCA planes, |v| <= max_speed,
    with the lp4 penetration fallback."""
    fail, result = _lp3(planes, max_speed, pref_vel, False)
    O = planes.valid.shape[-1]
    need4 = fail < O
    result4 = _lp4(planes, fail, max_speed, result)
    return _select(need4, result4, result)


def neighbours(pos, max_neighbors: int):
    """Each agent's nearest others (geometry.knn_select, ties to the lower
    index as ``lax.top_k``): (squared distances (N, K), indices (N, K)),
    K = min(max_neighbors, N - 1) (1 for a lone agent)."""
    N = pos.shape[0]
    eye = torch.eye(N, dtype=torch.bool, device=pos.device)
    return knn_select(pos, pos, eye, min(max_neighbors, N - 1) if N > 1
                      else 1)


def orca_velocities(pos, vel, radius, pref_vel, max_speed,
                    is_dynamic, time_horizon, time_step,
                    neighbor_dist=15.0, max_neighbors=10,
                    force_z_zero=False):
    """All-agents ORCA velocities (updateORCAVelocity3D analog,
    traj_planner.cpp:1149-1223): every agent avoids its max_neighbors
    nearest others within neighbor_dist (the kd-tree's selection).

    pos/vel/pref_vel: (N, 3); radius (already inflation-scaled): (N,);
    max_speed: (N,); is_dynamic: (N,) bool (non-reciprocal obstacles)."""
    N = pos.shape[0]
    nbr_d2, nbr = neighbours(pos, max_neighbors)
    mask = nbr_d2 < neighbor_dist ** 2
    planes = build_orca_planes(
        pos, vel, radius, obs_pos=pos[nbr], obs_vel=vel[nbr],
        obs_radius=radius[nbr], obs_is_dynamic=is_dynamic[nbr],
        obs_mask=mask, time_horizon=time_horizon, time_step=time_step)
    if force_z_zero:
        # 2-D worlds: two more planes pin v_z to 0
        zplus = torch.zeros((N, 1, 3), dtype=pos.dtype, device=pos.device)
        zplus[..., 2].fill_(1.0)
        planes = OrcaPlanes(
            normal=torch.cat([planes.normal, zplus, -zplus], dim=1),
            point=torch.cat([planes.point, torch.zeros(
                (N, 2, 3), dtype=pos.dtype, device=pos.device)], dim=1),
            valid=torch.cat([planes.valid, torch.ones(
                (N, 2), dtype=torch.bool, device=pos.device)], dim=1))
    return solve_orca(planes, max_speed, pref_vel)
