"""Batched grid path planning: wavefront sweep + LOS sub-goal selection
(port of lsc_planner_tpu/ops/grid_search.py).

The reference's 6-connected unit-cost A* (grid_based_planner.cpp) becomes
a wavefront distance field per agent (``ops/wavefront.py``, a CUDA kernel
on the card), greedy descent of that field for the path, and the
shrinking-margin line-of-sight sub-goal (findLOSFreeGoal,
grid_based_planner.cpp:350-433).  Grids are (N, X, Y, Z) here and
(N, Z, Y, X) at the kernel.  Ties in these integer fields are everywhere:
argmin/argmax take the first index (as jnp's do), rounding is half to
even (torch.round, jnp.round), and a cumulative product of bools runs on
ints.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..config import SP_EPSILON, SP_EPSILON_FLOAT, Param
from ..missions import Mission
from . import wavefront

# (x, y, z) steps of the greedy descent, in the JAX package's order
_NBRS = ((1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0), (0, 0, 1),
         (0, 0, -1))


@dataclasses.dataclass
class GridPlanner:
    mission: Mission
    param: Param
    esdf: object                   # world.esdf.ESDF
    dtype: torch.dtype = torch.float32
    max_wavefront_iters: Optional[int] = None
    max_path_len: Optional[int] = None
    ray_samples: int = 64

    def __post_init__(self):
        p = self.param
        gres = p.grid_resolution
        wmin = np.asarray(self.mission.world_min, np.float64)
        wmax = np.asarray(self.mission.world_max, np.float64)
        # updateGridInfo (grid_based_planner.cpp:70-90): grid snapped
        # toward zero from the world bbox
        self.grid_min = -np.floor((-wmin + SP_EPSILON) / gres) * gres
        self.grid_max = np.floor((wmax + SP_EPSILON) / gres) * gres
        self.dims = np.round(
            (self.grid_max - self.grid_min) / gres).astype(int) + 1
        X, Y, Z = self.dims
        if self.max_wavefront_iters is None:
            self.max_wavefront_iters = int(1.5 * (X + Y + Z))
        if self.max_path_len is None:
            self.max_path_len = int(X + Y + Z)
        self.device = self.esdf.dist.device

        ii, jj, kk = np.meshgrid(np.arange(X), np.arange(Y), np.arange(Z),
                                 indexing="ij")
        pts = (self.grid_min[None, None, None, :] +
               np.stack([ii, jj, kk], axis=-1) * gres)
        self._grid_pts = torch.as_tensor(pts, dtype=self.dtype,
                                         device=self.device)   # (X,Y,Z,3)
        # constant tables on the device, made once
        dev = self.device
        self._gmin = {}
        kr = range(-1, 2)
        self._start_offsets = torch.as_tensor(
            [(i, j, k) for i in range(-2, 3) for j in range(-2, 3)
             for k in kr], dtype=torch.int32, device=dev)
        self._dims_t = torch.as_tensor(self.dims, dtype=torch.int32,
                                       device=dev)
        self._nbr_step = torch.as_tensor([(dx * Y + dy) * Z + dz
                                          for dx, dy, dz in _NBRS],
                                         device=dev)
        self._ratios = torch.as_tensor([1.5, 1.4, 1.3, 1.2, 1.1, 1.0],
                                       dtype=self.dtype, device=dev)

        # static occupancy per distinct agent radius (updateGridMap
        # :110-123: occupied iff esdf < radius + grid_margin)
        self._static_occ = {}
        for r in sorted({round(float(a.radius), 6)
                         for a in self.mission.agents}):
            d = self.esdf.at_points(self._grid_pts)
            self._static_occ[r] = d < (r + p.grid_margin)

    def static_occupancy(self, radius: float):
        return self._static_occ[round(float(radius), 6)]

    # ------------------------------------------------------------------
    def occupancy(self, radius, downwash, obs_pos, obs_radius,
                  obs_downwash, higher_mask):
        """Per-agent grids (N, X, Y, Z) bool with the higher-priority
        agents as ellipsoids (updateGridMap, grid_based_planner.cpp:
        162-189); one pass over the obstacles, as the JAX scan."""
        N = radius.shape[0]
        base = self.static_occupancy(float(self.mission.agents[0].radius))
        occ = base[None].expand(N, *base.shape).clone()
        dw_tot = ((radius[:, None] * downwash[:, None] +
                   obs_radius[None, :] * obs_downwash[None, :]) /
                  (radius[:, None] + obs_radius[None, :]))     # (N, O)
        r_sum = radius[:, None] + obs_radius[None, :]          # (N, O)
        grid = self._grid_pts
        for o in range(obs_pos.shape[0]):
            delta = grid[None] - obs_pos[o]                    # (1,X,Y,Z,3)
            d = torch.sqrt(delta[..., 0] ** 2 + delta[..., 1] ** 2 +
                           (delta[..., 2] /
                            dw_tot[:, o, None, None, None]) ** 2)
            inside = d < r_sum[:, o, None, None, None]
            occ |= inside & higher_mask[:, o, None, None, None]
        return occ

    # ------------------------------------------------------------------
    def _grid_min(self, dtype):
        if dtype not in self._gmin:
            self._gmin[dtype] = torch.as_tensor(self.grid_min, dtype=dtype,
                                                device=self.device)
        return self._gmin[dtype]

    def to_cell(self, point):
        gres = self.param.grid_resolution
        gmin = self._grid_min(point.dtype)
        return torch.round((point - gmin) / gres).to(torch.int32)

    def to_point(self, cell):
        gres = self.param.grid_resolution
        return self._grid_min(self.dtype) + cell.to(self.dtype) * gres

    def _gather(self, grid, cells):
        """grid (N, X, Y, Z), cells (N, ..., 3) in range -> (N, ...)."""
        X, Y, Z = self.dims
        flat = (cells[..., 0].long() * Y + cells[..., 1]) * Z + \
            cells[..., 2]
        N = grid.shape[0]
        return torch.gather(grid.reshape(N, -1), 1,
                            flat.reshape(N, -1)).reshape(flat.shape)

    def recover_start(self, occ, start_cell):
        """Occupied-start recovery for a batch (updateGridMission,
        grid_based_planner.cpp:209-233): the nearest free cell by manhattan
        distance in the 5x5 x/y (x 3 z for 3-D) neighbourhood, ties by scan
        order.  occ (N, X, Y, Z) bool, start_cell (N, 3) int32."""
        dev = start_cell.device
        off, dims = self._start_offsets, self._dims_t
        cand = start_cell[:, None, :] + off[None]              # (N, K, 3)
        ok = ((cand >= 0) & (cand < dims)).all(-1)
        cc = torch.minimum(torch.clamp(cand, min=0), dims - 1)
        free = ok & ~self._gather(occ, cc)
        d = off.abs().sum(-1)                                  # (K,)
        # the first offset in scan order at the least distance among the
        # free ones (the JAX loop's strict d < best_d)
        score = torch.where(free, d[None], 10 ** 9)
        pick = torch.argmin(score, dim=-1)
        best = torch.where(free.any(-1)[:, None],
                           cand[torch.arange(cand.shape[0], device=dev),
                                pick], start_cell)
        occupied0 = self._gather(occ, start_cell)
        return torch.where(occupied0[:, None], best, start_cell)

    def descend_path(self, D, start_cell):
        """Greedy descent of each field D (N, X, Y, Z) from start_cell
        (N, 3) for max_path_len steps (the lppath analog).  Each cell's
        next cell is the first of its six neighbours with the least value,
        taken only when it is below the cell's own; the table is built once
        for the grid and then followed.  Returns metric points
        (N, max_path_len + 1, 3)."""
        N = D.shape[0]
        X, Y, Z = self.dims
        dev = D.device
        inf = float("inf")
        P = torch.nn.functional.pad(D, (1, 1, 1, 1, 1, 1), value=inf)
        vals = torch.stack([
            P[:, 2:, 1:-1, 1:-1], P[:, :-2, 1:-1, 1:-1],
            P[:, 1:-1, 2:, 1:-1], P[:, 1:-1, :-2, 1:-1],
            P[:, 1:-1, 1:-1, 2:], P[:, 1:-1, 1:-1, :-2]], dim=-1)
        best = torch.argmin(vals, dim=-1)        # first index on ties
        move = torch.gather(vals, -1, best[..., None])[..., 0] < D
        step = self._nbr_step
        here = torch.arange(X * Y * Z, device=dev).reshape(1, X, Y, Z)
        nxt = torch.where(move, here + step[best], here).reshape(N, -1)
        cell = ((start_cell[:, 0].long() * Y + start_cell[:, 1]) * Z +
                start_cell[:, 2])[:, None]
        cells = [cell]
        for _ in range(self.max_path_len):
            cell = torch.gather(nxt, 1, cell)
            cells.append(cell)
        flat = torch.cat(cells, dim=1)                         # (N, P)
        xyz = torch.stack([flat // (Y * Z), (flat // Z) % Y, flat % Z],
                          dim=-1)
        return self.to_point(xyz)

    # ------------------------------------------------------------------
    def _ray_safe_sampled(self, pts, init_end, radius, ratios):
        """Sampled sphere-cover admissibility of every (agent, ratio, path
        point) ray from init_end.  Returns (N, 6, P) bool."""
        t = torch.linspace(0.0, 1.0, self.ray_samples, dtype=pts.dtype,
                           device=pts.device)
        ray = init_end[:, None, None, :] + \
            (pts - init_end[:, None, :])[:, :, None, :] * \
            t[None, None, :, None]
        min_clear = self.esdf.at_points(ray).amin(-1)          # (N, P)
        thr = (radius[:, None] * ratios[None, :] +
               0.5 * self.param.world_resolution - SP_EPSILON_FLOAT)
        return min_clear[:, None, :] > thr[:, :, None]

    def los_free_goal(self, path_points, init_end, desired_goal, radius):
        """findLOSFreeGoal (grid_based_planner.cpp:350-407): the furthest
        path point in line of sight of the initial-trajectory endpoint,
        with margin ratios 1.5 -> 1.0 until the sub-goal moves > 0.3 m, and
        the path floor when no ratio moves (the sampled ray check).
        path_points (N, P, 3), init_end/desired_goal (N, 3), radius (N,)
        -> (N, 3)."""
        N = path_points.shape[0]
        pts = torch.cat([path_points, desired_goal[:, None]], dim=1)
        P = pts.shape[1]
        ratios = self._ratios
        safe = self._ray_safe_sampled(pts, init_end, radius, ratios)
        prefix_safe = torch.cumprod(safe.to(torch.int32), dim=-1).bool()
        n_safe = prefix_safe.sum(-1)                           # (N, 6)
        last_idx = torch.clamp(n_safe - 1, min=0)
        los = torch.gather(pts[:, None].expand(N, 6, P, 3), 2,
                           last_idx[..., None, None].expand(N, 6, 1, 3)
                           )[:, :, 0]                          # (N, 6, 3)
        any_safe = n_safe > 0
        los = torch.where(any_safe[..., None], los, init_end[:, None, :])
        moved = torch.linalg.vector_norm(los - init_end[:, None, :],
                                         dim=-1) > 0.3         # (N, 6)
        first = torch.argmax(moved.to(torch.uint8), dim=1)
        any_moved = moved.any(1)
        first = torch.where(any_moved, first, 5)
        sel = los[torch.arange(N, device=pts.device), first]
        floor_pt = pts[:, min(2, P - 1), :]
        sel_d = torch.linalg.vector_norm(sel - init_end, dim=-1)
        floor_d = torch.linalg.vector_norm(floor_pt - init_end, dim=-1)
        prefer_floor = (~any_moved) & (floor_d > sel_d)
        return torch.where(prefer_floor[:, None], floor_pt, sel)

    # ------------------------------------------------------------------
    def plan_goals(self, pos, init_end, desired_goal, radius, downwash,
                   obs_pos, obs_radius, obs_downwash, higher_mask):
        """occupancy -> wavefront (with priority obstacles; the static-only
        field where the start is cut off, traj_planner.cpp:594-599) ->
        descent path -> LOS goal.  Two wavefront launches a call.
        Returns (los_goal (N, 3), path_floor (N, 3))."""
        occ_hp = self.occupancy(radius, downwash, obs_pos, obs_radius,
                                obs_downwash, higher_mask)
        occ_st = self.static_occupancy(
            float(self.mission.agents[0].radius))[None].expand(
                occ_hp.shape)
        start = self.to_cell(pos)
        goal = self.to_cell(desired_goal)
        start = self.recover_start(occ_hp, start)

        iters = self.max_wavefront_iters
        D_hp = wavefront.wavefront_distance(occ_hp, goal, max_iters=iters)
        D_st = wavefront.wavefront_distance(occ_st, goal, max_iters=iters)
        reachable = self._gather(D_hp, start) < float("inf")
        D = torch.where(reachable[:, None, None, None], D_hp, D_st)

        path = self.descend_path(D, start)                     # (N, P, 3)
        los = self.los_free_goal(path, init_end, desired_goal, radius)
        floor = path[:, min(2, path.shape[1] - 1), :]
        return los, floor
