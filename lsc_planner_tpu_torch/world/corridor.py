"""Safe Flight Corridor construction: axis-aligned box expansion (port of
lsc_planner_tpu/world/corridor.py).

The reference grows a seed box one voxel face at a time
(CorridorConstructor, corridor_constructor.hpp:184-232).  Every check here
is an O(1) summed-area-table count (world/esdf.py); the face expansion of
the whole swarm is ``ops/corridor.py::expand_boxes``, one kernel launch on
the card (each agent's round-robin in its own thread) and a batched loop
on the CPU.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import SP_EPSILON
from ..ops import corridor as corridor_ops
from .esdf import ESDF, OccupancySAT


@dataclasses.dataclass
class CorridorBuilder:
    esdf: ESDF
    world_min: np.ndarray
    world_max: np.ndarray
    agent_radius: float           # one SAT per distinct radius
    dtype: torch.dtype = torch.float32

    def __post_init__(self):
        self.sat = OccupancySAT.build(self.esdf, self.agent_radius)
        # zero-margin table: raw occupancy, to vet trapped-seed extensions
        self.sat_raw = OccupancySAT.build(self.esdf, 0.0)
        self._wmin = np.asarray(self.world_min, np.float64)
        self._wmax = np.asarray(self.world_max, np.float64)
        self.device = self.esdf.dist.device
        # the world bounds on the device, made once: float32 for
        # _at_world_min, the working dtypes for the in-bounds test
        self._wmin32 = torch.as_tensor(self._wmin, dtype=torch.float32,
                                       device=self.device)
        self._bounds = {}

    def _world_bounds(self, dtype):
        if dtype not in self._bounds:
            self._bounds[dtype] = tuple(
                torch.as_tensor(w, dtype=dtype, device=self.device)
                for w in (self._wmin, self._wmax))
        return self._bounds[dtype]

    # ------------------------------------------------------------------
    def initial_box(self, point):
        """Seed lattice box around points (..., 3) (expandBoxFromPoint,
        corridor_constructor.hpp:18-44): snap to the voxel lattice; within
        1 cm of a lattice plane the box collapses onto it."""
        res = self.esdf.resolution
        p = point / res
        rp = torch.round(p)
        near = torch.abs(point - rp * res) < 0.01
        lo = torch.where(near, rp, torch.floor(p)).to(torch.int32)
        hi = torch.where(near, rp, torch.ceil(p)).to(torch.int32)
        return lo, hi

    def _obstructed(self, lo, hi):
        return self.sat.box_obstructed(
            lo, hi, corridor_ops.at_world_min(lo, self.esdf.resolution,
                                              self._wmin32))

    def _axis_order(self, lo, hi, goal):
        """setAxisCand (corridor_constructor.hpp:142-182) for a batch:
        lo/hi (N, 3) int, goal (N, 3) -> the six face slots (N, 6), toward-
        goal axes first in descending |delta|, away-from-goal last in
        ascending |delta|, with the reference's insertion ties."""
        res = self.esdf.resolution
        mid = 0.5 * (lo + hi).to(goal.dtype) * res
        delta = goal - mid
        values = torch.abs(delta)
        offsets = torch.where(delta > 0, 3, 0)

        v0, v1, v2 = values[:, 0], values[:, 1], values[:, 2]
        front1 = v1 > v0
        o0 = torch.where(front1, 1, 0)
        o1 = torch.where(front1, 0, 1)
        max2 = torch.maximum(v0, v1)
        min2 = torch.where(front1, torch.full_like(v1, float("inf")), v1)
        front2 = v2 > max2
        back2 = (~front2) & (v2 < min2)
        ord0 = torch.where(front2, 2, o0)
        ord1 = torch.where(front2, o0, torch.where(back2, o1, 2))
        ord2 = torch.where(front2, o1, torch.where(back2, 2, o1))
        order = torch.stack([ord0, ord1, ord2], dim=-1)        # (N, 3)

        off_sel = torch.gather(offsets, 1, order)
        first = order + off_sel
        last = order + (3 - off_sel)
        return torch.cat([first, last.flip(-1)], dim=-1)       # (N, 6)

    # ------------------------------------------------------------------
    def expand_boxes(self, points, goals):
        """Expand each seed box around points (N, 3) toward goals (N, 3):
        the exact round-robin face expansion of expand_box
        (corridor_constructor.hpp:184-232) for the whole batch, in bounds in
        the points' dtype (``ops/corridor.py::expand_boxes``).
        Returns (box_min (N, 3), box_max (N, 3) metric, seed_ok (N,))."""
        res = self.esdf.resolution
        lo, hi = self.initial_box(points)
        seed_ok = ~self._obstructed(lo, hi)
        cand = self._axis_order(lo, hi, goals)
        wmin, wmax = self._world_bounds(points.dtype)
        lo, hi = corridor_ops.expand_boxes(lo, hi, cand, seed_ok, self.sat,
                                           self._wmin32, wmin, wmax)
        return (lo.to(points.dtype) * res, hi.to(points.dtype) * res,
                seed_ok)

    def expand_box(self, point, goal):
        """One agent: point/goal (3,) -> (box_min, box_max, seed_ok)."""
        bmin, bmax, ok = self.expand_boxes(point[None], goal[None])
        return bmin[0], bmax[0], ok[0]


def escape_seeds(builder: CorridorBuilder, pts):
    """Relocate seed points trapped inside the static-obstacle margin along
    the ESDF gradient (see the JAX package).  Returns (escaped_pts (N, 3),
    trapped (N,) bool)."""
    esdf = builder.esdf
    res = esdf.resolution
    d0 = esdf.at_points(pts)
    need = (builder.agent_radius + 0.5 * res) - d0
    eye = torch.eye(3, dtype=pts.dtype, device=pts.device) * res
    grad = torch.stack(
        [esdf.at_points(pts + eye[k]) - esdf.at_points(pts - eye[k])
         for k in range(3)], dim=-1) / (2.0 * res)
    nrm = torch.linalg.vector_norm(grad, dim=-1, keepdim=True)
    dirn = grad / torch.clamp(nrm, min=1e-6)
    trapped = need > 0
    return pts + dirn * torch.clamp(need, min=0.0)[:, None], trapped


def update_sfc(sfc_boxes, seed_points, goals, builder: CorridorBuilder,
               initialize):
    """generateFeasibleSFC (traj_planner.cpp:1451-1491), batched.

    sfc_boxes (N, M, 6) [min, max]; seed_points (N, 3), the previous
    solution endpoints (or current positions on (re)initialization);
    initialize (N,) bool.  Shift the window one segment and expand a new
    last-segment box; on initialize fill every segment with it.  A trapped
    seed (obstructed seed box inside the margin) escapes along the ESDF
    gradient and its box is extended back to the held endpoint, vetted
    against raw occupancy; an obstructed seed keeps the previous window.
    Returns (boxes (N, M, 6), ok (N,))."""
    N, M = sfc_boxes.shape[:2]
    res = builder.esdf.resolution

    lo0, hi0 = builder.initial_box(seed_points)
    seed_obstructed = builder._obstructed(lo0, hi0)
    seeds, margin_trapped = escape_seeds(builder, seed_points)
    trapped = seed_obstructed & margin_trapped
    use_seeds = torch.where(trapped[:, None], seeds, seed_points)
    bmin, bmax, ok = builder.expand_boxes(use_seeds, goals)

    ext_min = torch.where(trapped[:, None],
                          torch.minimum(bmin, seed_points), bmin)
    ext_max = torch.where(trapped[:, None],
                          torch.maximum(bmax, seed_points), bmax)
    k0 = builder.sat_raw._k0
    cell_lo = torch.floor(ext_min / res + SP_EPSILON).to(torch.int32) - k0
    cell_hi = (torch.ceil(ext_max / res - SP_EPSILON).to(torch.int32) - 1) \
        - k0
    raw_hit = builder.sat_raw._box_count(cell_lo, cell_hi) > 0
    ok = ok & (~trapped | ~raw_hit)

    new_box = torch.cat([ext_min, ext_max], dim=-1)            # (N, 6)
    shifted = torch.cat([sfc_boxes[:, 1:], new_box[:, None]], dim=1)
    filled = new_box[:, None].expand(N, M, 6)
    out = torch.where(initialize[:, None, None], filled, shifted)
    keep = torch.cat([sfc_boxes[:, 1:], sfc_boxes[:, -1:]], dim=1)
    out = torch.where(ok[:, None, None], out, keep)
    return out, ok
