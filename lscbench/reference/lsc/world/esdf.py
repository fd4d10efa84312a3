"""Euclidean signed-distance field + summed-area occupancy (port of
lsc_planner_tpu/world/esdf.py).

The EDT is computed once per world on the host (scipy's exact transform)
and kept on the device as a dense grid; every per-cycle query is a gather.
SFC box checks are O(1) summed-area-table counts with the inclusion-
exclusion correction that reproduces the reference's corner-sampling cell
set (isObstacleInBox, corridor_constructor.hpp:81-122).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..config import SP_EPSILON_FLOAT
from ..device import resolve_device


@dataclasses.dataclass
class ESDF:
    """Dense distance field over the mission bbox: dist[i, j, k] is the
    distance (m) from the centre of voxel origin_key + ijk to the nearest
    occupied voxel centre, clamped at max_dist (dynamicEDT3D's convention).
    Cell centres sit at (key + 0.5) * resolution."""
    dist: torch.Tensor           # (X, Y, Z) float, on the simulator's device
    origin_key: np.ndarray       # (3,) int64
    resolution: float
    max_dist: float = 1.0
    occ: Optional[np.ndarray] = None   # host copy of the occupancy grid

    @classmethod
    def from_boxes(cls, boxes, world_min, world_max,
                   resolution: float = 0.1, max_dist: float = 1.0,
                   dtype=torch.float32, device=None) -> "ESDF":
        """Distance field of mission `static` AABB obstacles alone, on
        `device` (the CUDA device unless another is named)."""
        device = resolve_device(device)
        world_min = np.asarray(world_min, np.float64)
        world_max = np.asarray(world_max, np.float64)
        k0 = np.floor(world_min / resolution).astype(np.int64)
        k1 = np.floor(world_max / resolution).astype(np.int64)
        dims = tuple(k1 - k0 + 1)
        base = cls(dist=torch.full(dims, max_dist, dtype=dtype,
                                   device=device),
                   origin_key=k0, resolution=float(resolution),
                   max_dist=float(max_dist), occ=np.zeros(dims, bool))
        return base.merge_boxes(boxes)

    def merge_boxes(self, boxes) -> "ESDF":
        """dist' = min(dist, analytic box distance) in float64 on the host;
        occ' marks the cells whose centre lies in a box."""
        boxes = np.asarray(boxes, np.float64).reshape(-1, 6)
        if boxes.shape[0] == 0:
            return self
        X, Y, Z = self.dist.shape
        res = self.resolution
        centers = (np.stack(np.meshgrid(
            np.arange(X), np.arange(Y), np.arange(Z), indexing="ij"),
            axis=-1) + 0.5 + self.origin_key) * res      # (X, Y, Z, 3)
        d = self.dist.cpu().double().numpy()
        occ = (self.occ.copy() if self.occ is not None
               else np.zeros((X, Y, Z), bool))
        for lo_hi in boxes:
            lo, hi = lo_hi[:3], lo_hi[3:]
            q = np.maximum(np.maximum(lo - centers, centers - hi), 0.0)
            bd = np.sqrt(np.sum(q * q, axis=-1))
            d = np.minimum(d, bd)
            occ |= bd <= 0.0
        dist = torch.as_tensor(np.minimum(d, self.max_dist),
                               dtype=self.dist.dtype, device=self.dist.device)
        return dataclasses.replace(self, dist=dist, occ=occ)

    # ------------------------------------------------------------------
    def _consts(self, dtype):
        """(origin (3,) in `dtype`, last cell index (3,)) on dist's device,
        made once (a host->device copy each query would sync the host)."""
        cache = self.__dict__.setdefault("_const_cache", {})
        if dtype not in cache:
            dev = self.dist.device
            cache[dtype] = (
                torch.as_tensor(self.origin_key, dtype=dtype, device=dev) *
                self.resolution,
                torch.as_tensor(self.dist.shape, device=dev) - 1)
        return cache[dtype]

    def at_points(self, pts):
        """getDistance at metric points (..., 3): nearest cell, indices
        clamped to the grid."""
        res = self.resolution
        origin, last = self._consts(pts.dtype)
        idx = torch.floor((pts - origin) / res).to(torch.int64)
        idx = torch.minimum(torch.clamp(idx, min=0), last)
        X, Y, Z = self.dist.shape
        flat = (idx[..., 0] * Y + idx[..., 1]) * Z + idx[..., 2]
        return self.dist.reshape(-1)[flat]


@dataclasses.dataclass
class OccupancySAT:
    """3-D integral image of a thresholded occupancy indicator:
    sat[i, j, k] counts the occupied-for-this-margin cells in the prefix box
    [0, i) x [0, j) x [0, k)."""
    sat: torch.Tensor            # (X+1, Y+1, Z+1) int32
    origin_key: np.ndarray
    resolution: float
    margin: float

    def __post_init__(self):
        # constant tables on the table's device, made once
        dev = self.sat.device
        S = self.sat.shape
        self._dims = torch.as_tensor([S[0] - 1, S[1] - 1, S[2] - 1],
                                     device=dev)
        self._k0 = torch.as_tensor(self.origin_key, device=dev)
        # corner c of a box takes hi on axis a when bit a of c is set; its
        # sign is (-1)^(3 - set bits)
        self._corner_bits = torch.as_tensor(
            [[(c >> a) & 1 for a in range(3)] for c in range(8)],
            dtype=torch.bool, device=dev)
        self._corner_sign = torch.as_tensor(
            [(-1) ** (3 - bin(c).count("1")) for c in range(8)], device=dev)
        # inclusion-exclusion term m fixes the axes of its set bits to the
        # excluded plane; its sign is (-1)^(set bits)
        self._term_sign = torch.as_tensor(
            [(-1) ** bin(m).count("1") for m in range(8)], device=dev)

    @classmethod
    def build(cls, esdf: ESDF, margin: float) -> "OccupancySAT":
        """Occupied iff dist < margin + resolution/2 - eps
        (corridor_constructor.hpp:114)."""
        thr = margin + 0.5 * esdf.resolution - SP_EPSILON_FLOAT
        ind = (esdf.dist.cpu().numpy() < thr).astype(np.int32)
        sat = np.zeros(tuple(s + 1 for s in ind.shape), np.int32)
        sat[1:, 1:, 1:] = ind.cumsum(0).cumsum(1).cumsum(2)
        return cls(sat=torch.as_tensor(sat, device=esdf.dist.device),
                   origin_key=np.asarray(esdf.origin_key),
                   resolution=esdf.resolution, margin=margin)

    def _box_count(self, lo, hi):
        """Occupied cells in the cell box [lo, hi] inclusive, lo/hi (..., 3)
        integer grid-local indices; empty or out-of-range boxes count 0.
        The eight corners are one gather."""
        S = self.sat.shape
        lo_c = torch.minimum(torch.clamp(lo.long(), min=0), self._dims)
        hi_c = torch.minimum(torch.clamp(hi.long() + 1, min=0), self._dims)
        empty = (hi_c <= lo_c).any(-1)
        corner = torch.where(self._corner_bits, hi_c[..., None, :],
                             lo_c[..., None, :])               # (..., 8, 3)
        flat = (corner[..., 0] * S[1] + corner[..., 1]) * S[2] + \
            corner[..., 2]
        vals = self.sat.reshape(-1)[flat]                      # (..., 8)
        c = (vals * self._corner_sign).sum(-1)
        return torch.where(empty, torch.zeros_like(c), c)

    def box_obstructed(self, lo_corner, hi_corner, at_world_min):
        """Reference-exact isObstacleInBox over a lattice box.

        lo_corner/hi_corner: (..., 3) ABSOLUTE voxel-corner indices;
        at_world_min: (..., 3) bool, whether the low face sits at the world
        minimum.  Per axis the sampled cells are {lo-1} u [lo+1, hi] away
        from the boundary and [lo, hi] at it; the eight inclusion-exclusion
        terms are counted in one batched _box_count."""
        lo = lo_corner.long() - self._k0
        hi = hi_corner.long() - self._k0
        bound = at_world_min.long()
        a = lo - 1 + bound
        T = self._corner_bits                                  # (8, 3)
        t_lo = torch.where(T, lo[..., None, :], a[..., None, :])
        t_hi = torch.where(T, lo[..., None, :], hi[..., None, :])
        cnt = self._box_count(t_lo, t_hi)                      # (..., 8)
        # a bound axis has no excluded plane: its T=1 terms vanish
        valid = ~(T & (bound[..., None, :] != 0)).any(-1)
        total = torch.where(valid, self._term_sign * cnt,
                            torch.zeros_like(cnt)).sum(-1)
        return total > 0
