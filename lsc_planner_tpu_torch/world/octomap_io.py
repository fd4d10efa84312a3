"""Octomap ``.bt`` binary-octree reader (host-side, numpy; the port's own
copy of lsc_planner_tpu/world/octomap_io.py).

Replaces the reference's dependency on the octomap library
(``octomap::OcTree::readBinary``, used in MultiSyncSimulator::setOctomap,
multi_sync_simulator.cpp:153-167).  The .bt format is a text header
(id/size/res lines up to ``data``) followed by a depth-first stream of
2-bytes-per-node child descriptors: 2 bits per child --
01 = occupied leaf, 10 = free leaf, 11 = inner node (recurse), 00 = absent.

Octomap's key space is 16 levels deep; a node at depth d covers
2^(16-d) voxels per axis, and voxel centers sit at (key - 32768 + 0.5)*res.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

_TREE_DEPTH = 16
_KEY_OFFSET = 32768


@dataclasses.dataclass
class OctomapTree:
    resolution: float
    # occupied leaf cubes: key coords of the low corner (in voxel units,
    # already offset-corrected) and edge length in voxels
    occupied_low: np.ndarray      # (L, 3) int64 voxel index of low corner
    occupied_size: np.ndarray     # (L,) int64 edge length in voxels
    free_low: np.ndarray
    free_size: np.ndarray

    def occupied_centers(self) -> np.ndarray:
        """Metric centers of occupied leaf cubes (for debugging/vis)."""
        half = self.occupied_size[:, None] * 0.5
        return (self.occupied_low + half) * self.resolution


def _parse_header(data: bytes) -> Tuple[float, int, int]:
    pos = 0
    res = None
    size = None
    if not data.startswith(b"# Octomap OcTree binary file"):
        raise ValueError("not an octomap .bt file")
    while True:
        eol = data.index(b"\n", pos)
        line = data[pos:eol].decode("latin1").strip()
        pos = eol + 1
        if line.startswith("#"):
            continue
        if line == "data":
            break
        key, _, val = line.partition(" ")
        if key == "res":
            res = float(val)
        elif key == "size":
            size = int(val)
        elif key == "id" and val not in ("OcTree", "1"):
            raise ValueError(f"unsupported octree id {val!r}")
    if res is None:
        raise ValueError(".bt header missing res")
    return res, size or 0, pos


def load_bt(path: str, occupied_bit: str = "first") -> OctomapTree:
    """Parse a .bt octree.

    occupied_bit: which bit of each 2-bit child descriptor marks an
    occupied leaf.  The shipped reference worlds are inconsistent: the
    forest/simple_forest files read sensibly with the first bit
    (tree-shaped occupied clumps), while office.bt reads as a 92 %-solid
    block that way and as a clean wall floor plan with the SECOND bit --
    its generator evidently wrote the opposite convention.  Callers that
    don't know the provenance should use ESDF.from_bt's auto-detection
    (mostly-solid worlds are implausible for planning)."""
    with open(path, "rb") as f:
        data = f.read()
    res, _, pos = _parse_header(data)
    swap = occupied_bit == "second"

    occ_low: List[Tuple[int, int, int, int]] = []
    free_low: List[Tuple[int, int, int, int]] = []

    # iterative DFS; stack holds (low_x, low_y, low_z, depth) of nodes whose
    # descriptor is next in the stream (children pushed in reverse order so
    # child 0 is read first, matching octomap's recursion order)
    root_size = 1 << _TREE_DEPTH
    stack = [(0, 0, 0, 0)]
    while stack:
        lx, ly, lz, depth = stack.pop()
        b1, b2 = data[pos], data[pos + 1]
        pos += 2
        half = 1 << (_TREE_DEPTH - depth - 1)
        inner_children = []
        for i in range(8):
            byte = b1 if i < 4 else b2
            j = i if i < 4 else i - 4
            bit1 = (byte >> (2 * j)) & 1
            bit2 = (byte >> (2 * j + 1)) & 1
            cx = lx + (half if (i & 1) else 0)
            cy = ly + (half if (i & 2) else 0)
            cz = lz + (half if (i & 4) else 0)
            if bit1 and bit2:
                inner_children.append((cx, cy, cz, depth + 1))
            elif bit2 if swap else bit1:
                occ_low.append((cx, cy, cz, half))
            elif bit1 if swap else bit2:
                free_low.append((cx, cy, cz, half))
        for child in reversed(inner_children):
            stack.append(child)

    def pack(items):
        if not items:
            return (np.zeros((0, 3), np.int64), np.zeros((0,), np.int64))
        arr = np.asarray(items, dtype=np.int64)
        return arr[:, :3] - _KEY_OFFSET, arr[:, 3]

    ol, osz = pack(occ_low)
    fl, fsz = pack(free_low)
    return OctomapTree(resolution=res, occupied_low=ol, occupied_size=osz,
                       free_low=fl, free_size=fsz)


def rasterize(tree: OctomapTree, world_min, world_max) -> tuple:
    """Dense occupancy grid over [world_min, world_max].

    Grid cell (i, j, k) covers voxel key (k0 + i) per axis; cell centers at
    (key + 0.5) * res, matching DynamicEDTOctomap's boundary snapping
    (coordToKey of the bbox corners).
    Returns (occ bool (X, Y, Z), grid_origin_key (3,) int64).
    """
    res = tree.resolution
    world_min = np.asarray(world_min, np.float64)
    world_max = np.asarray(world_max, np.float64)
    k0 = np.floor(world_min / res).astype(np.int64)
    k1 = np.floor(world_max / res).astype(np.int64)
    dims = (k1 - k0 + 1)
    occ = np.zeros(tuple(dims), dtype=bool)
    low = tree.occupied_low
    size = tree.occupied_size
    for c in range(low.shape[0]):
        lo = np.maximum(low[c] - k0, 0)
        hi = np.minimum(low[c] + size[c] - k0, dims)
        if np.any(lo >= hi):
            continue
        occ[lo[0]:hi[0], lo[1]:hi[1], lo[2]:hi[2]] = True
    return occ, k0
