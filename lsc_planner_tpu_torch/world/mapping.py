"""Mapping pipeline: point clouds -> voxel occupancy -> ``.bt`` octomaps
(the port's own copy of lsc_planner_tpu/world/mapping.py).

Host-side analog of the reference's ``launch/mapping/`` pipelines
(kinect/zed/pcd -> octomap_server -> saved .bt world files, SURVEY.md
component 24): real-world sensor data becomes a world file the planner
loads.  Covers loading point clouds (.pcd ascii/binary, .xyz text),
voxelizing them at a chosen resolution, and writing a pruned binary
octree in the exact octomap .bt format our reader (octomap_io.load_bt)
and the reference's ``octomap::OcTree::readBinary`` both parse.

All coordinates follow octomap's key space: voxel key = floor(p / res),
stored offset-corrected (key - 32768) like OctomapTree.occupied_low.
"""
from __future__ import annotations

import struct
from typing import Optional

import numpy as np

from .octomap_io import _KEY_OFFSET, _TREE_DEPTH


def load_pcd(path: str) -> np.ndarray:
    """Read a PCL .pcd file's x/y/z columns -> (P, 3) float64.

    Supports DATA ascii and DATA binary with float32/float64 fields
    (the formats the reference's mapping launch files consume via
    pcl_ros, launch/mapping/*.launch).
    """
    with open(path, "rb") as f:
        data = f.read()
    # header is ascii lines up to and including the DATA line
    lines = []
    pos = 0
    while True:
        eol = data.index(b"\n", pos)
        line = data[pos:eol].decode("latin1").strip()
        pos = eol + 1
        if line and not line.startswith("#"):
            lines.append(line)
        if line.startswith("DATA"):
            break
    hdr = {}
    for line in lines:
        key, _, val = line.partition(" ")
        hdr[key.upper()] = val.split()
    fields = [f.lower() for f in hdr.get("FIELDS", [])]
    sizes = [int(s) for s in hdr.get("SIZE", [])]
    types = hdr.get("TYPE", ["F"] * len(fields))
    counts = [int(c) for c in hdr.get("COUNT", ["1"] * len(fields))]
    n_pts = int(hdr.get("POINTS", hdr.get("WIDTH", ["0"]))[0])
    mode = hdr["DATA"][0].lower()
    for ax in ("x", "y", "z"):
        if ax not in fields:
            raise ValueError(f".pcd missing field {ax!r}")

    if mode == "ascii":
        rows = np.loadtxt(data[pos:].decode("latin1").splitlines(),
                          dtype=np.float64, ndmin=2)
        cols = []
        col0 = np.cumsum([0] + counts)
        for ax in ("x", "y", "z"):
            cols.append(rows[:, col0[fields.index(ax)]])
        return np.stack(cols, axis=1)
    if mode != "binary":
        raise ValueError(f"unsupported .pcd DATA mode {mode!r}")

    fmt_of = {("F", 4): "f", ("F", 8): "d", ("I", 4): "i", ("U", 4): "I",
              ("I", 2): "h", ("U", 2): "H", ("I", 1): "b", ("U", 1): "B"}
    np_fields = []
    for name, size, typ, cnt in zip(fields, sizes, types, counts):
        ch = fmt_of.get((typ.upper(), size))
        if ch is None:
            raise ValueError(f"unsupported .pcd field {name} {typ}{size}")
        np_fields.append((name, "<" + ch, (cnt,)) if cnt > 1
                         else (name, "<" + ch))
    arr = np.frombuffer(data, dtype=np.dtype(np_fields), count=n_pts,
                        offset=pos)
    pts = np.stack([arr["x"], arr["y"], arr["z"]], axis=1)
    return np.asarray(pts, np.float64)


def load_xyz(path: str) -> np.ndarray:
    """Plain whitespace-separated x y z text file -> (P, 3)."""
    return np.loadtxt(path, dtype=np.float64, usecols=(0, 1, 2), ndmin=2)


def voxelize(points: np.ndarray, resolution: float,
             world_min=None, world_max=None) -> np.ndarray:
    """Unique occupied voxel keys (offset-corrected) from a point cloud.

    Points with NaN/inf (sensor dropouts) are discarded; an optional
    bounding box crops the cloud (octomap_server's filter_ground /
    bbox params analog).
    """
    pts = np.asarray(points, np.float64)
    good = np.isfinite(pts).all(axis=1)
    pts = pts[good]
    if world_min is not None:
        pts = pts[(pts >= np.asarray(world_min)).all(axis=1)]
    if world_max is not None:
        pts = pts[(pts <= np.asarray(world_max)).all(axis=1)]
    keys = np.floor(pts / resolution).astype(np.int64)
    if keys.size and (np.abs(keys).max() >= _KEY_OFFSET):
        raise ValueError("points exceed octomap key range at this "
                         "resolution")
    return np.unique(keys, axis=0)


def occupancy_to_keys(occ: np.ndarray, origin_key) -> np.ndarray:
    """Dense occupancy grid (from octomap_io.rasterize) -> voxel keys."""
    idx = np.argwhere(occ)
    return idx + np.asarray(origin_key, np.int64)[None, :]


_OCC, _FREE, _INNER = 1, 2, 3     # 2-bit child descriptors


def save_bt(path: str, occupied_keys: np.ndarray, resolution: float,
            free_keys: Optional[np.ndarray] = None) -> int:
    """Write occupied (and optional free) voxels as a pruned .bt octree.

    Inverse of octomap_io.load_bt: child descriptors are 2 bits each
    (01 occupied leaf, 10 free leaf, 11 inner, 00 unknown), depth-first,
    child 0 first; cubes whose voxels are all one label are pruned to a
    single leaf, exactly like octomap's prune() before writeBinary.
    Returns the node count written.
    """
    occ = np.asarray(occupied_keys, np.int64) + _KEY_OFFSET
    free = (np.asarray(free_keys, np.int64) + _KEY_OFFSET
            if free_keys is not None and len(free_keys)
            else np.zeros((0, 3), np.int64))
    if occ.shape[0] == 0:
        raise ValueError("cannot write an empty octomap")
    for arr in (occ, free):
        if arr.size and (arr.min() < 0 or arr.max() >= (1 << _TREE_DEPTH)):
            raise ValueError("voxel keys out of the 16-level octree range")

    out = bytearray()
    n_nodes = 0

    # iterative DFS mirroring the reader: emit a node's descriptor, then
    # recurse into inner children in order.  A child cube is an occupied/
    # free leaf when every voxel in it carries that single label.
    def descend(occ_k, free_k, low, depth):
        nonlocal n_nodes
        n_nodes += 1
        half = 1 << (_TREE_DEPTH - depth - 1)
        full = half ** 3
        b = [0, 0]
        inner = []
        for i in range(8):
            c_low = low + np.array([half if (i & 1) else 0,
                                    half if (i & 2) else 0,
                                    half if (i & 4) else 0])
            o = occ_k[((occ_k >= c_low) & (occ_k < c_low + half)).all(1)]
            fr = free_k[((free_k >= c_low) &
                         (free_k < c_low + half)).all(1)]
            if len(o) == 0 and len(fr) == 0:
                code = 0
            elif len(fr) == 0 and (len(o) == full or half == 1):
                code = _OCC
                n_nodes += 1
            elif len(o) == 0 and (len(fr) == full or half == 1):
                code = _FREE
                n_nodes += 1
            else:
                code = _INNER
                inner.append((o, fr, c_low, depth + 1))
            byte, j = (0, i) if i < 4 else (1, i - 4)
            b[byte] |= (code & 1) << (2 * j)
            b[byte] |= ((code >> 1) & 1) << (2 * j + 1)
        out.append(b[0])
        out.append(b[1])
        return inner

    stack = [(occ, free, np.zeros(3, np.int64), 0)]
    while stack:
        node = stack.pop(0) if len(stack) == 1 else stack.pop(0)
        children = descend(*node)
        # DFS order: children of the node just emitted come next
        stack = children + stack

    header = (b"# Octomap OcTree binary file\n"
              b"id OcTree\n"
              + f"size {n_nodes}\n".encode()
              + f"res {resolution:.6g}\n".encode()
              + b"data\n")
    with open(path, "wb") as f:
        f.write(header + bytes(out))
    return n_nodes


def pointcloud_to_bt(points: np.ndarray, resolution: float,
                     out_path: str, world_min=None, world_max=None) -> int:
    """One-call pipeline: cloud -> voxels -> .bt world file."""
    keys = voxelize(points, resolution, world_min, world_max)
    return save_bt(out_path, keys, resolution)
