"""Run visualization: the rviz/graph_rviz_plugin analog (the port's own
copy of lsc_planner_tpu/sim/visualize.py, numpy host code).

The reference's live observability is ~20 rviz marker topics (agent
trajectories, collision models, corridors, goals) plus velocity/
acceleration time-series plots (multi_sync_simulator.cpp:339-356,
:885-916).  Here the same content renders offline from a result CSV (or a
ReplayData) into PNG/SVG via matplotlib: a top-down trajectory plot with
agent collision discs and world/obstacle geometry, and per-axis
velocity/acceleration series with the dynamic limits.  matplotlib is
imported by plot_run alone: without it, plot_run raises ImportError and
the rest of the package is unaffected.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from .replay import ReplayData


def plot_run(data: ReplayData, out_path: str,
             world_min=None, world_max=None,
             occupancy=None, occ_origin=None, occ_resolution=None,
             max_vel: Optional[float] = None,
             max_acc: Optional[float] = None) -> str:
    """Render a recorded run: trajectory map + vel/acc time series."""
    try:
        import matplotlib
    except ImportError as err:
        raise ImportError("plot_run (the CLI's --plot) needs matplotlib, "
                          "which this Python does not have") from err
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib import colormaps

    qn = data.qn
    cmap = colormaps["hsv"]
    colors = [cmap(qi / max(qn, 1)) for qi in range(qn)]

    fig = plt.figure(figsize=(14, 7))
    ax = fig.add_subplot(1, 2, 1)
    ax.set_title("trajectories (top-down)")
    ax.set_aspect("equal")

    if occupancy is not None:
        occ2d = np.any(occupancy, axis=2)
        res = occ_resolution
        x0 = occ_origin[0] * res
        y0 = occ_origin[1] * res
        ax.imshow(occ2d.T, origin="lower", cmap="Greys", alpha=0.6,
                  extent=(x0, x0 + occ2d.shape[0] * res,
                          y0, y0 + occ2d.shape[1] * res))
    if world_min is not None:
        ax.plot([world_min[0], world_max[0], world_max[0], world_min[0],
                 world_min[0]],
                [world_min[1], world_min[1], world_max[1], world_max[1],
                 world_min[1]], "k--", lw=0.8)

    for qi in range(qn):
        ax.plot(data.pos[:, qi, 0], data.pos[:, qi, 1],
                color=colors[qi], lw=1.2)
        ax.scatter([data.pos[0, qi, 0]], [data.pos[0, qi, 1]],
                   color=colors[qi], marker="o", s=25)
        ax.scatter([data.pos[-1, qi, 0]], [data.pos[-1, qi, 1]],
                   color=colors[qi], marker="*", s=60)
        circ = plt.Circle((data.pos[-1, qi, 0], data.pos[-1, qi, 1]),
                          data.radius[qi], color=colors[qi], alpha=0.3)
        ax.add_patch(circ)
    if data.obs_pos is not None:
        for oi in range(data.obs_pos.shape[1]):
            ax.plot(data.obs_pos[:, oi, 0], data.obs_pos[:, oi, 1],
                    "k-", lw=1.0, alpha=0.7)

    ax_v = fig.add_subplot(2, 2, 2)
    ax_a = fig.add_subplot(2, 2, 4)
    vmag = np.linalg.norm(data.vel, axis=-1)
    amag = np.linalg.norm(data.acc, axis=-1)
    for qi in range(qn):
        ax_v.plot(data.t, vmag[:, qi], color=colors[qi], lw=0.8)
        ax_a.plot(data.t, amag[:, qi], color=colors[qi], lw=0.8)
    if max_vel:
        ax_v.axhline(max_vel, color="r", ls="--", lw=0.8)
    if max_acc:
        ax_a.axhline(max_acc, color="r", ls="--", lw=0.8)
    ax_v.set_ylabel("|v| (m/s)")
    ax_a.set_ylabel("|a| (m/s^2)")
    ax_a.set_xlabel("t (s)")

    fig.tight_layout()
    fig.savefig(out_path, dpi=110)
    plt.close(fig)
    return out_path


def save_normal_vector_csv(path: str, seqs, normals, qn: int) -> str:
    """Research export: pairwise LSC normal-vector sums per cycle
    (saveNormalVectorAsCSV, multi_sync_simulator.cpp:635-669).

    normals: list of (N, N, 3) arrays (agent i's LSC normal toward agent j
    at segment 0) per recorded cycle.
    """
    with open(path, "w") as f:
        header = ["t"]
        for qi in range(qn):
            for qj in range(qi + 1, qn):
                header.append(f"({qi}-{qj})")
        f.write(",".join(header) + "\n")
        for seq, nrm in zip(seqs, normals):
            row = [f"{seq}"]
            for qi in range(qn):
                for qj in range(qi + 1, qn):
                    s = nrm[qi, qj] + nrm[qj, qi]
                    row.append(f"{s[0]:.6g}")
            f.write(",".join(row) + "\n")
    return path
