"""The K nearest neighbours of the LSC planner's pruning (port of
lsc_planner_tpu/ops/geometry.py)."""
from __future__ import annotations

import torch

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

