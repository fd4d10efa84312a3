"""Batched 6-connected wavefront distance fields, plain PyTorch (frozen
copy of the port's ``ops/wavefront.py`` plain version; never the kernel).

Port of the JAX package's TPU kernel ``ops/wavefront_pallas.py::
_wavefront_kernel`` (wrapper ``wavefront_batched``).  On a CUDA tensor
``wavefront_batched`` launches the hand-written kernel
(``csrc/wavefront.cu``) or raises; on a CPU tensor it runs
``wavefront_batched_plain``.  There is no fallback from one to the other.

Semantics, shared by the kernel and the plain version bit for bit: per
agent, Jacobi min-plus relaxation from the goal cell (free even when
occupied), each step reading the previous step's field; a convergence test
after every group of 8 steps; the loop ends when a group changed no cell or
at ``max_iters`` rounded up to a multiple of 8.  Unreachable and blocked
cells hold BIG.  The plain version runs that Jacobi loop; the kernel
computes the same bits as a breadth-first search by levels (the note in
``csrc/wavefront.cu`` says why they agree).  (The JAX package's CPU path,
``GridPlanner.wavefront``, runs exactly ``max_wavefront_iters`` steps with
inf for unreachable cells; the two agree once the field has converged.)
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


BIG = 1e9
GROUP = 8                   # relaxation steps between convergence tests
# The grid one block holds: the kernel keeps three bitsets of one bit a
# cell in shared memory (free cells, and the reached set double-buffered)
# as 64-bit words, ceil(X / 64) a (z, y) row, with a zero halo row on each
# side in y and z; a block may use 232,448 B (csrc/wavefront.cu checks the
# same bytes: kWordBytes, bitset_words, kMaxSmem).
WORD_BYTES = 3 * 8
MAX_SMEM_BYTES = 232448


def _goal_mask(shape, goal_zyx, device):
    N, Z, Y, X = shape
    zz = torch.arange(Z, device=device)[None, :, None, None]
    yy = torch.arange(Y, device=device)[None, None, :, None]
    xx = torch.arange(X, device=device)[None, None, None, :]
    g = goal_zyx.long()
    return ((zz == g[:, 0, None, None, None]) &
            (yy == g[:, 1, None, None, None]) &
            (xx == g[:, 2, None, None, None]))


def _relax(D, blocked):
    """One Jacobi step: min over the cell and its six neighbours + 1 (BIG
    beyond the grid), BIG on blocked cells."""
    P = F.pad(D, (1, 1, 1, 1, 1, 1), value=BIG)
    best = D
    for nb in (P[:, 1:-1, 1:-1, 2:], P[:, 1:-1, 1:-1, :-2],      # x+1, x-1
               P[:, 1:-1, 2:, 1:-1], P[:, 1:-1, :-2, 1:-1],      # y+1, y-1
               P[:, 2:, 1:-1, 1:-1], P[:, :-2, 1:-1, 1:-1]):     # z+1, z-1
        best = torch.minimum(best, nb + 1.0)
    return torch.where(blocked, torch.full_like(best, BIG), best)


def wavefront_batched_plain(occ_zyx, goal_zyx, max_iters: int = 512):
    """occ_zyx (N, Z, Y, X) f32 (1 = blocked), goal_zyx (N, 3) int (z, y,
    x) -> (D (N, Z, Y, X) f32 with BIG unreachable, steps (N,) int32
    relaxation steps each agent's loop ran)."""
    is_goal = _goal_mask(occ_zyx.shape, goal_zyx, occ_zyx.device)
    blocked = (occ_zyx > 0.5) & ~is_goal
    D = torch.where(is_goal, 0.0, BIG).to(torch.float32)
    N = occ_zyx.shape[0]
    active = torch.ones(N, dtype=torch.bool, device=occ_zyx.device)
    steps = torch.zeros(N, dtype=torch.int32, device=occ_zyx.device)
    i = 0
    while i < max_iters and bool(active.any()):
        D_new = D
        for _ in range(GROUP):
            D_new = _relax(D_new, blocked)
        changed = (D_new < D).flatten(1).any(-1)
        steps = steps + GROUP * active.to(torch.int32)
        # a converged agent's field is a fixed point: D_new == D there
        D = D_new
        active = active & changed
        i += GROUP
    return D, steps


def wavefront_batched_steps(occ_zyx, goal_zyx, max_iters: int = 512):
    """``wavefront_batched`` that also returns each agent's relaxation
    steps (N,) int32."""
    return wavefront_batched_plain(occ_zyx, goal_zyx, max_iters)


def wavefront_batched(occ_zyx, goal_zyx, max_iters: int = 512):
    """occ_zyx (N, Z, Y, X) f32 (1 = blocked), goal_zyx (N, 3) int (z, y,
    x) -> D (N, Z, Y, X) f32 with BIG as unreachable."""
    return wavefront_batched_steps(occ_zyx, goal_zyx, max_iters)[0]


def wavefront_distance(occ_xyz, goal_xyz, max_iters: int = 512):
    """The planner's (N, X, Y, Z) convention: occ_xyz bool, goal_xyz (N, 3)
    int (x, y, z) -> D (N, X, Y, Z) f32 with inf for unreachable cells."""
    occ_zyx = occ_xyz.permute(0, 3, 2, 1).to(torch.float32).contiguous()
    goal_zyx = goal_xyz.flip(-1).to(torch.int32)
    D = wavefront_batched(occ_zyx, goal_zyx, max_iters).permute(0, 3, 2, 1)
    return torch.where(D >= BIG * 0.5, float("inf"), D)
