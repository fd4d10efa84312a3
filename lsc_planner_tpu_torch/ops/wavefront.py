"""Batched 6-connected wavefront distance fields, with their plain version.

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
cells hold BIG.  (The JAX package's CPU path, ``GridPlanner.wavefront``,
runs exactly ``max_wavefront_iters`` steps with inf for unreachable cells;
the two agree once the field has converged.)
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _build

BIG = 1e9
GROUP = 8                   # relaxation steps between convergence tests
# cells a grid may have: one block holds two f32 distance buffers and one
# occupancy byte a cell in the 232,448 B of shared memory it may use (the
# kernel checks the same bytes, csrc/wavefront.cu kMaxSmem)
MAX_CELLS = 232448 // 9

# launches of the kernel since the last reset (CUDA only; the plain version
# never counts)
wavefront_launches = 0


def reset_counts() -> None:
    global wavefront_launches
    wavefront_launches = 0


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


def _check(occ_zyx, goal_zyx):
    if occ_zyx.dtype != torch.float32 or occ_zyx.ndim != 4:
        raise TypeError(f"wavefront: occupancy must be (N, Z, Y, X) "
                        f"float32, got {tuple(occ_zyx.shape)} "
                        f"{occ_zyx.dtype}")
    N = occ_zyx.shape[0]
    if goal_zyx.shape != (N, 3) or goal_zyx.device != occ_zyx.device:
        raise ValueError(f"wavefront: goal {tuple(goal_zyx.shape)} on "
                         f"{goal_zyx.device} does not match occupancy "
                         f"{tuple(occ_zyx.shape)} on {occ_zyx.device}")
    cells = occ_zyx[0].numel()
    if cells > MAX_CELLS:
        raise NotImplementedError(
            f"wavefront kernel: a {tuple(occ_zyx.shape[1:])} grid of "
            f"{cells} cells does not fit one block's shared memory (at most "
            f"{MAX_CELLS} cells; ROADMAP queue 1, item 11: grids over a "
            "cluster)")


def _wavefront_cuda(occ_zyx, goal_zyx, max_iters):
    global wavefront_launches
    lib = _build.load_library()
    _check(occ_zyx, goal_zyx)
    occ = occ_zyx.contiguous()
    goal = goal_zyx.to(torch.int32).contiguous()
    N, Z, Y, X = occ.shape
    out = torch.empty_like(occ)
    steps = torch.empty(N, dtype=torch.int32, device=occ.device)
    with torch.cuda.device(occ.device):
        stream = torch.cuda.current_stream(occ.device).cuda_stream
        err = lib.lsc_wavefront_f32(occ.data_ptr(), goal.data_ptr(),
                                    out.data_ptr(), steps.data_ptr(), N, Z,
                                    Y, X, int(max_iters), stream)
    if err:
        raise RuntimeError(f"wavefront kernel launch failed: CUDA error "
                           f"{err}")
    wavefront_launches += 1
    return out, steps


def wavefront_batched_steps(occ_zyx, goal_zyx, max_iters: int = 512):
    """``wavefront_batched`` that also returns each agent's relaxation
    steps (N,) int32."""
    if occ_zyx.device.type == "cpu":
        return wavefront_batched_plain(occ_zyx, goal_zyx, max_iters)
    if occ_zyx.device.type == "cuda":
        return _wavefront_cuda(occ_zyx, goal_zyx, max_iters)
    raise RuntimeError(f"wavefront: no kernel for device {occ_zyx.device}")


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
