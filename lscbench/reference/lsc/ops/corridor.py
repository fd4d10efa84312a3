"""Safe Flight Corridor face expansion, plain PyTorch (frozen copy of the
port's ``ops/corridor.py`` plain version; never the kernel).

Port of the JAX package's per-agent ``lax.while_loop`` in
``world/corridor.py`` (``CorridorBuilder.expand_box``, vmapped by
``expand_boxes``); it is not a Pallas kernel.  On a CUDA tensor
``expand_boxes`` launches the hand-written kernel (``csrc/corridor.cu``:
a warp an agent, several tries speculated a round, all of a round's
table reads in flight at once) or raises; on a CPU tensor it runs
``expand_boxes_plain``, the whole swarm's boxes in one batched loop.  There
is no fallback from one to the other.

Semantics, shared by the kernel and the plain version bit for bit: from
the seed lattice box (lo, hi) each agent tries its six face slots ``cand``
round-robin, starting after slot 5; a try grows the slot's face by one
voxel when the swept slab is free in the margin summed-area table
(``OccupancySAT.box_obstructed``, with the at-world-minimum flag compared
in float32) and in bounds in the working dtype; a failed slot goes
inactive; an agent ends when no slot is active.  An agent whose seed box
is obstructed keeps its box.
"""
from __future__ import annotations

import torch

from ..config import SP_EPSILON, SP_EPSILON_FLOAT

# ----------------------------------------------------------------------
# plain version
# ----------------------------------------------------------------------
def at_world_min(lo, res, wmin32):
    """Does the box's low corner sit at the world minimum (within eps)?
    (corridor_constructor.hpp:104).  Compared in float32 whatever the
    working dtype, as the JAX package does."""
    return lo.to(torch.float32) * res <= wmin32 + SP_EPSILON_FLOAT


def try_expand(sat, lo, hi, axis6, wmin32, wmin, wmax):
    """One-voxel expansion of face axis6 (0-2 low faces, 3-5 high faces) of
    each box (N, 3), in bounds in wmin's dtype.  Returns (lo', hi', ok)."""
    res = sat.resolution
    ax = (axis6 % 3)[:, None]
    is_high = (axis6 >= 3)[:, None]
    one = (torch.arange(3, device=lo.device)[None, :] == ax).to(lo.dtype)
    lo_n = torch.where(is_high, lo, lo - one)
    hi_n = torch.where(is_high, hi + one, hi)
    # update slab: old face -> new face along ax, full elsewhere
    on_ax = one.bool()
    s_lo = torch.where(on_ax, torch.where(is_high, hi, lo_n), lo_n)
    s_hi = torch.where(on_ax, torch.where(is_high, hi_n, lo), hi_n)
    free = ~sat.box_obstructed(s_lo, s_hi, at_world_min(s_lo, res, wmin32))
    dtype = wmin.dtype
    inb = ((s_lo.to(dtype) * res > wmin - SP_EPSILON).all(-1) &
           (s_hi.to(dtype) * res < wmax + SP_EPSILON).all(-1))
    ok = free & inb
    return (torch.where(ok[:, None], lo_n, lo),
            torch.where(ok[:, None], hi_n, hi), ok)


def expand_boxes_plain(lo, hi, cand, seed_ok, sat, wmin32, wmin, wmax):
    """The batched round-robin: each agent's loop advances one step an
    iteration, and an agent whose faces are all blocked keeps its box (the
    JAX package's vmapped while_loop, whose finished lanes are frozen the
    same way).  Same arguments and returns as ``expand_boxes``."""
    N = lo.shape[0]
    dev = lo.device
    active = seed_ok[:, None].expand(N, 6).clone()
    p = torch.full((N,), 5, dtype=torch.int64, device=dev)
    offs = torch.arange(1, 7, device=dev)
    rows = torch.arange(N, device=dev)
    while bool(active.any()):
        going = active.any(-1)
        # next active slot strictly after p, cyclically
        slots = (p[:, None] + offs[None, :]) % 6
        first = torch.argmax(torch.gather(active, 1, slots).to(
            torch.uint8), dim=-1)
        p2 = slots[rows, first]
        lo2, hi2, ok = try_expand(sat, lo, hi, cand[rows, p2], wmin32,
                                  wmin, wmax)
        # a finished agent's box and state no longer change
        lo = torch.where(going[:, None], lo2, lo)
        hi = torch.where(going[:, None], hi2, hi)
        active[rows, p2] = torch.where(going, ok, active[rows, p2])
        p = torch.where(going, p2, p)
    return lo, hi


expand_boxes = expand_boxes_plain
