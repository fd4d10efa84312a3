"""Safe Flight Corridor face expansion, with its plain version.

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
from . import _build

# launches of the kernel since the last reset (CUDA only; the plain version
# never counts)
expand_launches = 0
# the kernel's flat table indices are 32-bit
MAX_SAT_ENTRIES = 2 ** 31 - 1


def reset_counts() -> None:
    global expand_launches
    expand_launches = 0


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


# ----------------------------------------------------------------------
# CUDA kernel
# ----------------------------------------------------------------------
def _check(lo, hi, cand, seed_ok, sat, wmin32, wmin, wmax):
    """Shapes, dtypes and devices the kernel takes; raises otherwise."""
    N = lo.shape[0]
    want = dict(lo=(lo, (N, 3), (torch.int32,)),
                hi=(hi, (N, 3), (torch.int32,)),
                cand=(cand, (N, 6), (torch.int64,)),
                seed_ok=(seed_ok, (N,), (torch.bool,)),
                sat=(sat.sat, tuple(sat.sat.shape), (torch.int32,)),
                wmin32=(wmin32, (3,), (torch.float32,)),
                wmin=(wmin, (3,), (torch.float32, torch.float64)),
                wmax=(wmax, (3,), (wmin.dtype,)))
    for name, (t, shape, dtypes) in want.items():
        if tuple(t.shape) != shape or t.dtype not in dtypes:
            raise ValueError(f"expand_boxes: {name} {tuple(t.shape)} "
                             f"{t.dtype}, expected {shape} {dtypes}")
        if t.device != lo.device:
            raise ValueError(f"expand_boxes: {name} on {t.device}, lo on "
                             f"{lo.device}")
    if sat.sat.ndim != 3:
        raise ValueError(f"expand_boxes: the summed-area table is "
                         f"{tuple(sat.sat.shape)}, expected 3-D")
    if sat.sat.numel() > MAX_SAT_ENTRIES:
        raise ValueError(f"expand_boxes: the summed-area table "
                         f"{tuple(sat.sat.shape)} has {sat.sat.numel()} "
                         f"entries; the kernel takes at most "
                         f"{MAX_SAT_ENTRIES} (32-bit indices)")


def entry_args(lo, hi, cand, seed_ok, sat, wmin32, wmin, wmax):
    """One launch of the kernel: (the entry point's dtype suffix, its
    arguments before the stream, the outputs (lo_out, hi_out), the inputs
    the arguments point into), shared by the wrapper and the measurement
    builds (ops/_build.py::load_variant)."""
    ins = [t.contiguous() for t in (lo, hi, cand, seed_ok, sat.sat, wmin32,
                                    wmin, wmax)]
    N = lo.shape[0]
    lo_out = torch.empty_like(ins[0])
    hi_out = torch.empty_like(ins[1])
    S0, S1, S2 = sat.sat.shape
    k0 = [int(x) for x in sat.origin_key]
    sfx = "f32" if wmin.dtype == torch.float32 else "f64"
    args = [*[t.data_ptr() for t in ins[:5]], S0, S1, S2, *k0,
            *[t.data_ptr() for t in ins[5:]], float(sat.resolution),
            SP_EPSILON, SP_EPSILON_FLOAT, lo_out.data_ptr(),
            hi_out.data_ptr(), N]
    return sfx, args, (lo_out, hi_out), ins


def _expand_cuda(lo, hi, cand, seed_ok, sat, wmin32, wmin, wmax):
    global expand_launches
    lib = _build.load_library()
    sfx, args, out, _ins = entry_args(lo, hi, cand, seed_ok, sat, wmin32,
                                      wmin, wmax)
    err = _build.launch(getattr(lib, "lsc_expand_boxes_" + sfx), lo.device,
                        *args)
    if err:
        raise RuntimeError(f"expand_boxes kernel launch failed: CUDA error "
                           f"{err}")
    expand_launches += 1
    return out


def spec_k(lib=None) -> int:
    """The tries a round that a build of the kernel speculates (its
    LSC_CORRIDOR_K; the package's library when lib is None)."""
    return int((lib or _build.load_library()).lsc_expand_boxes_k())


# ----------------------------------------------------------------------
# wrapper
# ----------------------------------------------------------------------
def expand_boxes(lo, hi, cand, seed_ok, sat, wmin32, wmin, wmax):
    """Grow each seed lattice box (lo, hi) (N, 3) int32 (absolute voxel
    corners) through its face slots cand (N, 6) int64 (``CorridorBuilder.
    _axis_order``) against the margin table sat (an ``OccupancySAT``);
    seed_ok (N,) bool (an obstructed seed keeps its box); wmin32 (3,)
    float32 the world minimum for the at-minimum test; wmin, wmax (3,) the
    world bounds in the working dtype (float32 or float64) of the in-bounds
    test.  Returns the grown (lo, hi) (N, 3) int32."""
    args = (lo, hi, cand, seed_ok, sat, wmin32, wmin, wmax)
    _check(*args)
    if lo.device.type == "cpu":
        return expand_boxes_plain(*args)
    if lo.device.type == "cuda":
        return _expand_cuda(*args)
    raise RuntimeError(f"expand_boxes: no kernel for device {lo.device}")
