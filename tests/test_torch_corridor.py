"""The face-expansion kernel's design (csrc/corridor.cu), modelled in numpy
on the CPU, against the port's plain version.

The kernel speculates K tries a round and reads every table entry of a
round at once, with no branch between the loads: a term dropped at the
world minimum, or whose cell box is empty, reads its clamped corners and
carries a zero sign, and the counts are summed in int32 with wrap-around.
These tests model both parts as the kernel computes them and hold them to
OccupancySAT.box_obstructed and ops/corridor.py::expand_boxes_plain (which
the card tests hold the kernel to, bit for bit).
"""
import numpy as np
import pytest
import torch

from lsc_planner_tpu_torch.config import SP_EPSILON, SP_EPSILON_FLOAT
from lsc_planner_tpu_torch.ops import corridor as corridor_ops
from test_torch_cuda import corridor_args
from torch_parity import torch_one_thread  # noqa: F401

CASES = ["random", "empty", "boxed_in", "world_min", "forest20"]
# term m fixes the axes of its set bits to the excluded plane; corner c
# takes the high clamp on the axes of its set bits
BITS = np.array([[(m >> k) & 1 for k in range(3)] for m in range(8)], bool)
ODD = np.array([bin(m).count("1") & 1 for m in range(8)], bool)


def branch_free_total(sat, s_lo, s_hi, at_min):
    """The kernel's obstruction count of one slab (absolute lattice corners
    s_lo, s_hi (3,), at_min (3,) bool): all eight terms' eight corners read
    at clamped addresses (flat int32 indices), each term's sign zero when
    it is dropped at the world minimum or its cell box is empty, the signed
    reads summed in uint32 with wrap-around and read back as int32.
    Returns (total, the 64 flat indices)."""
    table = sat.sat.reshape(-1).numpy()
    S = sat.sat.shape
    dims = np.array(S) - 1
    l = s_lo - sat.origin_key
    h = s_hi - sat.origin_key
    t_lo = np.where(BITS, l, l - 1 + at_min)                # (8 terms, 3)
    t_hi = np.where(BITS, l, h)
    lc = np.clip(t_lo, 0, dims)
    hc = np.clip(t_hi + 1, 0, dims)
    dropped = (BITS & at_min).any(-1)
    empty = (hc <= lc).any(-1)
    sign = np.where(dropped | empty, 0, np.where(ODD, -1, 1))
    corner = np.where(BITS[None, :, :], hc[:, None, :], lc[:, None, :])
    idx = ((corner[..., 0] * S[1] + corner[..., 1]) * S[2] +
           corner[..., 2]).astype(np.int32)                  # (8, 8)
    v = table[idx].astype(np.uint32)
    csign = np.where(ODD, 1, -1).astype(np.uint32)          # corner signs
    per_term = (v * csign[None, :]).sum(-1, dtype=np.uint32)
    total = (per_term * sign.astype(np.uint32)).sum(dtype=np.uint32)
    return int(np.array(total, np.uint32).view(np.int32)), idx


def try_ok(sat, box_lo, box_hi, face, bounds):
    """One try as the kernel computes it: the slab of face `face` of the
    box, its bound tests in the working dtype, its branch-free count."""
    dt, res, at_thr, lo_thr, hi_thr = bounds
    ax, high = face % 3, face >= 3
    one = np.arange(3) == ax
    lo_n = np.where(one & (not high), box_lo - 1, box_lo)
    hi_n = np.where(one & high, box_hi + 1, box_hi)
    s_lo = np.where(one, box_hi if high else lo_n, lo_n)
    s_hi = np.where(one, hi_n if high else box_lo, hi_n)
    at_min = s_lo.astype(np.float32) * np.float32(res) <= at_thr
    inb = bool((s_lo.astype(dt) * dt(res) > lo_thr).all() and
               (s_hi.astype(dt) * dt(res) < hi_thr).all())
    return inb and branch_free_total(sat, s_lo, s_hi, at_min)[0] <= 0


def grow(box_lo, box_hi, face):
    ax = face % 3
    box_lo, box_hi = box_lo.copy(), box_hi.copy()
    if face >= 3:
        box_hi[ax] += 1
    else:
        box_lo[ax] -= 1
    return box_lo, box_hi


def speculated_expand(args, K):
    """The kernel's rounds, agent by agent: the K tries of a round cut
    from the boxes that the tries before them leave if they all succeed
    (the active slots in cyclic order after the last slot tried), all K
    tested, then committed up to and including the first failure."""
    lo, hi, cand, seed_ok, sat, wmin32, wmin, wmax = args
    dt = np.float32 if wmin.dtype == torch.float32 else np.float64
    res = sat.resolution
    bounds = (dt, res,
              wmin32.numpy() + np.float32(SP_EPSILON_FLOAT),
              wmin.numpy() - dt(SP_EPSILON), wmax.numpy() + dt(SP_EPSILON))
    out_lo, out_hi = lo.numpy().copy(), hi.numpy().copy()
    for i in range(lo.shape[0]):
        b_lo, b_hi = out_lo[i].astype(np.int64), out_hi[i].astype(np.int64)
        faces = cand[i].tolist()
        active, p = (0x3F if bool(seed_ok[i]) else 0), 5
        while active:
            order = sorted((s for s in range(6) if active >> s & 1),
                           key=lambda s: (s - p - 1) % 6)
            slots = [order[j % len(order)] for j in range(K)]
            ok, t_lo, t_hi = [], b_lo, b_hi
            for s in slots:
                ok.append(try_ok(sat, t_lo, t_hi, faces[s], bounds))
                t_lo, t_hi = grow(t_lo, t_hi, faces[s])
            f = ok.index(False) if False in ok else K
            for s in slots[:f]:
                b_lo, b_hi = grow(b_lo, b_hi, faces[s])
            if f < K:
                active &= ~(1 << slots[f])
                p = slots[f]
            else:
                p = slots[K - 1]
        out_lo[i], out_hi[i] = b_lo, b_hi
    return out_lo, out_hi


@pytest.mark.parametrize("case", ["forest20", "boxed_in", "world_min"])
def test_branch_free_try_matches_box_obstructed(case):
    """The branch-free count equals OccupancySAT.box_obstructed on random
    slabs around and beyond the table's grid: slabs on the world minimum
    (terms dropped), slabs wholly outside the grid (every term empty) and
    thin ones; every read lands inside the table."""
    sat = corridor_args(case, torch.float64, "cpu")[3][4]
    rng = np.random.default_rng(5)
    k0 = sat.origin_key
    dims = np.array(sat.sat.shape) - 1
    n = 400
    lo = rng.integers(k0 - 4, k0 + dims + 4, size=(n, 3))
    hi = lo + rng.integers(0, 5, size=(n, 3))
    lo[:40] = k0 + dims + rng.integers(1, 3, size=(40, 3))    # past the grid
    hi[:40] = lo[:40] + 1
    at_min = rng.uniform(size=(n, 3)) < 0.3
    want = sat.box_obstructed(torch.as_tensor(lo), torch.as_tensor(hi),
                              torch.as_tensor(at_min)).numpy()
    got, reads = [], []
    for a, b, m in zip(lo, hi, at_min):
        total, idx = branch_free_total(sat, a, b, m)
        assert total >= 0
        got.append(total > 0)
        reads.append(idx)
    reads = np.stack(reads)
    assert reads.min() >= 0 and reads.max() < sat.sat.numel()
    np.testing.assert_array_equal(np.array(got), want)
    assert want.any() and not want.all()
    assert not np.array(got)[:40].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", CASES)
def test_speculated_rounds_match_plain(case, dtype):
    """The K-try speculation, committed through the first failure, gives
    expand_boxes_plain's boxes bit for bit at K = 1, 4, 6 and 8."""
    args = corridor_args(case, dtype, "cpu")[3]
    want = [t.numpy() for t in corridor_ops.expand_boxes_plain(*args)]
    for k in (1, 4, 6, 8):
        got = speculated_expand(args, k)
        np.testing.assert_array_equal(got[0], want[0], err_msg=f"K={k}")
        np.testing.assert_array_equal(got[1], want[1], err_msg=f"K={k}")


def test_wrapper_refuses_a_table_past_32_bit_indices():
    """A table of 2^31 entries or more raises ValueError in the shape check
    (an expanded view: nothing of that size is allocated)."""
    args = list(corridor_args("empty", torch.float32, "cpu")[3])
    sat = args[4]
    big = torch.zeros(1, dtype=torch.int32).expand(2048, 1024, 1024)
    args[4] = type(sat)(sat=big, origin_key=sat.origin_key,
                        resolution=sat.resolution, margin=sat.margin)
    with pytest.raises(ValueError, match="32-bit"):
        corridor_ops.expand_boxes(*args)
    args[4] = type(sat)(sat=big[:, :, :1023], origin_key=sat.origin_key,
                        resolution=sat.resolution, margin=sat.margin)
    assert args[4].sat.numel() < 2 ** 31
    corridor_ops._check(*args)
