"""The closed form the wavefront kernel computes, held to the Jacobi loop.

csrc/wavefront.cu computes the wavefront field as a breadth-first search
by levels, not as the TPU kernel's Jacobi loop.  Its premise: after the
loop, a cell holds its 6-connected BFS distance from the goal through free
cells (the goal free even when occupied) where that distance is <= steps,
BIG elsewhere, and the loop ran

    steps = 0                                          if max_iters <= 0
    steps = min(8 ceil(L / 8) + 8, 8 ceil(max_iters / 8))   otherwise,

L the deepest BFS level (0 when only the goal is reached or the goal lies
outside the grid).  Here a plain queue BFS in numpy plus that formula is
held bit for bit, steps included, to wavefront_batched_plain (the kernel's
oracle on the card) and to the JAX TPU kernel in interpret mode.  Also the
kernel's shared-memory limit, which the wrapper checks before it builds or
launches anything.
"""
from collections import deque

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lsc_planner_tpu.ops.wavefront_pallas import wavefront_batched as jwave
from lsc_planner_tpu_torch.ops import wavefront
from torch_parity import torch_one_thread  # noqa: F401

_NBRS = ((0, 0, 1), (0, 0, -1), (0, 1, 0), (0, -1, 0), (1, 0, 0),
         (-1, 0, 0))


def bfs_closed_form(occ, goal, max_iters):
    """occ (N, Z, Y, X) f32 (1 = blocked), goal (N, 3) int (z, y, x) ->
    (field (N, Z, Y, X) f32, steps (N,) int32) by a queue BFS a grid."""
    N, Z, Y, X = occ.shape
    field = np.full(occ.shape, wavefront.BIG, np.float32)
    steps = np.zeros(N, np.int32)
    cap = 0 if max_iters <= 0 else 8 * -(-max_iters // 8)
    for a in range(N):
        dist = np.full((Z, Y, X), -1, np.int64)
        g = tuple(int(v) for v in goal[a])
        inside = all(0 <= v < s for v, s in zip(g, (Z, Y, X)))
        queue = deque()
        if inside:
            dist[g] = 0
            queue.append(g)
        while queue:
            z, y, x = queue.popleft()
            for dz, dy, dx in _NBRS:
                n = (z + dz, y + dy, x + dx)
                if all(0 <= v < s for v, s in zip(n, (Z, Y, X))) and \
                        dist[n] < 0 and not occ[a][n] > 0.5:
                    dist[n] = dist[z, y, x] + 1
                    queue.append(n)
        deepest = int(dist.max()) if inside else 0
        steps[a] = 0 if max_iters <= 0 else min(8 * -(-deepest // 8) + 8,
                                                cap)
        keep = (dist >= 0) & (dist <= steps[a])
        field[a][keep] = dist[keep]
    return field, steps


def grids(shape, seed, fill=0.25, outside=(0, 0, -1)):
    """Random occupancy; agent 0's goal cell occupied, agent 1's goal
    `outside` the grid (an offset from the grid's far corner where
    positive, the coordinate itself where negative)."""
    rng = np.random.default_rng(seed)
    N, Z, Y, X = shape
    occ = (rng.uniform(size=shape) < fill).astype(np.float32)
    goal = np.stack([rng.integers(0, Z, N), rng.integers(0, Y, N),
                     rng.integers(0, X, N)], -1).astype(np.int32)
    occ[0, goal[0, 0], goal[0, 1], goal[0, 2]] = 1.0
    goal[1] = [o if o < 0 else s - 1 + o
               for o, s in zip(outside, (Z, Y, X))]
    return occ, goal


@pytest.mark.parametrize("shape,max_iters,outside", [
    pytest.param((3, 3, 5, 9), 0, (0, 0, -1), id="cap0"),
    pytest.param((3, 3, 7, 11), 8, (1, 0, 0), id="cap8"),
    pytest.param((3, 3, 7, 11), 13, (0, -1, 0), id="cap13"),
    pytest.param((3, 4, 9, 13), 200, (0, 0, 1), id="converged"),
    pytest.param((3, 4, 6, 1), 50, (-1, 0, 0), id="x1"),
    pytest.param((3, 2, 3, 64), 100, (0, 1, 0), id="x64"),
    pytest.param((3, 2, 3, 70), 100, (0, 0, 1), id="x70-two-words-a-row"),
    pytest.param((3, 1, 9, 13), 40, (0, 0, -1), id="z1"),
])
def test_bfs_levels_equal_the_jacobi_loop(shape, max_iters, outside):
    occ, goal = grids(shape, seed=sum(shape) + max_iters, outside=outside)
    want, want_steps = bfs_closed_form(occ, goal, max_iters)
    plain, steps = wavefront.wavefront_batched_plain(
        torch.as_tensor(occ), torch.as_tensor(goal), max_iters)
    np.testing.assert_array_equal(plain.numpy(), want)
    np.testing.assert_array_equal(steps.numpy(), want_steps)
    jax_field = np.asarray(jwave(jnp.asarray(occ), jnp.asarray(goal),
                                 max_iters=max_iters, interpret=True))
    np.testing.assert_array_equal(jax_field, want)
    # the cases cover what they name: agent 0's occupied goal at 0, agent
    # 1's goal outside the grid and its field all BIG
    assert (want[1] == wavefront.BIG).all()
    assert want[0][tuple(goal[0])] == 0.0
    if max_iters <= 0:
        assert (want_steps == 0).all()


@pytest.mark.parametrize("shape,fits", [
    ((21, 121, 121), True),            # a 30 x 30 x 5 m world at 0.25 m
    ((11, 41, 41), True),              # forest20
    ((1, 3226, 64), True),             # 3 x 3228 words: the last that fit
    ((1, 3227, 64), False),            # 3 x 3229 words
    ((11, 61, 61), True),              # the old cap refused this grid
])
def test_shared_memory_limit(shape, fits):
    """The wrapper's limit is the kernel's own bytes: 24 a 64-cell row
    word (free bits, reached bits twice), halo rows included, against the
    232,448 B a block may use; a grid past it raises before any launch."""
    Z, Y, X = shape
    assert wavefront.smem_bytes(Z, Y, X) == \
        24 * (Z + 2) * (Y + 2) * -(-X // 64)
    assert (wavefront.smem_bytes(Z, Y, X) <= wavefront.MAX_SMEM_BYTES) == fits
    occ = torch.zeros((1, Z, Y, X))
    goal = torch.zeros((1, 3), dtype=torch.int32)
    if fits:
        wavefront._check(occ, goal)
    else:
        with pytest.raises(ValueError, match="shared memory"):
            wavefront._check(occ, goal)
