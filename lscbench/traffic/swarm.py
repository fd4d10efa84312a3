"""The benchmark's one traffic generator: a swarm mission from a seed.

A traffic file (``traffic/<name>.json``) gives the parameters; this module
turns them and a seed into a mission as plain arrays, which
``cell.py`` hands to the program and to the reference alike.

- Start and goal points: random sequential adsorption in the world box
  inset by ``inset`` m (z pinned to ``z`` where the inset box is flat):
  uniform candidates, each kept when it lies farther than ``min_dist`` m
  from every point kept before it; all starts first, then all goals, from
  one numpy stream.  This is ``make_random_mission`` of the port's
  ``missions.py:339-370`` (and of the JAX package's), candidate for
  candidate and so point for point at the same seed, with the distance
  test vectorised instead of its O(N^2) Python loop.
- Tree columns (``trees`` > 0): full-height square columns of half-width
  ``tree_half`` m, centres uniform over the world inset by ``tree_inset``
  m, none within ``tree_clear`` m (horizontally) of a start or goal, drawn
  from a second stream of the same seed: ``chip_smoke.py:498-521``
  (``forest_mission``, from ``tests/test_torch_cuda.py``), likewise
  vectorised.
"""
from __future__ import annotations

import numpy as np

# candidates drawn at a time; any size gives the same points
_CHUNK = 256


def generate(params: dict, seed: int) -> dict:
    """The mission of traffic `params` at `seed`: a dict of numpy arrays
    (world (6,), start (N, 3), goal (N, 3), boxes (T, 6) as [min, max])."""
    world = np.asarray(params["world"], dtype=np.float64)
    n = int(params["agents"])
    inset = float(params.get("inset", 0.5))
    lo, hi = world[:3] + inset, world[3:] - inset
    z = float(params.get("z", 1.0))
    min_dist = float(params.get("min_dist", 0.7))
    starts, goals = _sample_pairs(np.random.default_rng(seed), lo, hi, z,
                                  n, min_dist)
    boxes = np.zeros((0, 6))
    trees = int(params.get("trees", 0))
    if trees:
        boxes = _trees(np.random.default_rng(seed), world, starts, goals,
                       trees, float(params["tree_half"]),
                       float(params.get("tree_inset", 0.15)),
                       float(params.get("tree_clear", 0.5)))
    return {"world": world, "start": starts, "goal": goals, "boxes": boxes}


def _sample_pairs(rng, lo, hi, z, n, min_dist):
    """make_random_mission's starts, then its goals, from one stream: the
    candidates are i.i.d. in stream order, so drawing them in chunks and
    continuing the goals from the first candidate after the last start
    reproduces the loop's points exactly."""
    flat = hi[2] - lo[2] < 1e-6
    out, pending = [], np.empty((0, 3))
    for _ in range(2):
        kept = np.empty((0, 3))
        trials = 0
        while len(kept) < n:
            if not len(pending):
                pending = rng.uniform(lo, hi, size=(_CHUNK, 3))
                if flat:
                    pending[:, 2] = z
            cand, pending = pending, np.empty((0, 3))
            d2 = ((cand[:, None, :] - kept[None, :, :]) ** 2).sum(-1)
            far = (d2 > min_dist * min_dist).all(1)
            near = ((cand[:, None, :] - cand[None, :, :]) ** 2).sum(-1) \
                <= min_dist * min_dist
            take, used = [], 0
            for i in range(len(cand)):
                used = i + 1
                trials += 1
                if trials > 100000:
                    raise RuntimeError("cannot place agents")
                if far[i] and not near[i, take].any():
                    take.append(i)
                    if len(kept) + len(take) == n:
                        break
            kept = np.concatenate([kept, cand[take]])
            pending = cand[used:]
        out.append(kept)
    return out[0], out[1]


def _trees(rng, world, starts, goals, count, half, inset, clear):
    """count tree columns (chip_smoke.py:498-521): centres uniform over
    the world's x-y inset by `inset`, each kept when farther than `clear`
    from every start and goal (horizontally); full height."""
    keep = np.concatenate([starts[:, :2], goals[:, :2]])
    lo, hi = world[:2] + inset, world[3:5] - inset
    centres = []
    while len(centres) < count:
        cand = rng.uniform(lo, hi, size=(_CHUNK, 2))
        ok = (np.linalg.norm(keep[None] - cand[:, None], axis=-1).min(1) >
              clear)
        centres.extend(cand[ok][:count - len(centres)])
    c = np.asarray(centres)
    zc, zh = 0.5 * (world[2] + world[5]), 0.5 * (world[5] - world[2])
    centre = np.concatenate([c, np.full((count, 1), zc)], axis=1)
    dims = np.array([half, half, zh])
    return np.concatenate([centre - dims, centre + dims], axis=1)
