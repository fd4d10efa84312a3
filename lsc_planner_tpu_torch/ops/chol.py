"""Batched Cholesky factor + solve for the IPM, with their plain versions.

Port of the JAX package's TPU kernels behind ``chol_factor_solve``,
``chol_resolve`` and ``cholesky_batched`` (the note in ``csrc/chol.cu``
names them).  On a CUDA tensor each wrapper launches its hand-written
kernel (``csrc/chol.cu``, which includes ``csrc/chol_cluster.cuh``) or
raises; on a CPU tensor it runs the plain PyTorch version below.  There
is no fallback from one to the other.

Semantics: lower Cholesky without a pivot floor, forward then backward
substitution; a non-SPD instance yields NaN in its own batch entry only.
The factor is a plain row-major ``(..., n, n)`` lower triangle, so it can
be handed to either version of ``chol_resolve``.  ``cholesky_batched``
returns the factor alone (zeros above the diagonal, a non-SPD entry's
lower triangle all NaN); as in the JAX package, nothing on the main path
calls it.

Up to ``WARP_MAX_N`` = 64 each kernel runs one warp a matrix (the IPM's
n = 39).  Above it, up to ``MAX_N`` (the slack-relaxed QP's n = nv + C M:
359 at 64 agents, 525 at 96), one thread-block cluster a matrix with the
factor in the cluster's shared memory where ``large_plan`` finds a
cluster of one or two blocks that holds it (f32 up to n = 384, f64 up to
256), and the tiled design past that (``csrc/chol_tiled.cuh``): one
persistent launch of the factor for the whole batch, 64 x 64 tiles of L
in device memory taken as tasks in the order ``tiled_tasks`` mirrors,
then a warp-specialised solve, one block a matrix.  The choice is by
shape alone; either design is a kernel, and a kernel that cannot build or
launch raises.
"""
from __future__ import annotations

import functools

import torch

from . import _build

WARP_MAX_N = 64        # the one-warp kernels' range
MAX_N = 4096           # the large-n kernels' cap (chol_tiled.cuh, kMaxN)
CLUSTER_MAX_N = 1024   # the cluster kernels' (chol_cluster.cuh, kMaxNt)
TILE = 32              # the cluster kernels' tile edge
TILED_TILE = 64        # the tiled design's tile edge (chol_tiled.cuh, kT)
SMEM_CAP = 232448      # shared-memory bytes a block of an H100 can have
# the cluster sizes the plan takes (csrc/chol_cluster.cuh, kMaxG): at the
# slack QP's B = 64, clusters of 4 or 8 blocks a matrix need two or four
# waves of blocks on an H100's 132 SMs, and ran slower than the one-block
# kernels (PERF.md §6: scripts/kernel_bits_torch.py designs)
CLUSTER_SIZES = (1, 2)
_HDR = 16 + 4 * (2 * 32 + 32 * CLUSTER_SIZES[-1])   # bytes before a
# cluster block's entries: a flag, the solve's flags

# launches of each kernel since the last reset (CUDA only; the plain
# versions never count): the one-warp kernels (n <= WARP_MAX_N), the
# cluster ones (*_cluster) and the tiled ones (*_tiled)
factor_solve_launches = 0
resolve_launches = 0
factor_launches = 0
factor_solve_cluster_launches = 0
resolve_cluster_launches = 0
factor_cluster_launches = 0
factor_solve_tiled_launches = 0
resolve_tiled_launches = 0
factor_tiled_launches = 0


def reset_counts() -> None:
    global factor_solve_launches, resolve_launches, factor_launches
    global factor_solve_cluster_launches, resolve_cluster_launches
    global factor_cluster_launches
    global factor_solve_tiled_launches, resolve_tiled_launches
    global factor_tiled_launches
    factor_solve_launches = 0
    resolve_launches = 0
    factor_launches = 0
    factor_solve_cluster_launches = 0
    resolve_cluster_launches = 0
    factor_cluster_launches = 0
    factor_solve_tiled_launches = 0
    resolve_tiled_launches = 0
    factor_tiled_launches = 0


def cluster_cuts(n: int, G: int) -> list:
    """The tile rows of each block of a cluster of G at n (csrc/
    chol_cluster.cuh, Geo): block r holds rows cuts[r] .. cuts[r+1] - 1,
    cut where the tiles before reach r / G of the lower triangle's."""
    nt = -(-n // TILE)
    cuts = [0]
    for r in range(1, G):
        a = cuts[-1]
        while a < nt and a * (a + 1) * G < r * nt * (nt + 1):
            a += 1
        cuts.append(a)
    return cuts + [nt]


def cluster_tiles(n: int, G: int, rank: int) -> tuple:
    """Block `rank`'s tiles in a cluster of G at n, as Geo numbers them (in
    tiles after the reciprocals, the buffer and the partials): ({(a, c):
    index} of its own tiles, rows cluster_cuts' range, row a holding (a,
    0..a); {c: index} of its slots, one for each earlier block's tile row
    c >= 1 (a panel tile of row c is read only by the blocks after c's),
    after them)."""
    cuts = cluster_cuts(n, G)
    lo, hi = cuts[rank], cuts[rank + 1]
    own = {(a, c): (a * (a + 1) - lo * (lo + 1)) // 2 + c
           for a in range(lo, hi) for c in range(a + 1)}
    return own, {c: len(own) + c - 1 for c in range(1, lo)}


def cluster_smem_bytes(n: int, G: int, elem: int, rank: int,
                       slots: bool = True) -> int:
    """Shared-memory bytes of block `rank` of a cluster of G at n
    (Geo::smem_bytes): the flags, the diagonal's reciprocals (nt 32), a
    tile-sized buffer, the solve's partials (32 for each of the largest
    block's tile rows and each block), the block's tiles and, for the
    factor (slots), its slots (cluster_tiles)."""
    nt = -(-n // TILE)
    cuts = cluster_cuts(n, G)
    rows = max(b - a for a, b in zip(cuts, cuts[1:]))
    own, slot = cluster_tiles(n, G, rank)
    tiles = len(own) + (len(slot) if slots else 0)
    return _HDR + (nt * TILE + TILE * TILE + rows * G * TILE +
                   tiles * TILE * TILE) * elem


@functools.lru_cache(maxsize=None)
def large_plan(n: int, dtype) -> tuple | None:
    """(G, shared-memory bytes a block) of the cluster design at n > 64:
    the smallest cluster of CLUSTER_SIZES whose largest block holds its
    tiles and buffers in SMEM_CAP; None where none does (f32 past n =
    384, f64 past 256: the tiled design runs) or n is outside
    WARP_MAX_N < n <= CLUSTER_MAX_N.  Mirrors csrc/chol.cu::cluster_plan;
    cached (the wrappers ask at every call, 120 a slack-QP cycle)."""
    if not WARP_MAX_N < n <= CLUSTER_MAX_N:
        return None
    elem = torch.empty((), dtype=dtype).element_size()
    for G in CLUSTER_SIZES:
        smem = max(cluster_smem_bytes(n, G, elem, r) for r in range(G))
        if smem <= SMEM_CAP:
            return G, smem
    return None


def large_design(n: int, dtype) -> str | None:
    """The kernel that runs at n: None (one warp a matrix, n <= 64),
    "cluster" (large_plan has a plan) or "tiled"."""
    if n <= WARP_MAX_N:
        return None
    return "cluster" if large_plan(n, dtype) is not None else "tiled"


def tiled_tasks(n: int, tile: int = TILED_TILE) -> list:
    """The tiled factor's tasks for one matrix, in the order the kernel
    takes them (csrc/chol_tiled.cuh, task_of): [(i, j, ks)], tile (i, j)
    of the lower triangle, with ks its k-tiles in the order its sum H_ij
    - sum_k L_ik L_jk^T runs.  The order: (0, 0), then tile column by
    tile column, column j's (j + 1, j), then the next diagonal tile (j +
    1, j + 1), then (j + 2, j) .. .  Tile (i, j) reads tiles (i, k) and
    (j, k) for k in ks and, for i > j, (j, j).  Over a batch of B the
    kernel takes task p of this list for entries 0 .. B - 1 before task p
    + 1 (tiled_task)."""
    return [(i, j, list(range(j))) for i, j in _tile_order(n, tile)]


@functools.lru_cache(maxsize=None)
def _tile_order(n, tile):
    nt = -(-n // tile)
    order = [(0, 0)]
    for j in range(nt - 1):
        order += [(j + 1, j), (j + 1, j + 1)]
        order += [(i, j) for i in range(j + 2, nt)]
    return tuple(order)


def tiled_task(t: int, n: int, B: int, tile: int = TILED_TILE) -> tuple:
    """(entry, tile row, tile column) of task t of the tiled factor on B
    matrices (csrc/chol_tiled.cuh, task_of): tiled_tasks' task t // B for
    entry t % B, then each entry's last task (b, -1, -1), which fills
    the entry's lower triangle with NaN when a pivot failed."""
    tiles = _tile_order(n, tile)
    if t >= B * len(tiles):
        return t - B * len(tiles), -1, -1
    i, j = tiles[t // B]
    return t % B, i, j


def tiled_work_ints(n: int, B: int, tile: int = TILED_TILE) -> int:
    """Ints of the tiled factor's workspace (chol_tiled.cuh, work_ints):
    the task counter, a failed flag an entry, a flag a tile an entry."""
    nt = -(-n // tile)
    return 1 + B * (1 + nt * (nt + 1) // 2)


# ----------------------------------------------------------------------
# plain versions
# ----------------------------------------------------------------------
def _solve_plain(L, rhs):
    z = torch.linalg.solve_triangular(L, rhs.unsqueeze(-1), upper=False)
    x = torch.linalg.solve_triangular(L.mT, z, upper=True)
    return x.squeeze(-1)


def cholesky_batched_plain(H):
    """Lower factor of H (..., n, n): cholesky_ex with each failed entry's
    lower triangle NaN, zeros above the diagonal (jnp.linalg.cholesky's
    NaN on a non-SPD input, chol_pallas.py:13-14).  torch.linalg.cholesky
    raises on a non-PD matrix; cholesky_ex + the NaN fill keeps the JAX
    behaviour, and zeros above the diagonal keep the kernels' layout."""
    L, info = torch.linalg.cholesky_ex(H)
    L = torch.where((info > 0)[..., None, None],
                    torch.full_like(L, float("nan")), L)
    return torch.tril(L)


def chol_factor_solve_plain(H, rhs):
    """(cholesky_batched_plain(H), the solve of H x = rhs with it)."""
    L = cholesky_batched_plain(H)
    return L, _solve_plain(L, rhs)


def chol_resolve_plain(L, rhs):
    return _solve_plain(L, rhs)


# ----------------------------------------------------------------------
# CUDA kernels
# ----------------------------------------------------------------------
def _check(mat, rhs, what):
    """(mat as (B, n, n), rhs as (B, n) or None, the batch shape or None
    when no reshape was needed, n); raises on what the kernels do not
    take.  rhs None: the factor alone."""
    if mat.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{what}: dtype {mat.dtype} not supported "
                        "(float32 or float64)")
    n = mat.shape[-1]
    if mat.ndim < 2 or mat.shape[-2] != n:
        raise ValueError(f"{what}: expected (..., n, n), got "
                         f"{tuple(mat.shape)}")
    if rhs is not None and (rhs.shape != mat.shape[:-1] or
                            rhs.dtype != mat.dtype or
                            rhs.device != mat.device):
        raise ValueError(f"{what}: rhs {tuple(rhs.shape)} {rhs.dtype} "
                         f"{rhs.device} does not match {tuple(mat.shape)} "
                         f"{mat.dtype} {mat.device}")
    if not 1 <= n <= MAX_N:
        raise ValueError(f"{what}: n = {n} outside the kernels' range "
                         f"1..{MAX_N} (MAX_N)")
    if mat.dim() == 3 and mat.is_contiguous() and \
            (rhs is None or rhs.is_contiguous()):
        # the IPM's call, 120 times a cycle: no reshapes (batch None)
        return mat, rhs, None, n
    batch = mat.shape[:-2]
    return (mat.reshape(-1, n, n).contiguous(),
            None if rhs is None else rhs.reshape(-1, n).contiguous(),
            batch, n)


def _unbatch(t, batch, *tail):
    return t if batch is None else t.reshape(*batch, *tail)


def _suffix(dtype):
    return "f32" if dtype == torch.float32 else "f64"


_COUNTER_SUFFIX = {None: "", "cluster": "_cluster", "tiled": "_tiled"}


def _count(kind, ran):
    """Adds a launch of `kind` ("factor_solve", "resolve", "factor") of
    the kernel `ran` (large_design's answer) to its counter."""
    globals()[f"{kind}{_COUNTER_SUFFIX[ran]}_launches"] += 1


def _work(ran, n, B, device):
    """The tiled factor's workspace (the launch zeroes it), None for the
    other designs."""
    if ran != "tiled":
        return None
    return torch.empty(tiled_work_ints(n, B), dtype=torch.int32,
                       device=device)


def _factor_solve_cuda(H, rhs):
    lib = _build.load_library()
    H3, r2, batch, n = _check(H, rhs, "chol_factor_solve")
    ran = large_design(n, H.dtype)
    B = H3.shape[0]
    L = torch.empty_like(H3)
    x = torch.empty_like(r2)
    work = _work(ran, n, B, H.device)
    err = _build.launch(
        getattr(lib, "lsc_chol_factor_solve_" + _suffix(H.dtype)), H.device,
        H3.data_ptr(), r2.data_ptr(), L.data_ptr(), x.data_ptr(),
        None if work is None else work.data_ptr(), B, n)
    if err:
        raise RuntimeError(f"chol_factor_solve kernel launch failed: CUDA "
                           f"error {err}")
    _count("factor_solve", ran)
    return _unbatch(L, batch, n, n), _unbatch(x, batch, n)


def _factor_cuda(H):
    lib = _build.load_library()
    H3, _, batch, n = _check(H, None, "cholesky_batched")
    ran = large_design(n, H.dtype)
    B = H3.shape[0]
    L = torch.empty_like(H3)
    work = _work(ran, n, B, H.device)
    err = _build.launch(getattr(lib, "lsc_chol_factor_" + _suffix(H.dtype)),
                        H.device, H3.data_ptr(), L.data_ptr(),
                        None if work is None else work.data_ptr(), B, n)
    if err:
        raise RuntimeError(f"cholesky_batched kernel launch failed: CUDA "
                           f"error {err}")
    _count("factor", ran)
    return _unbatch(L, batch, n, n)


def _resolve_cuda(L, rhs):
    lib = _build.load_library()
    L3, r2, batch, n = _check(L, rhs, "chol_resolve")
    ran = large_design(n, L.dtype)
    B = L3.shape[0]
    x = torch.empty_like(r2)
    err = _build.launch(
        getattr(lib, "lsc_chol_resolve_" + _suffix(L.dtype)), L.device,
        L3.data_ptr(), r2.data_ptr(), x.data_ptr(), B, n)
    if err:
        raise RuntimeError(f"chol_resolve kernel launch failed: CUDA "
                           f"error {err}")
    _count("resolve", ran)
    return _unbatch(x, batch, n)


# ----------------------------------------------------------------------
# wrappers
# ----------------------------------------------------------------------
def chol_factor_solve(H, rhs):
    """Factor H (..., n, n) and solve H x = rhs (..., n).  Returns (L, x)
    with L the row-major lower factor for `chol_resolve`."""
    if H.device.type == "cpu":
        return chol_factor_solve_plain(H, rhs)
    if H.device.type == "cuda":
        return _factor_solve_cuda(H, rhs)
    raise RuntimeError(f"chol_factor_solve: no kernel for device {H.device}")


def chol_resolve(L, rhs):
    """Solve (L L^T) x = rhs with a factor from `chol_factor_solve`."""
    if L.device.type == "cpu":
        return chol_resolve_plain(L, rhs)
    if L.device.type == "cuda":
        return _resolve_cuda(L, rhs)
    raise RuntimeError(f"chol_resolve: no kernel for device {L.device}")


def cholesky_batched(H):
    """Lower Cholesky factor of H (..., n, n), zeros above the diagonal;
    a non-SPD entry comes back with its lower triangle NaN."""
    if H.device.type == "cpu":
        return cholesky_batched_plain(H)
    if H.device.type == "cuda":
        return _factor_cuda(H)
    raise RuntimeError(f"cholesky_batched: no kernel for device {H.device}")
