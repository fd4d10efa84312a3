"""Linear Safe Corridor plane generation, with its plain version.

It replaces no Pallas kernel: the JAX package leaves
``planner/constraints.py::lsc_planes`` to XLA.  On a CUDA tensor
``lsc_planes`` launches the hand-written kernel (``csrc/planes.cu``: one
thread a hull, the closest-point enumeration of ``ops/hull.py`` and the
planes' margins in registers) or raises; on a CPU tensor it runs
``lsc_planes_plain``, the batched PyTorch program.  There is no fallback
from one to the other.  A hull of more than ``MAX_POINTS`` control points
takes ``ops/hull.py``'s FISTA branch, another algorithm, and runs the
plain version on any device.

The kernel computes the plain version's function bit for bit on the card:
every product, sum, quotient and square root is rounded where and as
aten rounds it there (the note in ``csrc/planes.cu``).
"""
from __future__ import annotations

import torch

from .. import trace
from ..planner.optimizer import PlaneConstraints
from . import _build
from . import hull as hull_ops

# launches of the kernel since the last reset (CUDA only; the plain version
# never counts)
lsc_planes_launches = 0
# the enumeration's largest hull (ops/hull.py::closest_point_to_hull)
MAX_POINTS = 8


def reset_counts() -> None:
    global lsc_planes_launches
    lsc_planes_launches = 0


def pair_downwash(agent_radius, agent_downwash, obs_radius, obs_downwash,
                  obs_is_agent):
    """Combined downwash (traj_planner.cpp:1336-1345): agents mix both
    coefficients; non-agents use 1.0 for the ego agent."""
    dw_agent = ((agent_downwash * agent_radius + obs_downwash * obs_radius)
                / (agent_radius + obs_radius))
    dw_other = ((agent_radius + obs_downwash * obs_radius)
                / (agent_radius + obs_radius))
    return torch.where(obs_is_agent, dw_agent, dw_other)


# ----------------------------------------------------------------------
# plain version
# ----------------------------------------------------------------------
def lsc_planes_plain(init_traj, obs_pred, agent_radius, agent_downwash,
                     obs_radius, obs_downwash, obs_is_agent, obs_mask,
                     slack_flags=None, obs_pred_sizes=None,
                     guard_margin: float = 0.0) -> PlaneConstraints:
    """The batched PyTorch program; same arguments and result as
    ``lsc_planes``."""
    N, O, M = obs_pred.shape[:3]

    dw = pair_downwash(agent_radius[:, None], agent_downwash[:, None],
                       obs_radius, obs_downwash, obs_is_agent)   # (N, O)
    scale = torch.stack([torch.ones_like(dw), torch.ones_like(dw),
                         1.0 / dw], dim=-1)                       # (N, O, 3)
    init_t = init_traj[:, None] * scale[:, :, None, None, :]
    obs_t = obs_pred * scale[:, :, None, None, :]

    rel = init_t - obs_t                                  # (N, O, M, n1, 3)
    normal_t, _ = hull_ops.hull_normal(rel)               # (N, O, M, 3)

    collision_dist = agent_radius[:, None] + obs_radius   # (N, O)
    e = (rel * normal_t[..., None, :]).sum(-1)            # rel_i . n_t
    d = 0.5 * (collision_dist[..., None, None] + e)
    if guard_margin > 0.0:
        s0 = 0.5 * (e - collision_dist[..., None, None])
        d = d + torch.clamp(0.5 * s0, 0.0, guard_margin)
    if slack_flags is not None and obs_pred_sizes is not None:
        use_rsfc = slack_flags & ~obs_is_agent
        d_rsfc = obs_pred_sizes + agent_radius[:, None, None, None]
        d = torch.where(use_rsfc[..., None, None], d_rsfc, d)

    # untransform the normal (z divided by downwash, traj_planner.cpp:1403)
    normal = torch.cat([normal_t[..., :2],
                        normal_t[..., 2:3] / dw[..., None, None]], dim=-1)
    rhs = d + (obs_pred * normal[..., None, :]).sum(-1)
    mask = obs_mask[..., None].expand(N, O, M)
    return PlaneConstraints(normal=normal, rhs=rhs, mask=mask)


# ----------------------------------------------------------------------
# CUDA kernel
# ----------------------------------------------------------------------
def _broadcasts(have, want) -> bool:
    """Does a tensor of shape `have` broadcast to `want`?  (In plain
    Python: torch.broadcast_shapes imports sympy on its first call, some
    seconds of a process's first cycle.)"""
    return len(have) <= len(want) and all(
        h in (1, w) for h, w in zip(reversed(have), reversed(want)))


def _check(init_traj, obs_pred, agent_radius, agent_downwash, obs_radius,
           obs_downwash, obs_is_agent, obs_mask, slack_flags,
           obs_pred_sizes):
    """Shapes, dtypes and devices the kernel takes; raises otherwise.
    Each argument may be a view that broadcasts to its shape."""
    N, O, M, n1 = obs_pred.shape[:4]
    dt = obs_pred.dtype
    if dt not in (torch.float32, torch.float64):
        raise ValueError(f"lsc_planes: dtype {dt}; the kernel takes float32 "
                         "or float64")
    want = dict(init_traj=(init_traj, (N, M, n1, 3), dt),
                obs_pred=(obs_pred, (N, O, M, n1, 3), dt),
                agent_radius=(agent_radius, (N,), dt),
                agent_downwash=(agent_downwash, (N,), dt),
                obs_radius=(obs_radius, (N, O), dt),
                obs_downwash=(obs_downwash, (N, O), dt),
                obs_is_agent=(obs_is_agent, (N, O), torch.bool),
                obs_mask=(obs_mask, (N, O), torch.bool))
    if slack_flags is not None and obs_pred_sizes is not None:
        want.update(slack_flags=(slack_flags, (N, O), torch.bool),
                    obs_pred_sizes=(obs_pred_sizes, (N, O, M, n1), dt))
    for name, (t, shape, dtype) in want.items():
        if t.dtype != dtype or not _broadcasts(tuple(t.shape), shape):
            raise ValueError(f"lsc_planes: {name} {tuple(t.shape)} "
                             f"{t.dtype}, expected {shape} {dtype}")
        if t.device != obs_pred.device:
            raise ValueError(f"lsc_planes: {name} on {t.device}, obs_pred "
                             f"on {obs_pred.device}")


def _lsc_planes_cuda(init_traj, obs_pred, agent_radius, agent_downwash,
                     obs_radius, obs_downwash, obs_is_agent, obs_mask,
                     slack_flags, obs_pred_sizes, guard_margin):
    global lsc_planes_launches
    N, O, M, n1 = obs_pred.shape[:4]
    lib = _build.load_library()
    shapes = [(N, M, n1, 3), (N, O, M, n1, 3), (N,), (N,), (N, O), (N, O),
              (N, O)]
    ts = [init_traj, obs_pred, agent_radius, agent_downwash, obs_radius,
          obs_downwash, obs_is_agent]
    if slack_flags is not None and obs_pred_sizes is not None:
        shapes += [(N, O), (N, O, M, n1)]
        ts += [slack_flags, obs_pred_sizes]
    ins = [t.expand(shape).contiguous() for t, shape in zip(ts, shapes)]
    normal = torch.empty((N, O, M, 3), dtype=obs_pred.dtype,
                         device=obs_pred.device)
    rhs = torch.empty((N, O, M, n1), dtype=obs_pred.dtype,
                      device=obs_pred.device)
    ptrs = [t.data_ptr() for t in ins] + [None] * (9 - len(ins))
    sfx = "f32" if obs_pred.dtype == torch.float32 else "f64"
    err = _build.launch(getattr(lib, "lsc_planes_" + sfx), obs_pred.device,
                        *ptrs, float(guard_margin), normal.data_ptr(),
                        rhs.data_ptr(), N, O, M, n1)
    if err:
        raise RuntimeError(f"lsc_planes kernel launch failed: CUDA error "
                           f"{err}")
    lsc_planes_launches += 1
    trace.count("planes.kernel_hulls", N * O * M)
    return PlaneConstraints(normal=normal, rhs=rhs,
                            mask=obs_mask[..., None].expand(N, O, M))


# ----------------------------------------------------------------------
# wrapper
# ----------------------------------------------------------------------
def lsc_planes(init_traj, obs_pred, agent_radius, agent_downwash,
               obs_radius, obs_downwash, obs_is_agent, obs_mask,
               slack_flags=None, obs_pred_sizes=None,
               guard_margin: float = 0.0) -> PlaneConstraints:
    """Linear Safe Corridor planes for all (agent, obstacle, segment);
    the arguments and result of ``planner.constraints.lsc_planes``."""
    args = (init_traj, obs_pred, agent_radius, agent_downwash, obs_radius,
            obs_downwash, obs_is_agent, obs_mask, slack_flags,
            obs_pred_sizes, guard_margin)
    dev = obs_pred.device
    if dev.type == "cpu" or obs_pred.shape[-2] > MAX_POINTS:
        return lsc_planes_plain(*args)
    if dev.type == "cuda":
        _check(*args[:-1])
        return _lsc_planes_cuda(*args)
    raise RuntimeError(f"lsc_planes: no kernel for device {dev}")
