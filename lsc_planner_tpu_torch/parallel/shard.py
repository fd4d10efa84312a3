"""Multi-GPU execution: the swarm sharded over the ranks of
``torch.distributed`` (port of lsc_planner_tpu/parallel/shard.py).

The reference's distributed story is ROS TCP pub/sub between per-agent
planner nodes (SURVEY.md section 5.8); here each rank holds a block of
L = N / P agents (every per-agent field that ``state_specs`` marks
sharded; the scalars whole), and the per-cycle neighbour-trajectory
exchange is one collective of the block's predictions, positions,
previous solutions and goals -- the analog of update()'s obstacle
collection (multi_sync_simulator.cpp:269-303).  Each rank then plans its
block against the exchanged view with the simulator's own ``plan_block``,
and the safety audit runs on the gathered position samples.

The exchange, by layout:
- ``make_mesh``: a tiled ``dist.all_gather`` over the mesh (JAX's
  ``all_gather(tiled=True)``), or with ``halo_shards = H`` a ring halo of
  the 2H+1 neighbouring blocks, H steps of ``dist.batch_isend_irecv`` (one
  send to the next rank and one receive from the previous one a step, and
  the reverse, in one batch; JAX's ``ppermute``);
- ``make_mesh_2d`` (hosts x chips, host-major ranks): an all_gather over
  the ranks of a host, and with ``halo_shards = H`` a ring halo of host
  blocks over the ranks of one chip index on every host.
Per-rank minima (the obstacle audits) are ``dist.all_reduce(MIN)``.

The caller names the backend of the process group.  ``nccl`` moves CUDA
tensors and needs one rank a card.  ``gloo`` serves the CPU and several
ranks sharing one card: its collectives take CPU tensors, so a CUDA
tensor is copied to the host for the collective and back (the transport;
the planning stays on the card).  Several cycles a dispatch are not
offered here, as in the JAX package.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from .. import trace
from ..device import resolve_device, synchronize
from ..sim import audit
from ..sim.simulator import (CycleInfo, SwarmState, SyncSimulator,
                             _no_rescue, _norm, _update_rescue,
                             _update_stall_count)

AGENT_AXIS = "agents"
HOST_AXIS = "hosts"          # the slow outer axis of the 2-axis layout


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The ranks a swarm is sharded over, as this rank sees them.

    ``ranks`` are the mesh's global ranks in agent-block order (host-major
    in the 2-axis layout); ``rank`` is this process's global rank and
    ``device`` the device of its tensors.  ``group`` is the process group
    of the mesh (None: the default group).  The 2-axis layout adds
    ``shape`` = (hosts, chips), ``host_group`` (the ranks of this rank's
    host) and ``ring_group`` (this chip index on every host)."""
    ranks: tuple
    rank: int
    device: torch.device
    backend: str
    group: object = None
    shape: Optional[tuple] = None
    host_group: object = None
    ring_group: object = None

    @property
    def size(self) -> int:
        return len(self.ranks)

    @property
    def index(self) -> Optional[int]:
        """This rank's block index, None when it is not in the mesh."""
        return self.ranks.index(self.rank) if self.rank in self.ranks \
            else None


def _need_group() -> None:
    if not dist.is_initialized():
        raise RuntimeError("no process group: call "
                           "torch.distributed.init_process_group first "
                           "(or run through parallel.launch.spawn_ranks)")


def _rank_device(device, backend: str, rank: int) -> torch.device:
    """The device of a rank's tensors: with nccl the rank's own card (one
    rank a card), else the named device (the CUDA device by default)."""
    if backend == "nccl":
        n_cards = torch.cuda.device_count()
        if dist.get_world_size() > n_cards:
            raise RuntimeError(
                f"nccl needs one rank a card: {dist.get_world_size()} ranks "
                f"on {n_cards} cards (use the gloo backend to share a card)")
        return torch.device("cuda", rank)
    return resolve_device(device)


def _canonical(device: torch.device) -> torch.device:
    """"cuda" as the current card's index, so that "cuda" and "cuda:0"
    compare equal where card 0 is current."""
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def _new_group(ranks, n_world: int):
    """A process group of `ranks` (None, the default group, when that is
    all of them); every rank of the default group must call this, in the
    same order, member or not."""
    group = dist.new_group(list(ranks))
    return None if len(ranks) == n_world else group


def make_mesh(n_devices: Optional[int] = None, device=None) -> Mesh:
    """A 1-axis mesh of the first n_devices ranks of the initialised
    default process group (all of them by default).  Every rank calls it;
    a rank past n_devices gets a mesh it is not in (``index`` None)."""
    _need_group()
    world = dist.get_world_size()
    n = world if n_devices is None else n_devices
    if not 1 <= n <= world:
        raise ValueError(f"a mesh of {n} ranks in a world of {world}")
    backend = dist.get_backend()
    rank = dist.get_rank()
    return Mesh(tuple(range(n)), rank, _rank_device(device, backend, rank),
                backend, _new_group(range(n), world))


def make_mesh_2d(n_hosts: int, chips_per_host: Optional[int] = None,
                 device=None) -> Mesh:
    """2-axis mesh (hosts, chips): the slow outer axis between hosts, the
    fast inner one within a host.  Ranks are host-major (rank = host *
    chips + chip), so each host's agents stay contiguous and the halo
    exchange between hosts moves one block a host pair instead of the
    whole swarm."""
    _need_group()
    world = dist.get_world_size()
    if chips_per_host is None:
        chips_per_host = world // n_hosts
    n = n_hosts * chips_per_host
    if not 1 <= n <= world:
        raise ValueError(f"a ({n_hosts}, {chips_per_host}) mesh in a world "
                         f"of {world}")
    backend = dist.get_backend()
    rank = dist.get_rank()
    group = _new_group(range(n), world)
    host_groups = [_new_group([h * chips_per_host + c
                               for c in range(chips_per_host)], world)
                   for h in range(n_hosts)]
    ring_groups = [_new_group([h * chips_per_host + c
                               for h in range(n_hosts)], world)
                   for c in range(chips_per_host)]
    host, chip = divmod(rank, chips_per_host)
    inside = rank < n
    return Mesh(tuple(range(n)), rank, _rank_device(device, backend, rank),
                backend, group, shape=(n_hosts, chips_per_host),
                host_group=host_groups[host] if inside else None,
                ring_group=ring_groups[chip] if inside else None)


def state_specs(axes=AGENT_AXIS) -> SwarmState:
    """The layout of each SwarmState field: `axes` (one axis name, or both
    of the 2-axis mesh) for the per-agent fields sharded over them, None
    for the scalars every rank holds whole."""
    s = axes
    return SwarmState(traj=s, pos=s, vel=s, acc=s, current_goal=s, seq=None,
                      qp_cost=s, primal_res=s, safety_agent_min=None,
                      distance=None, sfc=s, sfc_initialized=s, start=s,
                      desired_goal=s, safety_obs_min=None, stall_count=s,
                      rescue_goal=s, rescue_active=s, rescue_phase=s,
                      slack_flags=s, path_floor=s, best_goal_dist=s)


# ------------------------------------------------------------ collectives
def _staged(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """x as the backend's collectives take it: on the host for gloo, bool
    as uint8."""
    if x.dtype == torch.bool:
        x = x.to(torch.uint8)
    if mesh.backend == "gloo" and x.device.type != "cpu":
        x = x.cpu()
    return x.contiguous()


def _landed(y: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A collective's result back in the dtype and on the device of
    `like`."""
    return y.to(device=like.device, dtype=like.dtype)


def _all_gather(x: torch.Tensor, mesh: Mesh, group=None,
                land: bool = True) -> torch.Tensor:
    """Tiled all_gather along dim 0 over `group` (the whole mesh by
    default).  land=False leaves the result where the collective put it."""
    group = mesh.group if group is None else group
    xs = _staged(x, mesh)
    parts = [torch.empty_like(xs)
             for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, xs, group=group)
    out = torch.cat(parts)
    return _landed(out, x) if land else out


def _ring_halo(x: torch.Tensor, halo: int, ring: list, pos: int,
               mesh: Mesh, group=None) -> torch.Tensor:
    """The (2 halo + 1)-block neighbourhood of this rank's block x on the
    ring of global ranks `ring` (this rank at index `pos`), in offset order
    [-halo..halo], through halo ring steps: each step sends the blocks
    received last to both neighbours and receives theirs, both directions
    in one batch.

    This is the CP/ring analog from SURVEY.md section 5.7: with the swarm
    kept spatially sorted (``spatial_sort_state``), agents outside the
    window cannot enter the LSC interaction ball within a horizon, so a
    band exchange with the neighbouring ranks replaces the O(N) all_gather
    and bounds the K-NN distance matrix at (L, (2 halo + 1) L)."""
    n_ring = len(ring)
    prev_rank, next_rank = ring[(pos - 1) % n_ring], ring[(pos + 1) % n_ring]
    xs = _staged(x, mesh)
    xl = xr = xs
    left, right = {}, {}
    for h in range(1, halo + 1):
        from_prev, from_next = torch.empty_like(xl), torch.empty_like(xr)
        ops = [dist.P2POp(dist.isend, xl, next_rank, group),
               dist.P2POp(dist.irecv, from_prev, prev_rank, group),
               dist.P2POp(dist.isend, xr, prev_rank, group),
               dist.P2POp(dist.irecv, from_next, next_rank, group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        xl, xr = from_prev, from_next          # blocks of rank -h and +h
        left[h], right[h] = xl, xr
    blocks = [left[h] for h in range(halo, 0, -1)] + [xs] + \
        [right[h] for h in range(1, halo + 1)]
    return _landed(torch.cat(blocks), x)


def _min_over(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The minimum of a 0-d tensor over the mesh (JAX's pmin)."""
    xs = _staged(x.reshape(1), mesh).clone()
    dist.all_reduce(xs, op=dist.ReduceOp.MIN, group=mesh.group)
    return _landed(xs, x).reshape(())


def _pack(tensors) -> torch.Tensor:
    """(L, ...) tensors of one dtype as one (L, F) tensor, so that one
    collective moves them all."""
    return torch.cat([t.reshape(t.shape[0], -1) for t in tensors], dim=1)


def _unpack(flat: torch.Tensor, like) -> list:
    """_pack's inverse: rows of flat split into tensors shaped as `like`
    past their first dimension, each contiguous (as the single cycle's
    own tensors are, so that the ops after the exchange see the same
    layouts)."""
    out, col = [], 0
    for t in like:
        width = int(np.prod(t.shape[1:], dtype=np.int64))
        out.append(flat[:, col:col + width].reshape(
            flat.shape[0], *t.shape[1:]).contiguous())
        col += width
    return out


# ------------------------------------------------------------ the cycle
class ShardedCycle:
    """One rank's sharded planning cycle (make_sharded_cycle).  Called as
    cycle(state, dyn_pos=None, dyn_vel=None) on the rank's block of the
    state; returns (the block's next state, CycleInfo) with the per-agent
    info fields the block's and safety_step_min the swarm's.  ``shard`` and
    ``gather`` move a state between the whole swarm and the rank's block,
    and ``stats`` gives run()'s three numbers for the whole swarm."""

    def __init__(self, sim: SyncSimulator, mesh: Mesh,
                 halo_shards: Optional[int] = None):
        N = sim.N
        P = mesh.size
        if N % P != 0:
            raise ValueError(f"agent count {N} must be divisible by the "
                             f"mesh size {P} (pad the mission)")
        if mesh.index is None:
            raise ValueError(f"rank {mesh.rank} is not in the mesh "
                             f"{mesh.ranks}")
        if _canonical(sim.device) != _canonical(mesh.device):
            raise ValueError(f"the simulator's device {sim.device} is not "
                             f"the mesh's {mesh.device}")
        L = N // P
        two_level = mesh.shape is not None
        if halo_shards is not None:
            n_ring = mesh.shape[0] if two_level else P
            if 2 * halo_shards + 1 > n_ring:
                raise ValueError("halo window exceeds the ring "
                                 f"(2*{halo_shards}+1 > {n_ring})")
            for arr in (sim.radius, sim.downwash, sim.nominal_velocity,
                        sim.max_vel, sim.max_acc):
                a = arr.cpu().numpy()
                if not np.allclose(a, a[:1]):
                    raise ValueError("ring-halo exchange requires a "
                                     "homogeneous swarm (spatial sorting "
                                     "permutes agent rows)")
        self.sim, self.mesh, self.halo_shards = sim, mesh, halo_shards
        dev = sim.device
        i = mesh.index
        ids = slice(i * L, (i + 1) * L)
        # the block's own attributes, cut once
        self._radius = sim.radius[ids]
        self._downwash = sim.downwash[ids]
        self._nominal_velocity = sim.nominal_velocity[ids]
        self._max_vel = sim.max_vel[ids]
        self._max_acc = sim.max_acc[ids]
        rows = torch.arange(L, device=dev)[:, None]
        self._obs_attrs = {}
        if halo_shards is None:
            self._self_mask = (i * L + rows) == torch.arange(N, device=dev)
            return
        H = halo_shards
        if two_level:
            n_hosts, chips = mesh.shape
            host, chip = divmod(i, chips)
            block = chips * L                       # agents a host
            self._ring = [h * chips + chip for h in range(n_hosts)]
            self._ring_pos = host
            local = chip * L + rows
        else:
            block = L
            self._ring = list(mesh.ranks)
            self._ring_pos = i
            local = rows
        V = (2 * H + 1) * block
        col = torch.arange(V, device=dev)[None, :]
        # this rank's own rows sit in the view's middle block
        self._self_mask = (col // block == H) & (col % block == local)
        # a homogeneous swarm (checked above): the view's attributes are
        # uniform whatever the sorted order
        self._obs_attrs = dict(
            obs_radius_global=sim.radius[:1].expand(V),
            obs_downwash_global=sim.downwash[:1].expand(V),
            obs_maxacc_global=sim.max_acc[:1, 0].expand(V))

    # -- moving states between the swarm and the block
    def shard(self, state: SwarmState) -> SwarmState:
        return shard_state(state, self.mesh)

    def gather(self, state: SwarmState) -> SwarmState:
        return gather_state(state, self.mesh)

    def stats(self, state: SwarmState, info: CycleInfo) -> torch.Tensor:
        """run()'s (min safety, QPFAILED agents, max goal distance) of the
        whole swarm, float64, through one all_gather of the ranks' three
        numbers.  With gloo the result stays on the host, so that a
        cycle's numbers cost one device-to-host copy."""
        local = torch.stack([
            info.safety_step_min.double(), info.qp_failed.sum().double(),
            _norm(state.pos - state.desired_goal).max().double()])
        every = _all_gather(local[None], self.mesh, land=False)
        return torch.stack([every[:, 0].amin(), every[:, 1].sum(),
                            every[:, 2].amax()])

    def view(self, *blocks) -> list:
        """The exchange: the obstacle view of each (L, ...) block tensor
        (one dtype), packed into one collective: the whole swarm in agent
        order, or the halo window."""
        mesh, H = self.mesh, self.halo_shards
        flat = _pack(blocks)
        if H is None:
            out = _all_gather(flat, mesh)
        elif mesh.shape is not None:
            host = _all_gather(flat, mesh, group=mesh.host_group)
            out = _ring_halo(host, H, self._ring, self._ring_pos, mesh,
                             mesh.ring_group)
        else:
            out = _ring_halo(flat, H, self._ring, self._ring_pos, mesh,
                             mesh.group)
        return _unpack(out, blocks)

    def __call__(self, state: SwarmState, dyn_pos=None, dyn_vel=None,
                 dyn_pred=None):
        """The sharded body (JAX shard.py:141-296).  It leaves out what
        the JAX package's sharded body leaves out: per-agent obstacle
        predictions (the oracle's and the per-agent filters'), experiment
        mode's slack path, the ORCA planner, the K-NN overflow audit and
        the QP's warm-start and iteration diagnostics.  Its stage marks
        are the single cycle's (the exchange falls in predict)."""
        if dyn_pred is not None:
            raise ValueError("the sharded cycle takes no dynamic-obstacle "
                             "predictions (ORACLE and per-agent Kalman "
                             "prediction), as in the JAX package")
        sim, p = self.sim, self.sim.param
        trace.mark("propagate")
        pos_l, vel_l, acc_l = sim.propagate(state)
        # patrol start/goal swap (purely per-agent; the single cycle's code)
        start_l, desired_goal_l = sim._patrol_swap(state, pos_l)
        goal_changed = (desired_goal_l != state.desired_goal).any(-1)
        best_prev = torch.where(goal_changed, float("inf"),
                                state.best_goal_dist)
        stall_count, progress, progress_best, best_goal_dist = \
            _update_stall_count(state.stall_count, best_prev, state.pos,
                                pos_l, vel_l, desired_goal_l, state.seq, p)
        if p.deadlock_rescue:
            rescue_goal, rescue_active, rescue_phase, stall_count = \
                _update_rescue(state, pos_l, desired_goal_l, stall_count,
                               progress, p, esdf=sim.esdf,
                               radius=self._radius,
                               world_min=sim.world_min,
                               world_max=sim.world_max,
                               progress_best=progress_best)
        else:
            rescue_goal, rescue_active, rescue_phase = _no_rescue(state)
        trace.mark("predict")
        init_l, pred_l = sim.predict_and_init(state.traj, pos_l, vel_l,
                                              state.seq,
                                              prev_goal=state.current_goal)

        # --- the communication step: neighbour trajectory exchange ---
        pred_g, pos_g, prev_g, goal_g = self.view(pred_l, pos_l, state.traj,
                                                  desired_goal_l)

        sfc_initialize = ~state.sfc_initialized
        sfc_seed = torch.where(sfc_initialize[:, None], pos_l,
                               state.traj[:, -1, -1, :])
        res, current_goal, sfc, _, path_floor = sim.plan_block(
            pos_l, vel_l, acc_l, init_l, state.seq, pred_global=pred_g,
            obs_pos_global=pos_g, obs_goal_global=goal_g,
            obs_prev_global=prev_g, self_mask=self._self_mask,
            radius=self._radius, downwash=self._downwash,
            nominal_velocity=self._nominal_velocity, max_vel=self._max_vel,
            max_acc=self._max_acc, desired_goal=desired_goal_l,
            sfc_prev=state.sfc, sfc_initialize=sfc_initialize,
            sfc_seed=sfc_seed, rescue_goal=rescue_goal,
            rescue_active=rescue_active, dyn_pos=dyn_pos, dyn_vel=dyn_vel,
            **self._obs_attrs)

        trace.mark("audit")
        # QPFAILED feasible fallback, as in the single cycle: a failing
        # agent flies its shifted previous solution
        qp_failed = res.primal_res > p.qp_failure_threshold
        traj = torch.where(qp_failed[:, None, None, None], init_l, res.traj)

        # --- audit on the gathered position samples (the whole swarm) ---
        ts = audit._sample_times(p.multisim_record_time_step,
                                 p.multisim_time_step, inclusive=True)
        samples_l = audit.positions_at(traj, ts, p.dt)          # (T, L, 3)
        samples = _all_gather(samples_l.transpose(0, 1).contiguous(),
                              self.mesh).transpose(0, 1).contiguous()
        safety_step = torch.amin(audit.pairwise_safety_ratio(
            samples[:-1], sim.radius, sim.downwash))
        step_dist = torch.linalg.vector_norm(torch.diff(samples, dim=0),
                                             dim=-1).sum()

        # dynamic-obstacle and static-box audits: the block's minimum,
        # then the minimum over the ranks (one reduction for both)
        obs_safety = state.safety_obs_min
        local = []
        if sim.O_dyn and dyn_pos is not None:
            local.append(audit.obstacle_safety_ratio(
                pos_l, dyn_pos, self._radius, sim.obs_radius_dyn))
        if sim.static_boxes.shape[0]:
            local.append(audit.static_box_safety_ratio(
                pos_l, sim.static_boxes, self._radius))
        if local:
            obs_safety = torch.minimum(
                obs_safety, _min_over(torch.stack(local).amin(), self.mesh))

        new_state = SwarmState(
            traj=traj, pos=pos_l, vel=vel_l, acc=acc_l,
            current_goal=current_goal, seq=state.seq + 1,
            qp_cost=res.cost, primal_res=res.primal_res,
            safety_agent_min=torch.minimum(state.safety_agent_min,
                                           safety_step),
            distance=state.distance + step_dist,
            sfc=sfc if sfc is not None else state.sfc,
            sfc_initialized=torch.ones_like(state.sfc_initialized),
            start=start_l, desired_goal=desired_goal_l,
            safety_obs_min=obs_safety,
            stall_count=stall_count, rescue_goal=rescue_goal,
            rescue_active=rescue_active, rescue_phase=rescue_phase,
            slack_flags=state.slack_flags, path_floor=path_floor,
            best_goal_dist=best_goal_dist)
        info = CycleInfo(safety_step_min=safety_step, qp_cost=res.cost,
                         primal_res=res.primal_res, qp_failed=qp_failed)
        return new_state, info


def make_sharded_cycle(sim: SyncSimulator, mesh: Mesh,
                       halo_shards: Optional[int] = None) -> ShardedCycle:
    """This rank's multi-GPU cycle: the state sharded over the mesh's
    ranks, one collective a cycle for the trajectory exchange.

    halo_shards = H switches the exchange from the full all_gather to a
    ring halo of the 2H+1 neighbouring blocks.  It requires 2H+1 <= the
    ring's size, a spatially sorted agent order (re-sort with
    ``spatial_sort_state`` between cycles as the swarm moves), and a
    homogeneous swarm (uniform radius, downwash and limits), since sorting
    permutes rows; the exact safety audit stays global either way.

    A mesh from ``make_mesh_2d`` switches to the 2-axis layout: agents
    sharded over (hosts, chips), the trajectory exchange an all_gather
    within each host, and, with halo_shards = H, a host-block ring halo
    between hosts, so that a host sends 2H boundary blocks instead of the
    whole swarm."""
    return ShardedCycle(sim, mesh, halo_shards)


def _part1by2(x: torch.Tensor) -> torch.Tensor:
    """Spread the low 10 bits of x two apart (the Morton interleave)."""
    x = x & 0x3FF
    x = (x | (x << 16)) & 0x30000FF
    x = (x | (x << 8)) & 0x300F00F
    x = (x | (x << 4)) & 0x30C30C3
    x = (x | (x << 2)) & 0x9249249
    return x


def morton_codes(pos: torch.Tensor, world_min, world_max) -> torch.Tensor:
    """30-bit Morton (Z-order) codes of positions (N, 3) over the world
    box, as int64 (torch's uint32 lacks the bit operations).  The bounds
    take part in the arithmetic in their own dtype, as in the JAX package:
    numpy float64 bounds make the quantisation float64."""
    wmin = torch.as_tensor(world_min, device=pos.device)
    wmax = torch.as_tensor(world_max, device=pos.device)
    span = torch.clamp(wmax - wmin, min=1e-9)
    q = torch.clamp((pos - wmin) / span, 0.0, 1.0) * 1023.0
    q = q.to(torch.int64)
    return (_part1by2(q[:, 0]) | (_part1by2(q[:, 1]) << 1) |
            (_part1by2(q[:, 2]) << 2))


def _sort_perm(pos: torch.Tensor, world_min, world_max,
               key: str) -> torch.Tensor:
    if key.startswith("axis:"):
        return torch.argsort(pos[:, int(key.split(":")[1])], stable=True)
    return torch.argsort(morton_codes(pos, world_min, world_max),
                         stable=True)


def spatial_sort_state(state: SwarmState, world_min, world_max,
                       key: str = "morton",
                       mesh: Optional[Mesh] = None) -> SwarmState:
    """Reorder the swarm spatially, so that block adjacency tracks spatial
    adjacency for the ring-halo exchange of
    ``make_sharded_cycle(..., halo_shards=H)``.

    key = "morton": the Z-order curve of the positions, for roughly
    isotropic swarms (any 1-D curve has boundary artifacts: two close
    points can straddle a high-bit boundary and sort far apart).
    key = "axis:k": a plain sort along coordinate k, exact adjacency for
    swarms elongated along one axis (corridor and lane missions).
    The sort is stable, as jnp.argsort is.

    All per-agent state (goals, SFC, deadlock bookkeeping) travels with its
    agent; it requires a homogeneous swarm (the simulator's per-agent
    attributes are not permuted).  With a mesh, `state` is the rank's
    block: every rank gathers the per-agent fields (one collective, packed
    in float64, which holds the int32, bool and float fields exactly),
    sorts the whole swarm alike and keeps its block of the order."""
    specs = state_specs()
    if mesh is None:
        perm = _sort_perm(state.pos, world_min, world_max, key)
        return SwarmState(*[x[perm] if s is not None and x is not None
                            else x for x, s in zip(state, specs)])
    names = [n for n, x, s in zip(state._fields, state, specs)
             if s is not None and x is not None]
    fields = [getattr(state, n) for n in names]
    flat = _all_gather(_pack([x.to(torch.float64) for x in fields]), mesh)
    whole = _unpack(flat, fields)
    pos = whole[names.index("pos")].to(state.pos.dtype)
    perm = _sort_perm(pos, world_min, world_max, key)
    L = state.pos.shape[0]
    mine = perm[mesh.index * L:(mesh.index + 1) * L]
    moved = iter([w[mine].to(x.dtype) for w, x in zip(whole, fields)])
    return SwarmState(*[next(moved) if s is not None and x is not None
                        else x for x, s in zip(state, specs)])


def shard_state(state: SwarmState, mesh: Mesh) -> SwarmState:
    """The rank's block of a whole-swarm state: rows [i L, (i+1) L) of the
    sharded fields, the scalars whole, on the mesh's device."""
    N = state.pos.shape[0]
    if N % mesh.size != 0:
        raise ValueError(f"agent count {N} must be divisible by the mesh "
                         f"size {mesh.size} (pad the mission)")
    if mesh.index is None:
        raise ValueError(f"rank {mesh.rank} is not in the mesh {mesh.ranks}")
    L = N // mesh.size
    rows = slice(mesh.index * L, (mesh.index + 1) * L)
    return SwarmState(*[
        None if x is None else
        x[rows].to(mesh.device).clone() if s is not None else
        x.to(mesh.device)
        for x, s in zip(state, state_specs())])


def gather_state(state: SwarmState, mesh: Mesh) -> SwarmState:
    """The whole swarm's state from the ranks' blocks (every rank calls it
    and gets the whole)."""
    return SwarmState(*[
        None if x is None else
        _all_gather(x, mesh) if s is not None else x
        for x, s in zip(state, state_specs())])


def _seconds(fn, n: int, device: torch.device) -> float:
    """Mean seconds of fn() over n calls after one warm-up: CUDA events
    around the calls on the card, the host clock on the CPU."""
    fn()
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3 / n
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    return (time.perf_counter() - t0) / n


def profile_sharded(sim: SyncSimulator, mesh: Mesh,
                    halo_shards: Optional[int] = None,
                    n_cycles: int = 5) -> dict:
    """Device timing of the sharded cycle (the multi-GPU counterpart of
    SyncSimulator.profile_stages): the neighbour-trajectory exchange alone
    (the all_gather or ring halo of the previous solutions: the
    communication step, the reference's ROS-topic analog), the whole
    cycle, and the difference as the local compute.  Each is timed from
    the initial state, n_cycles calls after a warm-up, with CUDA events on
    the card; every rank returns the slowest rank's times, in seconds a
    cycle, under the JAX package's keys."""
    cycle = make_sharded_cycle(sim, mesh, halo_shards=halo_shards)
    state = shard_state(sim.initial_state(), mesh)
    synchronize(mesh.device)
    t_cycle = _seconds(lambda: cycle(state), n_cycles, mesh.device)
    t_exch = _seconds(lambda: cycle.view(state.traj), n_cycles, mesh.device)
    slowest = _all_gather(torch.tensor([[t_cycle, t_exch]],
                                       dtype=torch.float64,
                                       device=mesh.device), mesh,
                          land=False).amax(0).tolist()
    t_cycle, t_exch = slowest
    return {
        "exchange": t_exch,
        "cycle_total": t_cycle,
        "local_compute_est": max(t_cycle - t_exch, 0.0),
        "n_devices": mesh.size,
        "halo_shards": halo_shards,
    }


def dryrun_multichip(n_ranks: int, backend: str = "gloo",
                     device=None) -> list:
    """The multi-GPU surface on n_ranks ranks (the counterpart of the JAX
    package's __graft_entry__.dryrun_multichip), each rank a process of
    parallel.launch.spawn_ranks on `device` (the CUDA device unless another
    is named):

    (a) the all_gather cycle with K-NN pruning (16 neighbours), 8 agents
        a rank, two cycles, safety-audited;
    (b) with 3 ranks or more, a full-window ring halo (2H+1 = the odd
        sub-mesh) against the all_gather cycle, within 1e-7 m (f64, the
        QP's exit tests off; the halo view's row order differs);
    (c) with 3 ranks or more, the narrow halo (H = 1) and an axis:1 sort
        before each of 3 cycles of a lane swarm, collision-free;
    (d) with 8 ranks or more and a multiple of 4, the 2-axis layout (4
        hosts), all_gather and host halo 1;
    (e) QPFAILED injection (every agent's solve marked failed: the shifted
        previous solution flies), the patrol swap and a dynamic obstacle
        through the sharded body.
    Raises when a part fails on any rank; returns each rank's parts."""
    from .launch import spawn_ranks
    from .ranks import dryrun_rank
    return spawn_ranks(dryrun_rank, n_ranks, backend, device)
