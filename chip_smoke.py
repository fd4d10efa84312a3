#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA GPU (an H100 is the target).

    python3 chip_smoke.py

Phases, one line each; any failure raises and exits non-zero:
  1. a CUDA device is required; prints the card's name and power limit
  2. builds the kernels from lsc_planner_tpu_torch/csrc with nvcc; prints
     ptxas's registers, stack and spills a kernel (the cluster and the
     tiled chol kernels must spill nothing), and the fused IPM's
     layout (rows in shared or device memory, QPs a block, QPs resident an
     SM) at the main path's (B, C) = (1024, 32), (64, 64) and (128, 128)
  3. audit.precision_self_check on the card (the TF32 guard)
  4. each chol kernel (factor_solve, resolve, and the factor alone,
     cholesky_batched) against its plain PyTorch version at n = 39,
     B in {1, 64, 130, 1024}, on IPM-like inputs, each held to the f64
     solve; resolve with factor_solve's L and right-hand side returns
     factor_solve's x bit for bit; cholesky_batched returns factor_solve's
     L bit for bit, also with a non-SPD entry (NaN in its lower triangle,
     in that entry only); NaN stays in a non-SPD entry; kernel, plain and
     library times (CUDA events, median of 50); the large-n kernels (one
     thread-block cluster a matrix where chol.large_plan finds one, else
     the tiled design) the same way at n in {65, 199, 256, 359, 384, 399,
     1024} and B in {1, 64, 130} (n = 1024: B in {1, 130}), f32 and f64
     (the design of each printed), and on the systems of the fourth cycle
     of rsfc64 (B = 64, n = 365, f32: the cluster kernels), rsfc96 (B =
     96, n = 525, f32: tiled) and rsfc64 in f64 (tiled), each held to the
     plain version by backward error (these KKT systems are
     ill-conditioned) with kernel, plain and library times (median of
     20), the bound, and the times of the first design past the clusters
     on the same systems (the one-block kernels: a build of chol.cu
     with -DLSC_CHOL_MAX_G=0 -DLSC_CHOL_ONE_BLOCK, made beside the
     package's in phase 2); the package's design, the one-block kernels,
     clusters of up to 8 blocks (-DLSC_CHOL_MAX_G=8) and the tiled design
     at every n (-DLSC_CHOL_MAX_G=0) timed at B = 64 in f64 at n in {199,
     365, 384} and in f32 at n in {365, 399}; the tiled design at B = 64,
     n = 1024 (f32, IPM-like) held and timed the same way beside the
     one-block kernels and cholesky_ex; and past the one-block kernels'
     cap (n = 1100 and 1536 in f32 at B in {1, 8}, 1100 in f64 at B = 8),
     held by backward error and timed; plus one f64 cycle of an 8-agent
     circle on the card against the CPU
  5. flies the 64-agent circle swap (PRIOR_BASED, float32, all-pairs LSC)
     through SyncSimulator.run() on the card and checks it finished safely
     through the kernels (launch counts = cycles * 40 and cycles * 80)
  6. the fused whole-IPM kernel against its plain version (f32, both held
     to an f64 plain run) on the QPs that the fourth cycle of phases 7 and
     8 hands it (B = 64, C = 64 and B = 1024, C = 32) and that the first
     cycle of the 128-agent all-pairs circle hands it (B = 128, C = 128),
     in 3-D and in a 2-D world (circle128-2d: the kernel's ndim 2),
     with tolerances off (3 iterations) and at Param's tolerances; both
     times (CUDA events, median of 20); at Param's tolerances also the
     kernel's time with the rows forced into the layout it did not pick
  7. flies circle64 again with qp_fused_mode="on": every cycle's QP is one
     launch of the fused kernel, and no chol kernel runs
  8. 40 cycles of the bench's 1024-agent circle swap with K-NN pruning
     (K = 32) through the fused kernel ("auto"), checked for safety and
     against the JAX package's distance flown; stage medians (goal rule,
     K-NN, LSC planes, optimizer.solve, the fused call, the cycle)
  9. the wavefront kernel against its plain version, bit for bit, step
     counts included: on the occupancy grids of the fourth cycle of
     forest20 (priority and static, N = 20), on forest20's tree density
     over a 30 x 30 x 5 m world at 0.25 m ((21, 121, 121), 307,461 cells,
     N = 20, the static grids of its 20 agents), on random grids with
     unreachable cells and an occupied goal (two of them at X = 70, two
     64-bit words a row, one at (21, 121, 121), and two of one z layer,
     as a 2-D world's grids are), and where the cap ends the loop
     (max_iters 8 and 13); kernel and plain times (CUDA
     events, median of 20), mean relaxation steps
 10. forest20 (20 agents in a seeded synthetic forest of 60 tree columns,
     simple_forest's bbox and resolution) flown with run() on the card
     through the grid planner, the SFC corridors and the chol kernels:
     finished, agent and obstacle safety >= 1, 0 QPFAILED, cycles within
     max(20 %, 10) of the JAX package's CPU f32 run, two wavefront
     launches and 40 factor_solve launches a cycle; stage times
 11. 20 cycles of the 128-agent circle swap at Param's all-pairs default
     (C = 128 row groups a QP) through the fused kernel ("auto"): min
     safety >= 1, 0 QPFAILED, one fused launch a cycle, distance flown
     within 10 % of the JAX package's CPU f64 run of the same cycles (its
     f32 run, 14.4 % below its f64 run, is printed beside it); then the
     same cycles in f32 through the port's factored IPM on the chol
     kernels (qp_fused_mode "off"), its distance printed as a second
     witness
 12. several cycles a dispatch (make_scan_cycle: one CUDA graph of 10
     cycles): the SFC face-expansion kernel against its plain version, bit
     for bit, one launch a call, on forest20's cycle-4 and cycle-21 inputs
     and on the 30 m forest's world with 20 seeds, with kernel / plain ms,
     the bound, the busiest agent's tries and the kernel's rounds at the K
     tries it speculates a round; then circle64
     and forest20 flown to the finish and circle1024 for its 40 cycles
     with run(steps_per_dispatch=10), which captures the graph: cycles and
     distance equal to phases 5, 8 and 10, the mission gates, ms a cycle
     of both methods, the capture-plus-instantiate seconds and the kernel
     launches captured in a block; and from the state after 20 uncaptured
     cycles, 10 cycles through that graph against 10 uncaptured ones: the
     differing bits in every SwarmState field (all 0)
 13. dynamic obstacles (run(), f32, PRIOR_BASED, obstacles evaluated on the
     host each cycle): dyn64, circle64 with 8 obstacles crossing the ring
     (2 each of spin, straight, multisim_patrol and gaussian, 0.3 m, 0.5
     m/s), flown to the finish with the previous-solution prediction
     (cycles within max(20 %, 10) of the JAX package's CPU f32 run; agent
     safety >= 1, 0 QPFAILED, obstacle safety > 0.85), then 40 cycles each
     with the ORACLE prediction and with the per-agent Kalman filters on
     observations with 0.02 m of noise: obstacle safety > 0.85 (0.8 with
     the noise), finite positions, agent safety and QPFAILED printed
     beside the JAX package's (under these modes agents predict one
     another at constant velocity, and the JAX package's own ORACLE run of
     dyn64 collides in f64, see fly_dynamic); all with 40 factor_solve and
     80 resolve launches a cycle; dyn1024, circle1024 K=32
     with 16 straight obstacles across the ring, 20 cycles: one fused-IPM
     launch a cycle at C = K + 16 = 48, agent safety >= 1, 0 QPFAILED; ms a
     cycle and the host's obstacle step a cycle
 14. worlds: forest20's occupancy written to a .bt (save_bt) and loaded
     with ESDF.from_bt on the card, distance field and occupancy bit for
     bit with ESDF.from_occupancy of that occupancy, then flown with no
     static boxes and world_use_octomap (finished, agent safety >= 1, 0
     QPFAILED, cycles within max(20 %, 10) of the JAX package's CPU f32
     run of the same .bt, two wavefront, 40 factor_solve, 80 resolve and
     one face-expansion launch a cycle); forest20 with the exact castRay
     (grid_los_exact_castray): 20 uncaptured cycles, then
     run(steps_per_dispatch=10) of 20 cycles with the same bits in every
     SwarmState field; the grid goal stage's ms against phase 10's
 15. the other planner modes (f32, PRIOR_BASED; JAX's CPU f32 runs of
     the same missions as constants): bvc64 (BVC) to the finish, dense
     rows at n = 45 on the one-warp chol kernels, cycles within max(20 %,
     10) of JAX's; rsfc64 (RECIPROCAL_RSFC), 20 cycles of the slack QP at
     n = 365 on the large-n chol kernels, distance within 10 % of JAX's,
     safety > 0.9, then the same 20 cycles through
     run(steps_per_dispatch=10) with 0 differing bits, and each cycle
     with a QPFAILED agent run again from the same state on the card, in
     f32 with the plain chol versions and in f64, each run's QPFAILED
     agents and the failing agents' primal residuals and gaps printed
     beside the kernels'; exp64 (experiment
     mode) through cycle() and inject_positions: 4 agents pushed 0.3-0.5
     m before cycle 5, that cycle finite with max primal residual < 0.1,
     the flags set and cleared and the SFCs re-seeded, then 60 cycles
     with safety > 0.8 after it; rsfc96 (RECIPROCAL_RSFC, 96 agents, all
     pairs), 20 cycles of the slack QP at n = 45 + 96 x 5 = 525 on the
     tiled design: distance within 10 % of JAX's f32 run, safety > 0.9,
     its QPFAILED cycles run again as rsfc64's, then the same cycles
     through run(steps_per_dispatch=10) with 0 differing bits, ms a cycle
     uncaptured and captured and the chol kernels' share of a captured
     cycle (launches x their phase-4 times on its systems); rsfc64 in f64,
     its 20 cycles at n = 365 on the tiled design: each cycle from the
     same state on the tiled kernels and on the plain chol versions in
     f64 on the card, the same QPFAILED agents, the kernels' max primal
     residual <= max(1e-10, 10 x the plain versions') and max gap <= 10 x
     theirs (a factor that rounds like f32 reads 7.5e-7 and more where
     f64 reads 5e-15), the trajectories'
     difference printed; distance within 10 % of JAX's f64 run, its
     distance from that and from the port's own CPU f64 run printed
     (PORT_CPU_F64_RSFC64: the f64 distance follows the reductions'
     rounding), safety > 0.9, QPFAILED no more than JAX's;
     circle64-2d to the finish (z within 0.05
     m of z_2d, cycles in the band of JAX's), then 10 captured cycles
     after 20 against 10 uncaptured, bit for bit; circle128-2d, 20
     all-pairs cycles through the fused IPM's 2-D instantiation, one
     launch a cycle, distance within 10 % of JAX's f64 run; rh64
     (RIGHT_HAND), 40 cycles, safety >= 1; the launch counts of each
     (40 factor_solve and 80 resolve a cycle on the kernels of its n and
     dtype: the cluster kernels at rsfc64's and exp64's in f32, the tiled
     design at rsfc96's and at rsfc64's in f64)
 16. the ORCA planner and the host surface (f32; JAX's CPU f32 runs of the
     same missions as constants, ORCA_CASES): the rotational exchange at
     the bench's circle geometry (agent i's goal agent (i + N // 3)'s
     start).  orca64 (STATIC goals) through run() to the finish, cycles
     within max(20 %, 10) of JAX's, then through
     run(steps_per_dispatch=10) with the same cycles and distance;
     orca64-goal (the ORCA goal mode) and orca64-2d, 40 cycles each,
     distance within 10 % of JAX's; orca1024, 40 cycles uncaptured and
     captured, 10 captured cycles after 20 against 10 uncaptured (0
     differing bits), the CUDA kernels of one cycle (torch.profiler) and
     its peak device memory; every ORCA run with min safety > 0.75 and no
     kernel launch, ms a cycle printed.  The continuous-time audit
     (audit.continuous_safety_ratio) at cycle 20 of orca64 and of
     circle64's LSC run (>= 1), each beside a sampled audit of the same
     trajectories over their horizon, never above it by more than 1e-4;
     circle64's run(profile=True) stage_times beside the same stages
     timed inside cycles (stage_times); and the CLI as subprocesses:
     --generate circle:64, --mission with --save-result for 20 cycles on
     the card, --replay of its CSV (summary keys, start positions)
 17. the sharded cycle (parallel/shard.py on torch.distributed), f32:
     17a, a process group of one rank on nccl in this process,
     circle1024 (K = 32) for 40 cycles through make_sharded_cycle, each
     cycle also run by sim.cycle from the same state: 0 differing traj
     bits, one fused launch a cycle, ms a cycle beside phase 8's; 17b, 4
     gloo ranks as processes sharing the card (parallel.launch.
     spawn_ranks), circle1024 by all_gather, L = 256 agents a rank (one
     fused-IPM launch a rank a cycle at B = 256, C = 32), 40 cycles: min
     safety >= 1, 0 QPFAILED, distance within 10 % of phase 8's, the
     slowest rank's ms a cycle, profile_sharded's exchange and cycle ms,
     the max trajectory difference from the single process at cycle 3
     (printed); 17c, the same ranks as 2 hosts x 2 chips: 0 differing
     bits against 17b; 17d, lanes1024 (make_lane_mission, K = 4), halo 1
     with an axis:1 sort before every cycle, through run(cycle_fn=...):
     in f64 (the chol kernels) to the finish under 300 cycles: finished,
     safety >= 1, 0 QPFAILED; in f32 (the fused IPM) 100 cycles: safety
     >= 1, 0 QPFAILED, the agents not home and their lanes' y printed
     (lanes1024 spans 1 km along y, and the f32 planner of either
     package strands head-on pairs a few hundred metres from the
     origin), ms a cycle and
     the exchange's ms beside 10 cycles of the all_gather exchange on the
     same mission; 17e, dryrun_multichip(4, "gloo", "cuda"); the card's
     name and power limit beside the times
 18. the LSC planes kernel (csrc/planes.cu) against its plain version, bit
     for bit, one launch a call, on the fourth cycle's call of the
     benchmark's random1024 (lscbench/cell.py at RANDOM1024_SEED; (N, O,
     M, K) = (1024, 32, 5, 6)) and of forest20 ((20, 20, 5, 6)): kernel
     and plain ms (CUDA events, median of 50 and 20) and the bound.
     Every launch count checked in phases 5-17 includes the planes
     kernel's: one launch an LSC cycle (a rank's block's in phase 17)
Then the kernels' JSON line (every kernel: launches on its main path,
error against its plain version, kernel / plain / library ms, and the
bound for the same work computed from this run's inputs), and last
{"ok": true, "device": {...}}.  The script imports nothing of JAX.
"""
import contextlib
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.distributed as dist

from lsc_planner_tpu_torch import (GoalMode, ObstacleSpec, Param,
                                   PredictionMode, make_circle_mission,
                                   make_random_mission)
from lsc_planner_tpu_torch import trace
from lsc_planner_tpu_torch.config import PlannerMode
from lsc_planner_tpu_torch.config import SP_EPSILON
from lsc_planner_tpu_torch.convert import state_from_numpy, state_to_numpy
from lsc_planner_tpu_torch.ops import _build, chol, ipm, wavefront
from lsc_planner_tpu_torch.ops import corridor as corridor_ops
from lsc_planner_tpu_torch.ops import lsc_planes as lsc_ops
from lsc_planner_tpu_torch.missions import make_lane_mission
from lsc_planner_tpu_torch.ops.grid_search import GridPlanner
from lsc_planner_tpu_torch.parallel import ranks, shard
from lsc_planner_tpu_torch.parallel.launch import spawn_ranks
from lsc_planner_tpu_torch.planner import constraints
from lsc_planner_tpu_torch.sim import audit
from lsc_planner_tpu_torch.sim import simulator as sim_mod
from lsc_planner_tpu_torch.sim.simulator import (SyncSimulator,
                                                  launch_counts,
                                                  reset_launch_counts)
from lsc_planner_tpu_torch.world.corridor import CorridorBuilder
from lsc_planner_tpu_torch.world.esdf import ESDF
from lsc_planner_tpu_torch.world.mapping import occupancy_to_keys, save_bt

N_QP = 39                   # QP variables per agent (3 dims x 13)
MAIN_B = 64                 # agents in the flown mission = QP batch
# The JAX package's SyncSimulator.run() of the same 64-agent mission on a
# CPU in float32 (lsc_planner_tpu, dense-row IPM, Param defaults):
# 145 cycles, min safety 1.0071, 0 QPFAILED.
JAX_CPU_F32_CYCLES = 145
# The port's own circle64 run through the chol kernels on an H100 (phase 5)
PORT_CHOL_CYCLES = 142
BIG_N, BIG_K, BIG_CYCLES = 1024, 32, 40     # bench.py's headline size
# The JAX package's SyncSimulator of the same 1024-agent mission (K = 32,
# PRIOR_BASED, Param defaults) on a CPU in float32 (non-fused factored
# XLA IPM), 40 _cycle_jit calls from the initial state: total distance
# flown 6073.22265625 m, min safety 1.1458, 0 QPFAILED, K-NN overflow 0
# in every cycle.
JAX_CPU_F32_DIST_1024 = 6073.22265625
JAX_CPU_F32_KNN_OVERFLOW_MAX = 0
# 20 cycles of the 128-agent circle swap at Param's all-pairs default
# (C = 128 row groups a QP), PRIOR_BASED: the JAX package's SyncSimulator
# on a CPU (non-fused factored XLA IPM), 20 _cycle_jit calls from the
# initial state, total distance flown.  In float64 530.7036 m (min safety
# 2.1833, 0 QPFAILED; the port's own f64 run on a CPU agrees to 1e-7 m);
# in float32 454.4812 m (min safety 1.4554, 0 QPFAILED), where the port's
# f32 run of the same factored IPM on a CPU flies 518.2820 m: f32
# rounding alone moves this distance by more than 10 %, so the phase holds
# the port's f32 run to the f64 distance and prints the others beside it
# (tests/test_torch_f32_missions.py circle128 prints these runs).
ALL_N, ALL_CYCLES = 128, 20
# phase 4: the large-n chol kernels' sizes.  The slack QP's n is nv + C M
# with a slack entry for each of C = 64 agent columns (an agent's own
# column is masked but keeps its entries, as in the JAX package): 359 for
# exp64 (nv 39), 365 for rsfc64 (nv 45, no stop-at-horizon rows), 399
# = 39 + 72 x 5 for dyn64's 64 agents and 8 obstacles in experiment mode;
# 256 and 384 the largest n a cluster of 2 blocks holds in f64 and f32
# (chol.large_plan; the tiled design past them), 1024 the first design's
# cap
LARGE_NS = (65, 199, 256, 359, 384, 399, 1024)
# and where phase 4 times the large-n designs side by side: f64 at a
# cluster of 2 (199) and at n where only clusters of 8 hold the factor
# (365, 384), f32 at a cluster of 2 (365: the tiled design beside the
# clusters) and where only clusters of 4 do (399)
DESIGN_CASES = ((torch.float64, 199), (torch.float64, 365),
                (torch.float64, 384), (torch.float32, 365),
                (torch.float32, 399))
# past the first design's cap of 1024 (the tiled design only): (dtype, n,
# batch sizes)
PAST_CAP_CASES = ((torch.float32, 1100, (1, 8)),
                  (torch.float32, 1536, (1, 8)),
                  (torch.float64, 1100, (8,)))
JAX_CPU_F64_DIST_128 = 530.7035639320115
JAX_CPU_F32_DIST_128 = 454.4812316894531
OFF3 = dict(iters=3, tol_gap=0.0, tol_rp=0.0, correctors=1)
FOREST_N, FOREST_SEED, FOREST_TREES = 20, 0, 60
FOREST_WORLD = (-5.0, -5.0, 0.0, 5.0, 5.0, 2.5)     # simple_forest's bbox
# The JAX package's SyncSimulator.run() of forest20 (seed 0, PRIOR_BASED,
# Param defaults) on a CPU in float32: 101 cycles, distance 109.926 m,
# min safety 1.0253, obstacle safety 1.8926, 0 QPFAILED.
JAX_CPU_F32_FOREST_CYCLES = 101
JAX_CPU_F32_FOREST_DIST = 109.9262466430664
# forest20's tree density (60 over 100 m^2) over a 30 x 30 x 5 m world: at
# the grid planner's 0.25 m its grids are (21, 121, 121), 307,461 cells
FOREST30_WORLD = (-15.0, -15.0, 0.0, 15.0, 15.0, 5.0)
FOREST30_TREES = 540
# phase 12: cycles a dispatch, and the uncaptured cycles before its bit
# comparison
CAPTURE_K, CAPTURE_BEFORE = 10, 20
# phase 18: the seed of the benchmark cell random1024's mission
RANDOM1024_SEED = 3147521011
# phase 13: dynamic obstacles of 0.3 m at 0.5 m/s (downwash 1, max_acc 1)
DYN_SIZE, DYN_SPEED = 0.3, 0.5
# cycles of the ORACLE and Kalman runs of dyn64, its Kalman filters'
# observation noise (m), and dyn1024's cycles and obstacles
DYN_MODE_CYCLES, DYN_NOISE = 40, 0.02
DYN1024_CYCLES, DYN1024_OBSTACLES = 20, 16
# The JAX package's SyncSimulator.run() of dyn64 (PRIOR_BASED, Param
# defaults, previous-solution prediction) on a CPU in float32: 146 cycles,
# min safety 1.0047, obstacle safety 1.0215, 0 QPFAILED, 1255.059 m (the
# port's CPU f32 run: 140 cycles, 1.0063, 1.0565, 0 QPFAILED).
JAX_CPU_F32_DYN64_CYCLES = 146
# The JAX package's SyncSimulator.run() of forest20's agents in the .bt
# world written from forest20's occupancy (ESDF.from_bt, no static boxes,
# world_use_octomap) on a CPU in float32: 99 cycles, min safety 1.0401,
# 0 QPFAILED, 107.607 m.  In f64 both packages fly 160 cycles (safety
# 1.12769, 110.4232 m); the port's CPU f32 run keeps one agent in a
# livelock to the 1000-cycle cap (tests/test_torch_f32_missions.py
# forest20_bt forest20_bt_f64).
JAX_CPU_F32_FOREST_BT_CYCLES = 99
# phase 14: cycles of the exact castRay's uncaptured and captured runs
CASTRAY_CYCLES = 20
# phase 15: the other planner modes at circle64 / circle128 width, each
# case (agents, Param keywords besides PRIOR_BASED, cycles: None flies to
# the finish)
MODE_CASES = {
    "bvc64": (64, dict(planner_mode=PlannerMode.BVC), None),
    "rsfc64": (64, dict(planner_mode=PlannerMode.RECIPROCAL_RSFC), 20),
    "rsfc96": (96, dict(planner_mode=PlannerMode.RECIPROCAL_RSFC), 20),
    "exp64": (64, dict(multisim_experiment=True), 60),
    "circle64_2d": (64, dict(world_dimension=2, world_z_2d=1.0), None),
    "circle128_2d": (128, dict(world_dimension=2, world_z_2d=1.0), 20),
    "rh64": (64, dict(goal_mode=GoalMode.RIGHT_HAND), 40),
}
# The JAX package's runs of these missions on a CPU in float32 through
# fly_cycles, 0 QPFAILED in each (tests/test_torch_f32_missions.py bvc64
# rsfc64 exp64 circle64_2d circle128_2d circle128_2d_f64 rh64 prints
# them):
# bvc64 (cycles, min safety), to the finish: 1393.2155 m
JAX_CPU_F32_BVC64 = (217, 1.0052)
# rsfc64 (distance over its 20 cycles, min safety, QPFAILED)
JAX_CPU_F32_RSFC64 = (260.8952331542969, 2.9960, 0)
# rsfc96 (the same, f32: the slack QP at n = 525, B = 96) and rsfc64 in
# f64 (tests/test_torch_f32_missions.py rsfc96 rsfc64_f64)
JAX_CPU_F32_RSFC96 = (417.11614990234375, 2.7914, 2)
JAX_CPU_F64_RSFC64 = (277.2906296029458, 2.9988, 0)
# rsfc64 in f64 by the port on a CPU (plain chol versions, torch on one
# thread; ... rsfc64_f64_port): 6.7 % below JAX's f64 run, and 265.778 m
# on four threads (--threads=4): the BLAS's blocking of the same products
# alone moves the f64 distance over these 20 cycles by 2.7 %.  The two
# packages' f64 slack QPs at Param's slack weight 1e5 agree only to ~1e-4
# m a solve (tests/test_torch_slack.py), and the same cycle from the same
# state with torch.cholesky_solve for the two triangular solves moves the
# new trajectories by 8e-5 m: the distance follows the reductions'
# rounding in f64 as in f32, so phase 15 holds it to JAX's within 10 %,
# the band of every other distance over a fixed run, and prints its
# distance from JAX's and from this run.
PORT_CPU_F64_RSFC64 = (258.77112375115405, 0)
# The f64 precision gate of phase 15 (fly_rsfc64_f64), each cycle from the
# same state on the tiled kernels and on the plain chol versions: the
# kernels' max primal residual <= max(F64_PRIMAL_TOL, F64_PLAIN_RATIO x
# the plain versions') and max gap <= F64_PLAIN_RATIO x theirs.  On the
# CPU (... --threads=3 rsfc64_f64_rounding) the plain f64 cycles 0 and 3
# read a primal residual of 5.3e-15 and 5.7e-15 and a gap of 8.8e-11 and
# 3.7e-10, cholesky_solve the same to 1e-6 relative; the chol calls
# rounded to f32 read 7.5e-7 and 2.1e-2, gaps 1.8e-4 and 2.8e-2.  A few
# of the card's cycles end their 40 iterations unconverged on both
# (primal ~1e-4, gap ~0.1): there the two runs are held to each other.
F64_PRIMAL_TOL = 1e-10
F64_PLAIN_RATIO = 10.0
# exp64: 60 cycles (not finished), 635.5281 m, min safety 1.0148 after the
# injection cycle and overall, that cycle's max primal residual 8.54e-06,
# flags and SFC resets of agents 0, 16, 32 and 48, cleared after it
JAX_CPU_F32_EXP64 = ("60 cycles, 635.5281 m, min safety 1.0148 after "
                     "the injection cycle, its max primal residual "
                     "8.54e-06")
# circle64_2d (cycles, min safety), to the finish: 1354.1218 m
JAX_CPU_F32_2D64 = (197, 1.0082)
# circle128_2d: distance over its 20 cycles in f32 (min safety 1.4215) and
# in f64 (2.1833).  As on circle128 (phase 11), JAX's f32 run is 14.1 %
# below its f64 run, so the phase holds the port to the f64 distance.
JAX_CPU_2D128 = (455.5657043457031, 530.579147154177)
# rh64 (distance over its 40 cycles, cycles): min safety 1.0027
JAX_CPU_F32_RH64 = (611.137939453125, 40)
# phase 16: the ORCA planner on the rotational exchange at the bench's
# circle geometry (orca_case), each case (agents, Param keywords, cycles:
# None flies to the finish under ORCA_CAP)
ORCA_CASES = {
    "orca64": (64, dict(goal_mode=GoalMode.STATIC), None),
    "orca64_goal": (64, dict(goal_mode=GoalMode.ORCA), 40),
    "orca64_2d": (64, dict(goal_mode=GoalMode.STATIC, world_dimension=2,
                           world_z_2d=1.0), 40),
    "orca1024": (1024, dict(goal_mode=GoalMode.STATIC), 40),
}
ORCA_CAP = 1000
# The JAX package's run() of these missions on a CPU in float32, x64 off
# (tests/test_torch_f32_missions.py orca64 orca64_goal orca64_2d orca1024
# prints them): (cycles, distance, min safety).  The port's CPU f32 runs:
# orca64 86 cycles, 1003.4241 m; orca64_goal 54.0649 m; orca64_2d
# 505.7791 m.
JAX_CPU_F32_ORCA = {
    "orca64": (86, 1003.424072265625, 1.5136),         # finished
    "orca64_goal": (40, 54.06486129760742, 2.7250),
    "orca64_2d": (40, 505.779052734375, 1.5136),
    "orca1024": (40, 8143.02490234375, 2.8603),
}
# exp64's disturbance: before cycle EXP_INJECT_CYCLE the agents EXP_PUSHED
# are observed 0.3-0.5 m off their plans (horizontal offsets, numpy seed
# EXP_SEED)
EXP_INJECT_CYCLE, EXP_PUSHED, EXP_SEED = 5, (0, 16, 32, 48), 15
# phase 17: the sharded cycle.  circle1024 (K = 32) on SHARD_RANKS gloo
# ranks sharing the card, L = 256 agents a rank (one fused-IPM launch a
# rank a cycle at B = 256, C = 32), SHARD_CYCLES cycles, its trajectories
# held to the single process's at SHARD_DIFF_CYCLE; lanes1024
# (make_lane_mission, K = 4, halo 1, an axis:1 sort before every cycle) to
# the finish under LANES_CAP in f64, LANES_F32_CYCLES cycles of it in f32,
# and LANES_AG_CYCLES cycles of the all_gather exchange on the same
# mission.  lanes1024's lanes lie at y = 0 .. 1022 m, and the f32 planner
# of either package (absolute world coordinates in the QP) brings
# head-on pairs home ever more slowly away from the origin and strands
# them a few hundred metres out: on the CPU in f32, lanes8 finishes in 53
# (JAX, x64 off) and 50 (the port) cycles at the origin, the port's in 67
# moved 100 m along y, and both stay unfinished after 300 cycles moved
# 200 m or 1000 m.  So the finish is held in f64, and the f32 run's
# agents not home are printed with their lanes' y.
SHARD_RANKS, SHARD_CYCLES, SHARD_DIFF_CYCLE = 4, 40, 3
LANES_N, LANES_K, LANES_CAP, LANES_AG_CYCLES = 1024, 4, 300, 10
LANES_F32_CYCLES = 100
# H100 peaks for the bounds (NVIDIA's data sheet, SXM): f32 outside the
# tensor cores; f64 through the tensor cores (DMMA, IEEE f64 FMAs: 67
# TFLOP/s, twice the 33.5 outside them), the card's highest f64 rate and
# so the least time; HBM3 bandwidth
PEAK_F32_FLOPS = 67e12
PEAK_F64_FLOPS = 67e12
PEAK_BYTES = 3.35e12


def smi_line():
    """The card's name and power limit, as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def phase(name, msg):
    print(f"[{name}] {msg}", flush=True)


def bound(nbytes, ops, peak=PEAK_F32_FLOPS):
    """(least ms the H100 could take, "bytes" or "operations"); ops at the
    rate `peak` (operations a second)."""
    t_b, t_o = nbytes / PEAK_BYTES, ops / peak
    return (1e3 * max(t_b, t_o), "bytes" if t_b >= t_o else "operations")


def chol_bound(kind, B, n, elem=4):
    """bound() of one chol call on B systems of size n: what the function
    must move (H's lower triangle in, all of L out with its zeros, or L's
    lower triangle in for resolve; the right-hand side in and x out) and
    its operations (the factor n^3 / 3, the two substitutions 2 n^2 a
    system) at the peak of the element's type (f32, or f64 for elem 8)."""
    tri, full = n * (n + 1) // 2, n * n
    nbytes, ops = {
        "factor_solve": (tri + full + 2 * n, n ** 3 / 3 + 2 * n * n),
        "resolve": (tri + 2 * n, 2 * n * n),
        "factor": (tri + full, n ** 3 / 3),
    }[kind]
    return bound(elem * B * nbytes, B * ops,
                 PEAK_F64_FLOPS if elem == 8 else PEAK_F32_FLOPS)


def tensor_bytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def check_launches(what, **want):
    """The kernel launches since the last reset_launch_counts()
    (launch_counts()); raises unless each kernel's is its count in want, 0
    for a kernel not named."""
    got = launch_counts()
    want = {k: want.get(k, 0) for k in got}
    if got != want:
        raise AssertionError(f"{what}: kernel launches {got}, expected "
                             f"{want}")
    return got


def forest_mission(seed=FOREST_SEED, qn=FOREST_N, n_trees=FOREST_TREES,
                   world=FOREST_WORLD):
    """A seeded synthetic forest with simple_forest's statistics:
    make_random_mission(qn, world, seed) plus n_trees full-height
    0.3 x 0.3 m tree columns as `static` boxes, centres uniform over the
    world (inset 0.15 m) and none within 0.5 m (horizontally) of a start or
    goal (the generator of tests/test_torch_cuda.py::forest_mission)."""
    m = make_random_mission(qn, world=world, seed=seed)
    keep = np.array([a.start[:2] for a in m.agents] +
                    [a.goal[:2] for a in m.agents], dtype=np.float64)
    lo, hi = np.asarray(world[:2]) + 0.15, np.asarray(world[3:5]) - 0.15
    zc, zh = 0.5 * (world[2] + world[5]), 0.5 * (world[5] - world[2])
    rng = np.random.default_rng(seed)
    trees = []
    while len(trees) < n_trees:
        c = rng.uniform(lo, hi)
        if np.min(np.linalg.norm(keep - c, axis=1)) > 0.5:
            trees.append(c)
    m.obstacles = [ObstacleSpec(kind="static",
                                pose=np.array([c[0], c[1], zc]),
                                dimensions=np.array([0.15, 0.15, zh]))
                   for c in trees]
    return m


def dyn64_mission(qn=MAIN_B):
    """circle_mission(qn) (radius 9.17 m at 64 agents) with 8 dynamic
    obstacles at the agents' height: two spin about the centre (radii 3 and
    6 m, opposite senses), two straight and two multisim_patrol lines
    cross the ring from 1.3 m outside it to the far side, and two gaussian
    random walks start near the centre (numpy seeds 6 and 7 of the
    obstacle generator)."""
    m = circle_mission(qn)
    r = float(np.linalg.norm(m.agents[0].start[:2])) + 1.3
    z = float(m.agents[0].start[2])

    def p(x, y):
        return np.array([x, y, z])
    kw = dict(size=DYN_SIZE, max_acc=1.0, downwash=1.0)
    m.obstacles = [
        ObstacleSpec(kind="spin", axis_position=p(0, 0),
                     axis_ori=np.array([0.0, 0.0, 1.0]), start=p(3.0, 0),
                     speed=DYN_SPEED, **kw),
        ObstacleSpec(kind="spin", axis_position=p(0, 0),
                     axis_ori=np.array([0.0, 0.0, -1.0]), start=p(0, -6.0),
                     speed=DYN_SPEED, **kw),
        ObstacleSpec(kind="straight", start=p(-r, 2.0), goal=p(r, 2.0),
                     speed=DYN_SPEED, **kw),
        ObstacleSpec(kind="straight", start=p(2.0, r), goal=p(2.0, -r),
                     speed=DYN_SPEED, **kw),
        ObstacleSpec(kind="multisim_patrol",
                     waypoints=np.array([p(-r, -3.0), p(r, -3.0)]),
                     speed=DYN_SPEED, **kw),
        ObstacleSpec(kind="multisim_patrol",
                     waypoints=np.array([p(-3.0, r), p(-3.0, -r)]),
                     speed=DYN_SPEED, **kw),
        ObstacleSpec(kind="gaussian", start=p(1.0, -1.0),
                     initial_vel=np.array([0.3, 0.2, 0.0]), stddev_acc=0.3,
                     max_vel=DYN_SPEED, acc_update_cycle=0.5, **kw),
        ObstacleSpec(kind="gaussian", start=p(-1.0, 1.0),
                     initial_vel=np.array([-0.2, -0.3, 0.0]), stddev_acc=0.3,
                     max_vel=DYN_SPEED, acc_update_cycle=0.5, **kw)]
    return m


def dyn1024_mission():
    """circle_mission(1024) (radius 146.7 m) with DYN1024_OBSTACLES
    straight obstacles across the ring: each starts 1.5 m outside it,
    midway between two agents, and heads for the far side at 0.5 m/s."""
    m = circle_mission(BIG_N)
    r = float(np.linalg.norm(m.agents[0].start[:2])) + 1.5
    z = float(m.agents[0].start[2])
    m.obstacles = []
    for k in range(DYN1024_OBSTACLES):
        th = 2 * math.pi * (k + 0.5 / BIG_N * DYN1024_OBSTACLES) / \
            DYN1024_OBSTACLES
        start = np.array([r * math.cos(th), r * math.sin(th), z])
        m.obstacles.append(ObstacleSpec(
            kind="straight", size=DYN_SIZE, max_acc=1.0, downwash=1.0,
            start=start, goal=np.array([-start[0], -start[1], z]),
            speed=DYN_SPEED))
    return m


def ptxas_summary(log):
    """'kernel<type>: registers, stack, spills' for each kernel in nvcc's
    -Xptxas -v output."""
    out, name = [], None
    for line in log.splitlines():
        m = re.search(r"Function properties for \S*?([a-z_]+_kernel)"
                      r"(?:I(\w+?)EE?v)?", line)
        if m:
            args = re.findall(r"Li(\d+)E|Lb([01])E|^([fd])|(?<=E)([fd])",
                              m.group(2) or "")
            args = [a or {"0": "false", "1": "true"}.get(b) or c or d
                    for a, b, c, d in args]
            name = m.group(1) + (f"<{','.join(args)}>" if args else "")
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores",
                      line)
        if m and name:
            out.append(f"{name}: {m.group(1)} B stack, {m.group(2)} B "
                       "spilled")
        m = re.search(r"Used (\d+) registers", line)
        if m and out:
            out[-1] += f", {m.group(1)} registers"
    return "; ".join(out)


def check_no_spills(summary, prefix="cluster_"):
    """Raises unless every kernel of ptxas_summary named prefix... spills
    0 bytes; returns how many such kernels there are."""
    found = re.findall(rf"({prefix}\w+(?:<[^>]*>)?): \d+ B stack, (\d+) B "
                       r"spilled", summary)
    spilled = {name: int(b) for name, b in found if int(b)}
    if not found or spilled:
        raise AssertionError(f"ptxas: {prefix}* kernels {found}, spills "
                             f"{spilled}")
    return len(found)


def circle_mission(qn):
    """The bench's circle swap (bench.py:65-71): ~0.9 m arc spacing."""
    radius = max(4.0, 0.45 * qn / math.pi)
    w = radius + 2.0
    return make_circle_mission(qn, radius=radius,
                               world=(-w, -w, 0, w, w, 2.5))


def ipm_like_system(B, n, seed):
    """Jacobi-scaled SPD matrices as _ipm factors them (qp.py:257-258):
    P + A'DA with an interior-point spread of D, unit diagonal."""
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(B, 3 * n, n))
    d = np.exp(rng.uniform(-np.log(1e3), np.log(1e3), size=(B, 3 * n)))
    H = np.eye(n) + np.einsum("brv,br,brw->bvw", A, d, A)
    dsc = 1.0 / np.sqrt(np.einsum("bvv->bv", H))
    Hs = H * dsc[:, :, None] * dsc[:, None, :]
    return Hs, rng.normal(size=(B, n)), rng.normal(size=(B, n))


def median_ms(fn, reps=50):
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bits(t):
    """t's bits as integers: torch.equal on them compares NaNs too."""
    return t.view(torch.int64 if t.dtype == torch.float64 else torch.int32)


def check_factor_alone(H, R, what):
    """cholesky_batched(H) is chol_factor_solve(H, R)'s L bit for bit (one
    kernel, the factor alone stops before the solve); returns the
    entries that are not finite."""
    F = chol.cholesky_batched(H)
    L = chol.chol_factor_solve(H, R)[0]
    torch.cuda.synchronize()
    if not torch.equal(bits(F), bits(L)):
        raise AssertionError(f"cholesky_batched {what}: differs from "
                             "factor_solve's L in "
                             f"{int((bits(F) != bits(L)).sum())} entries")
    if not torch.equal(torch.triu(F, 1), torch.zeros_like(F)):
        raise AssertionError(f"cholesky_batched {what}: nonzero entries "
                             "above the diagonal")
    bad = (~torch.isfinite(F).all(-1).all(-1)).nonzero().flatten().tolist()
    low = torch.tril(torch.ones_like(F[0], dtype=torch.bool))
    for b in bad:
        if not bool(torch.isnan(F[b][low]).all()):
            raise AssertionError(f"cholesky_batched {what}: entry {b}'s "
                                 "lower triangle is not all NaN")
    return bad


def compare_kernels(dev):
    """Phase 4: kernel vs plain at the main path's n for several B."""
    out = {}
    for B in (1, MAIN_B, 130, BIG_N):
        Hs, r1, r2 = ipm_like_system(B, N_QP, seed=B)
        H64 = torch.as_tensor(Hs, device=dev)
        R1d = torch.as_tensor(r1, device=dev)
        R2d = torch.as_tensor(r2, device=dev)
        L64, x64 = chol.chol_factor_solve_plain(H64, R1d)
        y64 = chol.chol_resolve_plain(L64, R2d)
        H, R1, R2 = H64.float(), R1d.float(), R2d.float()
        Lp, xp = chol.chol_factor_solve_plain(H, R1)
        yp = chol.chol_resolve_plain(Lp, R2)
        Lk, xk = chol.chol_factor_solve(H, R1)
        yk = chol.chol_resolve(Lk, R2)
        xr = chol.chol_resolve(Lk, R1)
        torch.cuda.synchronize()
        # one warp a matrix on factor_solve's own solve: the same L and
        # right-hand side give factor_solve's x, bit for bit
        if not torch.equal(xr, xk):
            raise AssertionError(f"resolve B={B}: resolve(L, rhs) differs "
                                 "from factor_solve's x in "
                                 f"{int((xr != xk).sum())} entries")
        errs = {}
        for name, got, plain, ref in (("factor_solve", xk, xp, x64),
                                      ("resolve", yk, yp, y64)):
            e_k = (got.double() - ref).abs().max().item()
            e_p = (plain.double() - ref).abs().max().item()
            if not e_k <= 4 * e_p + 1e-6:
                raise AssertionError(f"{name} B={B}: kernel error {e_k} > "
                                     f"4 x plain f32 error {e_p} + 1e-6")
            errs[name] = (e_k, e_p)
        # the factor alone, held to the f64 factor as the plain f32 one is
        Fk = chol.cholesky_batched(H)
        Fp = chol.cholesky_batched_plain(H)
        torch.cuda.synchronize()
        e_k = (Fk.double() - L64).abs().max().item()
        e_p = (Fp.double() - L64).abs().max().item()
        if not e_k <= 4 * e_p + 1e-6:
            raise AssertionError(f"cholesky_batched B={B}: kernel error "
                                 f"{e_k} > 4 x plain f32 error {e_p} + 1e-6")
        if check_factor_alone(H, R1, f"B={B}"):
            raise AssertionError(f"cholesky_batched B={B}: non-finite "
                                 "entries on SPD input")
        Hbad = H.clone()
        Hbad[B // 2, 7, 7] = -1.0
        bad = check_factor_alone(Hbad, R1, f"B={B}, non-SPD entry {B // 2}")
        if bad != [B // 2]:
            raise AssertionError(f"cholesky_batched B={B}: non-finite "
                                 f"entries {bad}, expected [{B // 2}]")
        errs["factor"] = (e_k, e_p)
        R2c = R2[..., None]
        t = {
            "factor_solve": (median_ms(lambda: chol.chol_factor_solve(H, R1)),
                             median_ms(lambda: chol.chol_factor_solve_plain(
                                 H, R1)), None),
            "resolve": (median_ms(lambda: chol.chol_resolve(Lk, R2)),
                        median_ms(lambda: chol.chol_resolve_plain(Lk, R2)),
                        median_ms(lambda: torch.cholesky_solve(R2c, Lk))),
            "factor": (median_ms(lambda: chol.cholesky_batched(H)),
                       median_ms(lambda: chol.cholesky_batched_plain(H)),
                       median_ms(lambda: torch.linalg.cholesky_ex(H))),
        }
        out[B] = (errs, t)
        phase("4 kernels",
              f"B={B} n={N_QP}: factor_solve err {errs['factor_solve'][0]:.3e}"
              f" (plain f32 {errs['factor_solve'][1]:.3e}) "
              f"{t['factor_solve'][0]:.4f} ms vs plain "
              f"{t['factor_solve'][1]:.4f} ms; resolve err "
              f"{errs['resolve'][0]:.3e} (plain f32 {errs['resolve'][1]:.3e})"
              f", bit-equal to factor_solve's x, "
              f"{t['resolve'][0]:.4f} ms vs plain {t['resolve'][1]:.4f} ms, "
              f"cholesky_solve {t['resolve'][2]:.4f} ms; cholesky_batched "
              f"err {errs['factor'][0]:.3e} (plain f32 "
              f"{errs['factor'][1]:.3e}), bit-equal to factor_solve's L "
              f"(and with non-SPD entry {B // 2}: NaN there only), "
              f"{t['factor'][0]:.4f} ms vs plain "
              f"{t['factor'][1]:.4f} ms, cholesky_ex {t['factor'][2]:.4f} ms")

    # a non-SPD instance turns into NaN in its own entry only
    Hs, r1, r2 = ipm_like_system(MAIN_B, N_QP, seed=7)
    Hs[5, 7, 7] = -1.0
    H = torch.as_tensor(Hs, device=dev, dtype=torch.float32)
    L, x = chol.chol_factor_solve(H, torch.as_tensor(r1, device=dev,
                                                     dtype=torch.float32))
    y = chol.chol_resolve(L, torch.as_tensor(r2, device=dev,
                                             dtype=torch.float32))
    for name, v in (("factor_solve", x), ("resolve", y)):
        bad = (~torch.isfinite(v).all(-1)).nonzero().flatten().tolist()
        if bad != [5]:
            raise AssertionError(f"{name}: non-finite entries {bad}, "
                                 "expected [5]")
    phase("4 kernels", "non-SPD entry 5 of 64 -> NaN in entry 5 only")
    return out


def big_spd_system(B, n, seed, dev):
    """ipm_like_system at a large n, built on the card in f64 (numpy's
    three-operand einsum would take minutes): (Hs, r1, r2)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    A = torch.randn(B, 3 * n, n, generator=g, device=dev,
                    dtype=torch.float64)
    d = torch.exp(torch.empty(B, 3 * n, device=dev, dtype=torch.float64
                              ).uniform_(-math.log(1e3), math.log(1e3),
                                         generator=g))
    H = torch.eye(n, device=dev, dtype=torch.float64) + \
        A.mT @ (A * d[..., None])
    dsc = torch.rsqrt(torch.diagonal(H, dim1=-2, dim2=-1))
    r = torch.randn(2, B, n, generator=g, device=dev, dtype=torch.float64)
    return H * dsc[:, :, None] * dsc[:, None, :], r[0], r[1]


def backward_error(H, L, x, r):
    """Per-kernel backward errors in f64: max over the batch of
    ||H x - r|| / (||H|| ||x|| + ||r||) (inf norms) for a solve, and
    ||L L' - H|| / ||H|| for the factor."""
    Hn = H.abs().sum(-1).amax(-1)
    if x is None:
        return ((L @ L.mT - H).abs().sum(-1).amax(-1) / Hn).max().item()
    res = (H @ x[..., None])[..., 0] - r
    return (res.abs().amax(-1) / (Hn * x.abs().amax(-1) +
                                  r.abs().amax(-1))).max().item()


def check_large_chol(what, H64, R1d, R2d, dtype, time_it=False,
                     backward=False):
    """The large-n chol kernels (the design chol.large_design picks) on one
    system in dtype, each held to the f64 solve as its plain version in
    dtype is
    (f32: within 4x its error + 1e-6; f64: 1e-9 relative to the solution's
    size), resolve(L, rhs) bit-equal to factor_solve's x, the factor
    alone bit-equal to factor_solve's L (zeros above the diagonal), and,
    for B > 1, a non-SPD entry NaN there only.  With backward (the
    main path's own, ill-conditioned KKT systems, whose f32 solutions
    are O(1) off the f64 ones for both versions) the errors are backward
    errors (backward_error), the kernel's within 4x the plain version's
    + n 2^-24.  Returns (the kernel's error per kernel, and with time_it
    kernel / plain / library ms)."""
    B, n = H64.shape[0], H64.shape[-1]
    before = launch_counts()
    L64, x64 = chol.chol_factor_solve_plain(H64, R1d)
    y64 = chol.chol_resolve_plain(L64, R2d)
    H, R1, R2 = H64.to(dtype), R1d.to(dtype), R2d.to(dtype)
    Lk, xk = chol.chol_factor_solve(H, R1)
    yk = chol.chol_resolve(Lk, R2)
    xr = chol.chol_resolve(Lk, R1)
    Fk = chol.cholesky_batched(H)
    torch.cuda.synchronize()
    sfx = {"cluster": "_cluster", "tiled": "_tiled"}[
        chol.large_design(n, dtype)]
    moved = {k: v - before[k] for k, v in launch_counts().items()
             if v != before[k]}
    if moved != {"factor_solve" + sfx: 1, "resolve" + sfx: 2,
                 "cholesky_batched" + sfx: 1}:
        raise AssertionError(f"{what}: launches {moved}")
    if not torch.equal(xr, xk):
        raise AssertionError(f"{what}: resolve(L, rhs) differs from "
                             f"factor_solve's x in {int((xr != xk).sum())} "
                             "entries")
    if not torch.equal(bits(Fk), bits(Lk)) or \
            not torch.equal(torch.triu(Lk, 1), torch.zeros_like(Lk)):
        raise AssertionError(f"{what}: the factor alone is not "
                             "factor_solve's L, or L has entries above "
                             "the diagonal")
    Lp, xp = chol.chol_factor_solve_plain(H, R1)
    yp = chol.chol_resolve_plain(Lp, R2)
    errs = {}
    for name, got, plain, ref in (("factor_solve", xk, xp, x64),
                                  ("resolve", yk, yp, y64),
                                  ("factor", Fk, Lp, L64)):
        if backward:
            r = R1d if name == "factor_solve" else R2d
            L_k, L_p = (Lk, Lp) if name == "resolve" else (None, None)
            if name == "factor":
                e_k = backward_error(H64, got.double(), None, None)
                e_p = backward_error(H64, plain.double(), None, None)
            else:
                e_k = backward_error(H64, L_k, got.double(), r)
                e_p = backward_error(H64, L_p, plain.double(), r)
            lim = 4 * e_p + n * (2.0 ** -24 if dtype == torch.float32
                                 else 2.0 ** -53)
        else:
            e_k = (got.double() - ref).abs().max().item()
            e_p = (plain.double() - ref).abs().max().item()
            lim = (4 * e_p + 1e-6 if dtype == torch.float32 else
                   1e-9 * max(1.0, ref.abs().max().item()))
        if not e_k <= lim:
            raise AssertionError(f"{what} {name}: kernel error {e_k} > "
                                 f"{lim} (plain {e_p})")
        errs[name] = e_k
    if B > 1:
        Hb = H.clone()
        Hb[B // 2, 7, 7] = -1.0
        Lb, xb = chol.chol_factor_solve(Hb, R1)
        yb = chol.chol_resolve(Lb, R2)
        torch.cuda.synchronize()
        for v in (xb, yb, Lb.flatten(1)):
            bad = (~torch.isfinite(v).all(-1)).nonzero().flatten().tolist()
            if bad != [B // 2]:
                raise AssertionError(f"{what}: non-SPD entry {B // 2} -> "
                                     f"non-finite entries {bad}")
        if check_factor_alone(Hb, R1, what) != [B // 2]:
            raise AssertionError(f"{what}: the factor alone's NaN entries")
    times = None
    if time_it:
        R2c = R2[..., None]
        times = {
            "factor_solve": (
                median_ms(lambda: chol.chol_factor_solve(H, R1), reps=20),
                median_ms(lambda: chol.chol_factor_solve_plain(H, R1),
                          reps=20),
                median_ms(lambda: torch.cholesky_solve(
                    R2c, torch.linalg.cholesky_ex(H)[0]), reps=20)),
            "resolve": (
                median_ms(lambda: chol.chol_resolve(Lk, R2), reps=20),
                median_ms(lambda: chol.chol_resolve_plain(Lk, R2), reps=20),
                median_ms(lambda: torch.cholesky_solve(R2c, Lk), reps=20)),
            "factor": (
                median_ms(lambda: chol.cholesky_batched(H), reps=20),
                median_ms(lambda: chol.cholesky_batched_plain(H), reps=20),
                median_ms(lambda: torch.linalg.cholesky_ex(H), reps=20)),
        }
    return errs, times


def design_name(n, dtype):
    """The large-n design at n in dtype, with its cluster size."""
    plan = chol.large_plan(n, dtype)
    return f"cluster of {plan[0]}" if plan else "tiled"


def compare_large_chol(dev):
    """Phase 4, large n: the large-n chol kernels on IPM-like systems at n
    in LARGE_NS and B in {1, 64, 130}, f32 and f64 (n = 1024 at B in {1,
    130})."""
    for n in LARGE_NS:
        for B in ((1, 130) if n == 1024 else (1, MAIN_B, 130)):
            H64, R1d, R2d = big_spd_system(B, n, n + B, dev)
            errs = [check_large_chol(f"large-n B={B} n={n} {dtype}", H64,
                                     R1d, R2d, dtype)[0]
                    for dtype in (torch.float32, torch.float64)]
            phase("4 kernels", f"large n: B={B} n={n} (f32 "
                               f"{design_name(n, torch.float32)}, f64 "
                               f"{design_name(n, torch.float64)}): held to "
                               "the f64 solve"
                               " (factor_solve / resolve / factor alone "
                               "errors f32 " + " / ".join(
                                   f"{e:.2e}" for e in errs[0].values()) +
                               ", f64 " + " / ".join(
                                   f"{e:.2e}" for e in errs[1].values()) +
                               "), resolve bit-equal to factor_solve's x, "
                               "the factor alone to its L" +
                               (f", non-SPD entry {B // 2}: NaN there only"
                                if B > 1 else ""))


def capture_chol_calls(sim, cycles_before):
    """The inputs of the first factor_solve and resolve calls of one cycle
    of sim after cycles_before cycles: ((H, rhs), (L, rhs))."""
    state = sim.initial_state()
    for _ in range(cycles_before):
        state, _ = sim.cycle(state)
    seen = {}
    fs, rs = chol.chol_factor_solve, chol.chol_resolve

    def record(name, fn):
        def call(a, b):
            seen.setdefault(name, (a.clone(), b.clone()))
            return fn(a, b)
        return call
    chol.chol_factor_solve = record("fs", fs)
    chol.chol_resolve = record("rs", rs)
    try:
        sim.cycle(state)
    finally:
        chol.chol_factor_solve, chol.chol_resolve = fs, rs
    return seen["fs"], seen["rs"]


# measurement builds of csrc/chol.cu, apart from the package's library:
# the first design past the clusters (one block a matrix, up to n = 1024)
# at every large n, clusters of up to 8 blocks where they hold the factor
# (the package's plan takes 1 or 2; the tiled design past them), and the
# tiled design at every large n
CHOL_BUILDS = {"one block": ("LSC_CHOL_MAX_G=0", "LSC_CHOL_ONE_BLOCK"),
               "clusters up to 8": ("LSC_CHOL_MAX_G=8",),
               "tiled": ("LSC_CHOL_MAX_G=0",)}


def chol_builds_start():
    """Starts the CHOL_BUILDS in threads beside the package's own build
    (phase 4 times them beside the plan's design).  Returns {name: future
    of (library, nvcc's output)}."""
    pool = ThreadPoolExecutor(len(CHOL_BUILDS))
    futures = {name: pool.submit(_build.load_variant, ["chol.cu"], list(d))
               for name, d in CHOL_BUILDS.items()}
    pool.shutdown(wait=False)
    return futures


def build_chol_ms(lib, H, R1, R2):
    """{kind: ms} (CUDA events, median of 20) of the large-n kernels of
    lib (a CHOL_BUILDS library) on H, R1 and R2: factor_solve, resolve of
    its L, and the factor alone; raises on a failed launch or a
    non-finite x.  The tiled design's workspace goes to every build (the
    others do not read it)."""
    B, n = R1.shape
    sfx = "f32" if H.dtype == torch.float32 else "f64"
    L, x = torch.empty_like(H), torch.empty_like(R1)
    work = torch.empty(chol.tiled_work_ints(n, B), dtype=torch.int32,
                       device=H.device)
    args = {"factor_solve": (H, R1, L, x, work), "resolve": (L, R2, x),
            "factor": (H, L, work)}
    out = {}
    for kind, ts in args.items():
        entry = getattr(lib, f"lsc_chol_{kind}_{sfx}")

        def call(entry=entry, ts=ts):
            return _build.launch(entry, H.device,
                                 *(t.data_ptr() for t in ts), B, n)
        if call():
            raise RuntimeError(f"chol build: {kind} launch failed")
        out[kind] = median_ms(call, reps=20)
        if kind != "factor" and not torch.isfinite(x).all():
            raise AssertionError(f"chol build: {kind} non-finite x")
    return out


def time_large_case(what, H64, R1d, R2d, dtype, libs, backward):
    """check_large_chol with times on one system (the f64 H64, R1d, R2d
    taken to dtype), beside the first design past the clusters (the
    one-block kernels of libs["one block"], where n <= 1024) and the
    bound; prints a line.  Returns (errors, kernel / plain / library
    ms)."""
    B, n = R1d.shape
    errs, times = check_large_chol(what, H64, R1d, R2d, dtype, time_it=True,
                                   backward=backward)
    H, R1, R2 = H64.to(dtype), R1d.to(dtype), R2d.to(dtype)
    one = (build_chol_ms(libs["one block"], H, R1, R2)
           if n <= chol.CLUSTER_MAX_N else None)
    elem = H.element_size()

    def line(k, t):
        b_ms, b_by = chol_bound(k, B, n, elem)
        return (f"{k} {'backward ' if backward else ''}err {errs[k]:.3e}, "
                f"{t[0]:.4f} ms vs plain {t[1]:.4f} ms, library "
                f"{t[2]:.4f} ms" +
                (f", the one-block kernel {one[k]:.4f} ms" if one else
                 "") + f", bound {b_ms:.4f} ms ({b_by})")
    phase("4 kernels", f"{what} (B={B}, n={n}, {str(dtype)[6:]}, "
                       f"{design_name(n, dtype)}): " +
          "; ".join(line(k, t) for k, t in times.items()) +
          f" [{smi_line()}]")
    return errs, times


# phase 4's main-path systems: the first factor_solve and resolve inputs of
# a mission's fourth cycle, (key, MODE_CASES name, dtype)
LARGE_MISSION_SYSTEMS = (("cluster", "rsfc64", torch.float32),
                         ("tiled", "rsfc96", torch.float32),
                         ("tiled f64", "rsfc64", torch.float64))


def time_large_chol(dev, libs):
    """Phase 4 on the main path's own large-n systems: the chol kernels on
    the first factor_solve and resolve inputs of the fourth cycle of
    rsfc64 (B = 64, n = nv + C M = 45 + 64 x 5 = 365, f32: the cluster
    kernels), rsfc96 (B = 96, n = 45 + 96 x 5 = 525, f32: the tiled
    design) and rsfc64 in f64 (n = 365: the tiled design), each held to
    the plain version by backward error and timed beside the first design
    past the clusters (libs["one block"], chol_builds_start) and the
    bound (time_large_case); on an IPM-like system of each shape, held to
    the f64 solve; the designs timed side by side (time_designs); the
    tiled design at B = 64, n = 1024 (f32, IPM-like) against the library
    and the first design; and past that design's cap (past_the_cap).
    Returns {key: ((B, n), the IPM-like system's errors, the mission
    system's kernel / plain / library ms)} for the keys of
    LARGE_MISSION_SYSTEMS."""
    out = {}
    for key, name, dtype in LARGE_MISSION_SYSTEMS:
        tm, kw, _ = mode_case(name)
        sim = SyncSimulator(tm, Param(**kw), device=dev, dtype=dtype)
        (H, R1), (L, R2) = capture_chol_calls(sim, 3)
        B, n = H.shape[0], H.shape[-1]
        _, times = time_large_case(f"{name} cycle 4", H.double(),
                                   R1.double(), R2.double(), dtype, libs,
                                   backward=True)
        errs, _ = check_large_chol(f"IPM-like B={B} n={n}",
                                   *big_spd_system(B, n, n, dev), dtype)
        phase("4 kernels", f"IPM-like B={B} n={n} {str(dtype)[6:]}: held to "
                           "the f64 solve, errors " + ", ".join(
                               f"{k} {e:.3e}" for k, e in errs.items()))
        out[key] = ((B, n), errs, times)
    time_designs(dev, libs)
    nb = chol.CLUSTER_MAX_N
    time_large_case("IPM-like", *big_spd_system(MAIN_B, nb, nb, dev),
                    torch.float32, libs, backward=False)
    past_the_cap(dev, libs)
    return out


def past_the_cap(dev, libs):
    """Phase 4 past the first design's cap of n = 1024 (it raised there):
    the tiled design at PAST_CAP_CASES on IPM-like systems, held to the
    plain version by backward error, timed (time_large_case)."""
    for dtype, n, batches in PAST_CAP_CASES:
        for B in batches:
            time_large_case("past n = 1024", *big_spd_system(B, n, n + B, dev),
                            dtype, libs, backward=True)


def time_designs(dev, libs):
    """Phase 4: the plan's large-n design and the CHOL_BUILDS (the first
    design past the clusters, clusters of up to 8 blocks, the tiled design
    at every n; libs, chol_builds_start) at B = 64 on IPM-like systems at
    DESIGN_CASES, each ms a median of 20 (the measurement behind the
    plan's cluster sizes and its boundary)."""
    for dtype, n in DESIGN_CASES:
        H, R1, R2 = (t.to(dtype)
                     for t in big_spd_system(MAIN_B, n, n, dev))
        L = chol.chol_factor_solve(H, R1)[0]
        plan = {"factor_solve": median_ms(
                    lambda: chol.chol_factor_solve(H, R1), reps=20),
                "resolve": median_ms(lambda: chol.chol_resolve(L, R2),
                                     reps=20),
                "factor": median_ms(lambda: chol.cholesky_batched(H),
                                    reps=20)}
        other = {name: build_chol_ms(lib, H, R1, R2)
                 for name, lib in libs.items()}
        phase("4 kernels", f"{str(dtype)[6:]} B={MAIN_B} n={n}: the plan's "
                           f"design ({design_name(n, dtype)}) / " +
              " / ".join(other) + ": " + "; ".join(
                  f"{k} {plan[k]:.4f} / " +
                  " / ".join(f"{o[k]:.4f}" for o in other.values()) + " ms"
                  for k in plan))


def cycle_parity(dev):
    """Three f64 cycles of an 8-agent circle: the card (f64 kernels) must
    reproduce the CPU run (plain versions) to 1e-6 m."""
    mission = make_circle_mission(8, radius=3.0, world=(-5, -5, 0, 5, 5, 2.5))
    p = Param(goal_mode=GoalMode.PRIOR_BASED)
    runs = []
    for device in (dev, torch.device("cpu")):
        sim = SyncSimulator(mission, p, device=device, dtype=torch.float64)
        state = sim.initial_state()
        for _ in range(3):
            state, _ = sim.cycle(state)
        runs.append(state_to_numpy(state)["traj"])
    err = float(np.abs(runs[0] - runs[1]).max())
    if not err <= 1e-6:
        raise AssertionError(f"8-agent f64 cycles: card vs CPU traj "
                             f"{err} m > 1e-6 m")
    phase("4 kernels", f"8-agent circle, 3 f64 cycles: card vs CPU traj max "
                       f"abs {err:.3e} m (limit 1e-6)")


def capture_fused_call(sim, cycles_before):
    """The inputs of the fused IPM call of one cycle of sim: the main
    path's own QPs, after cycles_before cycles from the initial state.
    Returns (args, kwargs) of that ipm.ipm_lsc_fused call."""
    state = sim.initial_state()
    for _ in range(cycles_before):
        state, _ = sim.cycle(state)
    seen = []
    launch = ipm.ipm_lsc_fused

    def record(*args, **kw):
        seen.append(([a.clone() for a in args], dict(kw)))
        return launch(*args, **kw)
    ipm.ipm_lsc_fused = record
    try:
        sim.cycle(state)
    finally:
        ipm.ipm_lsc_fused = launch
    if len(seen) != 1:
        raise AssertionError(f"{len(seen)} fused IPM calls in one cycle")
    return seen[0]


def block_of_call(call, L):
    """A captured fused IPM call cut to its first L QPs (every input with
    the batch as its leading dimension): the QPs that rank 0's block of a
    sharded run hands the kernel, where the sharded trajectories equal the
    single process's (phase 17b prints the difference)."""
    args, kw = call
    B = args[1].shape[0]
    return [a[:L].clone() if a.dim() and a.shape[0] == B else a
            for a in args], kw


def fused_obj_primal(args, y):
    """Objective 0.5 y'Py + q'y and max row violation at y, float64."""
    P_blk, q, _, U, b_pairs, nsc, scale, b_pl, F_seg, _ = args
    y3 = y.double().reshape(y.shape[0], U.shape[0], -1)
    obj = 0.5 * torch.einsum("nkf,nfg,nkg->n", y3, P_blk, y3) + \
        (q * y.double()).sum(-1)
    su = torch.einsum("kuf,nkf->nku", U, y3).reshape(y.shape[0], -1)
    x = torch.einsum("mif,nkf->nkmi", F_seg, y3)
    pl = torch.einsum("ncmk,nkmi->ncmi", nsc, x) * scale
    viol = torch.cat([b_pairs[:, 0] - su, b_pairs[:, 1] + su,
                      (b_pl - pl).reshape(y.shape[0], -1)], dim=1)
    return obj, torch.clamp(viol.amax(-1), min=0.0)


def compare_fused(calls):
    """Phase 6: the fused kernel against its plain version in f32, both
    held to an f64 plain run, on captured main-path calls: B = 1024, C = 32
    (circle1024), B = 64, C = 64 (circle64 under qp_fused_mode="on") and
    B = 128, C = 128 (circle128 at Param's all-pairs default).
    The kernel is held to what f32 rounding does to the plain version: its
    y error and (at Param's tolerances, a solution rather than a third
    iterate) its objective error within 4x the plain f32 ones (+ 1e-4 m,
    + 1e-3 of the objective scale), its mean tile iteration count no
    farther from the f64 one than the plain f32 count is (or 1), and at
    Param's tolerances a primal residual < 1e-4.
    Returns {(B, C, ndim): (y error, kernel ms, plain ms, bound)} at
    Param's tolerances."""
    main, failed = {}, []
    for a32, prod in calls:
        a64 = [a.double() for a in a32]
        B, C, D = a32[5].shape[0], a32[5].shape[1], a32[5].shape[-1]
        for case, kw in (("off3", dict(prod, **OFF3)), ("param", prod)):
            ref = ipm.ipm_lsc_fused_plain(*a64, **kw)
            plain = ipm.ipm_lsc_fused_plain(*a32, **kw)
            got = ipm.ipm_lsc_fused(*a32, **kw)
            torch.cuda.synchronize()
            e_k = (got[0].double() - ref[0]).abs().max().item()
            e_p = (plain[0].double() - ref[0]).abs().max().item()
            obj_k, pr_k = fused_obj_primal(a64, got[0])
            obj_p, pr_p = fused_obj_primal(a64, plain[0])
            obj_r, pr_r = fused_obj_primal(a64, ref[0])
            obj_scale = obj_r.abs().max().item()
            o_k = (obj_k - obj_r).abs().max().item() / obj_scale
            o_p = (obj_p - obj_r).abs().max().item() / obj_scale
            pr_k, pr_p, pr_r = (x.max().item() for x in (pr_k, pr_p, pr_r))
            its = [x[4].double().mean().item() for x in (got, plain, ref)]
            it_ok = abs(its[0] - its[2]) <= max(1.0, abs(its[1] - its[2]))
            t_k = median_ms(lambda: ipm.ipm_lsc_fused(*a32, **kw), reps=20)
            t_p = median_ms(lambda: ipm.ipm_lsc_fused_plain(*a32, **kw),
                            reps=20)
            phase("6 fused", f"B={B} C={C} ndim={D} {case}: y err "
                             f"{e_k:.3e} (plain "
                             f"f32 {e_p:.3e}); objective err {o_k:.2e} of "
                             f"scale {obj_scale:.4g} (plain f32 {o_p:.2e}); "
                             f"primal {pr_k:.2e} (plain f32 {pr_p:.2e}, f64 "
                             f"{pr_r:.2e}); mean tile iterations "
                             f"{its[0]:.2f} (plain f32 {its[1]:.2f}, f64 "
                             f"{its[2]:.2f}); "
                             f"{t_k:.4f} ms vs plain {t_p:.4f} ms")
            checks = {
                "y error within 4x plain f32 + 1e-4": e_k <= 4 * e_p + 1e-4,
                "finite": all(bool(torch.isfinite(t).all())
                              for t in got[:4]),
                "tile iteration counts": it_ok,
            }
            if case == "param":
                checks["objective error within 4x plain f32 + 1e-3"] = \
                    o_k <= 4 * o_p + 1e-3
                checks["primal residual < 1e-4"] = pr_k < 1e-4
            failed += [f"B={B} C={C} {case}: {what}"
                       for what, ok in checks.items() if not ok]
            if case == "param":
                # the same call with the rows in the other layout
                nf, Ru = a32[0].shape[-1], a32[3].shape[1]
                M, n1 = a32[5].shape[2], a32[6].shape[-1]
                plan = ipm.fused_plan(B, nf, Ru, C, M, n1, ndim=D)
                other = "global" if plan["rows_in_smem"] else "smem"
                alt = ipm.fused_plan(B, nf, Ru, C, M, n1, other, ndim=D)
                # the captured call passes every keyword _fused_cuda takes
                t_o = median_ms(lambda: ipm._fused_cuda(
                    *a32, **kw, rows=other), reps=20)
                where = "shared" if plan["rows_in_smem"] else "device"
                phase("6 fused", f"B={B} C={C} param: rows in {where} "
                                 f"memory, {plan['qps_an_sm']} QPs an SM; "
                                 f"forced into {other} memory "
                                 f"({alt['qps_an_sm']} QPs an SM): "
                                 f"{t_o:.4f} ms")
            if case == "param":
                main[(B, C, D)] = (e_k, t_k, t_p, fused_bound(a32, kw))
    if failed:
        raise AssertionError("fused kernel: " + "; ".join(failed))
    return main


def fused_bound(args, kw):
    """The bound of one fused IPM call: its inputs read once and outputs
    written once, against the f32 operations of the iterations these QPs
    ran (each QP's own count, from the kernel).  An iteration's operations
    are those of the factored rows (a multiply-add counts 2): the plane
    Gram through its per-segment weights W (D (D + 1) / 2 dimension pairs
    x R rows, D the dimension) and F_seg' W F_seg on the symmetric
    blocks, the static rows' symmetric
    Gram, the factor (nv^3 / 3), and for each of its 2 + correctors KKT
    solves and the exit test the two row products and (KKT only) the two
    triangular substitutions (nv^2 each).  Elementwise work is left out."""
    P_blk, U, F_seg = args[0], args[3], args[8]
    C = args[5].shape[1]
    nf, D, Ru = P_blk.shape[-1], U.shape[0], U.shape[1]
    nv, MI = D * nf, F_seg.shape[0] * F_seg.shape[1]
    R, S = C * MI, D * Ru
    pairs = D * (D + 1) // 2            # the Gram's dimension pairs
    sym, full = nf * (nf + 1) / 2, nf * nf
    gram = (4 * pairs * R + 2 * MI * (D * sym + (pairs - D) * full) +
            2 * Ru * D * sym)
    rows = (2 * D * MI * nf + 2 * D * R + 2 * S * nf +      # A v
            2 * D * MI * C + 2 * nv * (Ru + MI))            # A' w
    kkts = 2 + kw.get("correctors", 0)
    per_iter = gram + nv ** 3 / 3 + kkts * (rows + 2 * nv * nv) + rows
    out = ipm.ipm_lsc_fused(*args, **kw, qp_counts=True)
    ops = per_iter * out[4].double().sum().item()
    return bound(tensor_bytes(*args) + tensor_bytes(*out), ops)


def fly_circle64_fused(sim):
    """Phase 7: circle64 with every cycle's QP through the fused kernel."""
    param = sim.param
    reset_launch_counts()
    summary = sim.run()
    torch.cuda.synchronize()
    cycles = summary["iterations"]
    check_mission(summary, param, MAIN_B, "circle64 fused")
    check_launches("circle64 fused", fused_ipm=cycles, lsc_planes=cycles)
    ms_cycle = summary["wall_time"] / cycles * 1e3
    phase("7 circle64 fused", f"finished in {cycles} cycles (JAX CPU f32 "
                              f"XLA path: {JAX_CPU_F32_CYCLES}; the port's "
                              f"chol path: {PORT_CHOL_CYCLES}), safety "
                              f"{summary['safety_ratio_agent']:.4f}, 0 "
                              f"QPFAILED, {ms_cycle:.2f} ms/cycle, {cycles} "
                              "fused launches")


def fly_circle1024(sim):
    """Phase 8: BIG_CYCLES cycles of circle1024 (K = 32, "auto", so the
    fused kernel).  Returns the fused kernel's launch count."""
    state = sim.initial_state()
    reset_launch_counts()
    stats, times = [], []
    t_wall = time.perf_counter()
    for _ in range(BIG_CYCLES):
        t0 = time.perf_counter()
        state, info = sim.cycle(state)
        # one device->host read per cycle
        stats.append(torch.stack([
            info.safety_step_min.double(), info.qp_failed.sum().double(),
            info.knn_overflow.sum().double(),
            info.qp_iters.double().mean()]).tolist())
        times.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_wall
    launches = check_launches("circle1024", fused_ipm=BIG_CYCLES,
                              lsc_planes=BIG_CYCLES)
    safety, failed, overflow, iters = (np.asarray(s) for s in zip(*stats))
    dist = float(state.distance)
    if not safety.min() >= 1.0:
        raise AssertionError(f"circle1024: collision, safety {safety.min()}")
    if failed.sum():
        raise AssertionError(f"circle1024: {int(failed.sum())} QPFAILED")
    if not bool(torch.isfinite(state.pos).all()):
        raise AssertionError("circle1024: non-finite positions")
    rel = abs(dist - JAX_CPU_F32_DIST_1024) / JAX_CPU_F32_DIST_1024
    if not rel <= 0.10:
        raise AssertionError(f"circle1024: distance flown {dist} m, "
                             f"{100 * rel:.1f} % off the JAX CPU f32 run's "
                             f"{JAX_CPU_F32_DIST_1024} m (limit 10 %)")
    phase("8 circle1024", f"K={BIG_K}, {BIG_CYCLES} cycles through the fused "
                          f"kernel: min safety {safety.min():.4f}, 0 QPFAILED,"
                          f" distance {dist:.2f} m (JAX CPU f32 "
                          f"{JAX_CPU_F32_DIST_1024:.2f} m, {100 * rel:.2f} % "
                          f"off), {wall / BIG_CYCLES * 1e3:.2f} ms/cycle "
                          f"(run wall / cycles; "
                          f"{1e3 * statistics.mean(times[1:]):.2f} ms mean "
                          f"after the first), mean tile iterations "
                          f"{iters.mean():.2f}, max K-NN overflow "
                          f"{int(overflow.max())} (JAX CPU f32: "
                          f"{JAX_CPU_F32_KNN_OVERFLOW_MAX})")
    st = stage_times(sim, [(sim.goal_planner, "plan", "goal rule"),
                           (sim_mod, "knn_select", "knn_select"),
                           (constraints, "lsc_planes", "lsc_planes"),
                           (sim.optimizer, "solve", "optimizer.solve"),
                           (ipm, "ipm_lsc_fused", "fused IPM call")])
    phase("8 circle1024", "stage ms (median of 5 cycles after 20, a sync "
                          "around each): " +
          ", ".join(f"{k} {v:.2f}" for k, v in st.items()))
    run = {"iterations": BIG_CYCLES, "total_flight_distance": dist,
           "wall_time": wall,
           "average_planning_time": statistics.mean(times[1:])}
    return launches["fused_ipm"], run


def capture_wavefront_calls(sim, cycles_before):
    """The inputs (occ_zyx, goal_zyx, max_iters) of the wavefront launches
    of one cycle of sim after cycles_before cycles: the main path's own
    grids (priority occupancy, then static)."""
    state = sim.initial_state()
    for _ in range(cycles_before):
        state, _ = sim.cycle(state)
    seen = []
    launch = wavefront.wavefront_batched_steps

    def record(occ, goal, max_iters=512):
        seen.append((occ.clone(), goal.clone(), max_iters))
        return launch(occ, goal, max_iters)
    wavefront.wavefront_batched_steps = record
    try:
        sim.cycle(state)
    finally:
        wavefront.wavefront_batched_steps = launch
    if len(seen) != 2:
        raise AssertionError(f"{len(seen)} wavefront calls in one cycle, "
                             "expected 2")
    return seen


def random_wavefront_case(dev, shape, seed, fill=0.2):
    """Random occupancy with unreachable cells; agent 0's goal occupied."""
    rng = np.random.default_rng(seed)
    N, Z, Y, X = shape
    occ = (rng.uniform(size=shape) < fill).astype(np.float32)
    goal = np.stack([rng.integers(0, Z, N), rng.integers(0, Y, N),
                     rng.integers(0, X, N)], -1).astype(np.int32)
    occ[0, goal[0, 0], goal[0, 1], goal[0, 2]] = 1.0
    return (torch.as_tensor(occ, device=dev),
            torch.as_tensor(goal, device=dev))


_forest30 = {}


def forest30_world(dev):
    """(mission, Param, ESDF) of a 20-agent mission in a 30 x 30 x 5 m
    synthetic forest at forest20's density, made once.  The ESDF is made
    at the grid's 0.25 m, not the world's 0.1 m: ESDF.from_boxes merges
    each of the 540 boxes on the host over every cell, minutes at 0.1 m."""
    if dev not in _forest30:
        m = forest_mission(n_trees=FOREST30_TREES, world=FOREST30_WORLD)
        p = Param(goal_mode=GoalMode.PRIOR_BASED)
        boxes = np.stack([np.concatenate([o.pose - o.dimensions,
                                          o.pose + o.dimensions])
                          for o in m.obstacles])
        esdf = ESDF.from_boxes(boxes, m.world_min, m.world_max,
                               resolution=p.grid_resolution, device=dev)
        _forest30[dev] = (m, p, esdf)
    return _forest30[dev]


def forest30_static_grids(dev):
    """The grid planner's static occupancy (N, Z, Y, X) of the 30 m
    forest's 20 agents (forest30_world), the agents' goal cells (z, y, x)
    and the planner's wavefront cap."""
    m, p, esdf = forest30_world(dev)
    grid = GridPlanner(m, p, esdf)
    occ = grid.static_occupancy(float(m.agents[0].radius))
    goal = grid.to_cell(torch.as_tensor(np.array([a.goal for a in m.agents]),
                                        dtype=torch.float32, device=dev))
    occ = occ.permute(2, 1, 0)[None].expand(len(m.agents), -1, -1, -1)
    return (occ.float().contiguous(), goal.flip(-1).contiguous(),
            grid.max_wavefront_iters)


def wavefront_bound(occ, goal, field, steps):
    """The least time of the function on these inputs, whatever computes
    it: the occupancy and goals read once, the field and steps written
    once, and each reached cell relaxed once (its six neighbours + 1 and
    the least of them: 12 operations)."""
    reached = (field < wavefront.BIG).sum().item()
    return bound(tensor_bytes(occ, goal, field, steps), 12.0 * reached)


def compare_wavefront(dev, forest_sim):
    """Phase 9: the wavefront kernel against its plain version, bit for
    bit, step counts included.  Returns the numbers of the forest20
    priority grids (the first launch of a cycle)."""
    calls = capture_wavefront_calls(forest_sim, 3)
    cases = [("forest20 cycle 4, priority", *calls[0]),
             ("forest20 cycle 4, static", *calls[1]),
             ("forest30 static", *forest30_static_grids(dev))]
    for shape, max_iters in (((20, 11, 41, 41), 139), ((3, 5, 21, 21), 70),
                             ((4, 7, 13, 29), 13), ((20, 11, 41, 41), 8),
                             ((4, 9, 23, 70), 200), ((4, 9, 23, 70), 13),
                             ((20, 21, 121, 121), 394),
                             # a 2-D world's grids have one z layer
                             ((20, 1, 41, 41), 139), ((4, 1, 23, 70), 13)):
        occ, goal = random_wavefront_case(dev, shape, sum(shape) + max_iters)
        cases.append((f"random {shape} cap {max_iters}", occ, goal,
                      max_iters))
    main = None
    for name, occ, goal, max_iters in cases:
        want, want_steps = wavefront.wavefront_batched_plain(occ, goal,
                                                             max_iters)
        got, steps = wavefront.wavefront_batched_steps(occ, goal, max_iters)
        torch.cuda.synchronize()
        if not (torch.equal(got, want) and torch.equal(steps, want_steps)):
            diff = (got != want).sum().item()
            raise AssertionError(f"wavefront {name}: kernel differs from "
                                 f"its plain version in {diff} cells, steps "
                                 f"{steps.tolist()} vs "
                                 f"{want_steps.tolist()}")
        cap = -(-max_iters // wavefront.GROUP) * wavefront.GROUP
        t_k = median_ms(lambda: wavefront.wavefront_batched_steps(
            occ, goal, max_iters), reps=20)
        t_p = median_ms(lambda: wavefront.wavefront_batched_plain(
            occ, goal, max_iters), reps=20)
        b_ms, b_by = wavefront_bound(occ, goal, got, steps)
        unreachable = (got >= wavefront.BIG).sum().item() - \
            (occ > 0.5).sum().item()
        phase("9 wavefront", f"{name}: N={occ.shape[0]} grid "
                             f"{tuple(occ.shape[1:])} bit-exact; mean steps "
                             f"{steps.double().mean().item():.1f} (cap "
                             f"{cap}, {int((steps >= cap).sum())} agents "
                             f"capped), unreachable free cells "
                             f"{unreachable}; {t_k:.4f} ms vs plain "
                             f"{t_p:.4f} ms, bound {b_ms:.6f} ms ({b_by})")
        if main is None:
            err = (got - want).abs().max().item()
            main = (err, t_k, t_p, (b_ms, b_by))
    return main


def stage_times(sim, stages, cycles_before=20, timed=5):
    """Median ms of each stage in `timed` cycles after `cycles_before`,
    each call with a sync around it, and of the whole cycle with the stage
    syncs.  stages: (owner, attribute, label) of the callables to time,
    patched for the timed cycles only."""
    state = sim.initial_state()
    for _ in range(cycles_before):
        state, _ = sim.cycle(state)
    times = {label: [] for _, _, label in stages}
    times["cycle"] = []
    orig = [getattr(owner, attr) for owner, attr, _ in stages]

    def timed_fn(fn, key):
        def run(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            times[key].append(1e3 * (time.perf_counter() - t0))
            return out
        return run
    for (owner, attr, label), fn in zip(stages, orig):
        setattr(owner, attr, timed_fn(fn, label))
    try:
        for _ in range(timed):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, _ = sim.cycle(state)
            torch.cuda.synchronize()
            times["cycle"].append(1e3 * (time.perf_counter() - t0))
    finally:
        for (owner, attr, _), fn in zip(stages, orig):
            setattr(owner, attr, fn)
    return {k: statistics.median(v) for k, v in times.items()}


def fly_forest20(dev):
    """Phase 10: forest20 to the finish through run() on the card.
    Returns the launch counts of its run."""
    param = Param(goal_mode=GoalMode.PRIOR_BASED)
    sim = SyncSimulator(forest_mission(), param, device=dev,
                        dtype=torch.float32)
    grid = sim.goal_planner.grid_planner
    occ_share = float(sim.esdf.occ.mean())
    reset_launch_counts()
    summary = sim.run()
    torch.cuda.synchronize()
    cycles = summary["iterations"]
    check_mission(summary, param, FOREST_N, "forest20")
    if not summary["safety_ratio_obs"] >= 1.0:
        raise AssertionError(f"forest20: obstacle safety "
                             f"{summary['safety_ratio_obs']} < 1")
    band = max(0.2 * JAX_CPU_F32_FOREST_CYCLES, 10)
    if not abs(cycles - JAX_CPU_F32_FOREST_CYCLES) <= band:
        raise AssertionError(f"forest20: {cycles} cycles, more than {band} "
                             f"off the JAX CPU f32 run's "
                             f"{JAX_CPU_F32_FOREST_CYCLES}")
    launches = check_launches(
        "forest20", wavefront=2 * cycles,
        factor_solve=cycles * param.qp_iterations,
        resolve=cycles * param.qp_iterations * (1 + param.qp_correctors),
        expand_boxes=cycles, lsc_planes=cycles)
    ms_cycle = summary["wall_time"] / cycles * 1e3
    phase("10 forest20", f"{FOREST_N} agents, {FOREST_TREES} trees "
                         f"({100 * occ_share:.2f} % of the "
                         f"{sim.esdf.occ.shape} ESDF cells occupied), grid "
                         f"{tuple(int(d) for d in grid.dims)}, wavefront cap "
                         f"{grid.max_wavefront_iters}: finished in {cycles} "
                         f"cycles (JAX CPU f32: {JAX_CPU_F32_FOREST_CYCLES}),"
                         f" safety {summary['safety_ratio_agent']:.4f}, "
                         f"obstacle safety {summary['safety_ratio_obs']:.4f},"
                         f" 0 QPFAILED, distance "
                         f"{summary['total_flight_distance']:.3f} m (JAX CPU "
                         f"f32 {JAX_CPU_F32_FOREST_DIST:.3f} m), "
                         f"{ms_cycle:.2f} ms/cycle (run wall / cycles; "
                         f"{1e3 * summary['average_planning_time']:.2f} ms "
                         f"mean after the first), launches {launches}")
    st = stage_times(sim, [(sim.goal_planner, "plan", "goal planning (grid)"),
                           (sim_mod, "update_sfc", "corridor update"),
                           (sim.optimizer, "solve", "QP")])
    phase("10 forest20", "stage ms (median of 5 cycles after 20, a sync "
                         "around each): " +
          ", ".join(f"{k} {v:.2f}" for k, v in st.items()))
    return launches, sim, summary, st


def fly_circle128_factored(dev):
    """The same cycles as phase 11 on the card in f32 through the other IPM
    of the port, the factored one on the chol kernels (qp_fused_mode
    "off"): distance flown."""
    sim = SyncSimulator(circle_mission(ALL_N),
                        Param(goal_mode=GoalMode.PRIOR_BASED,
                              qp_fused_mode="off"), device=dev,
                        dtype=torch.float32)
    state = sim.initial_state()
    for _ in range(ALL_CYCLES):
        state, _ = sim.cycle(state)
    return float(state.distance)


def fly_circle128_all_pairs(sim):
    """Phase 11: ALL_CYCLES cycles of the 128-agent circle at Param's
    all-pairs default (C = 128), "auto", so one fused launch a cycle."""
    state = sim.initial_state()
    reset_launch_counts()
    stats = []
    t_wall = time.perf_counter()
    for _ in range(ALL_CYCLES):
        state, info = sim.cycle(state)
        stats.append(torch.stack([
            info.safety_step_min.double(), info.qp_failed.sum().double(),
            info.qp_iters.double().mean()]).tolist())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_wall
    launches = check_launches("circle128 all pairs", fused_ipm=ALL_CYCLES,
                              lsc_planes=ALL_CYCLES)
    safety, failed, iters = (np.asarray(v) for v in zip(*stats))
    dist = float(state.distance)
    if not safety.min() >= 1.0:
        raise AssertionError(f"circle128 all pairs: collision, safety "
                             f"{safety.min()}")
    if failed.sum():
        raise AssertionError(f"circle128 all pairs: {int(failed.sum())} "
                             "QPFAILED")
    if not bool(torch.isfinite(state.pos).all()):
        raise AssertionError("circle128 all pairs: non-finite positions")
    rel = abs(dist - JAX_CPU_F64_DIST_128) / JAX_CPU_F64_DIST_128
    rel32 = (dist - JAX_CPU_F32_DIST_128) / JAX_CPU_F32_DIST_128
    if not rel <= 0.10:
        raise AssertionError(f"circle128 all pairs: distance flown {dist} m,"
                             f" {100 * rel:.1f} % off the JAX CPU f64 run's "
                             f"{JAX_CPU_F64_DIST_128} m (limit 10 %)")
    dist_f = fly_circle128_factored(state.pos.device)
    rel_f = (dist - dist_f) / dist_f
    phase("11 circle128", f"all pairs (C = {ALL_N}), {ALL_CYCLES} cycles "
                          f"through the fused kernel: min safety "
                          f"{safety.min():.4f}, 0 QPFAILED, distance "
                          f"{dist:.3f} m (JAX CPU f64 "
                          f"{JAX_CPU_F64_DIST_128:.3f} m, {100 * rel:.2f} % "
                          f"off; JAX CPU f32 {JAX_CPU_F32_DIST_128:.3f} m, "
                          f"{100 * rel32:+.2f} %; the port's f32 factored "
                          f"IPM on the chol kernels {dist_f:.3f} m, "
                          f"{100 * rel_f:+.2f} %), "
                          f"{wall / ALL_CYCLES * 1e3:.2f} ms/cycle, "
                          f"mean tile iterations {iters.mean():.2f}, "
                          f"{launches['fused_ipm']} fused launches")
    return launches["fused_ipm"]


def capture_expand_call(sim, cycles_before):
    """The inputs of the face-expansion call of one cycle of sim after
    cycles_before cycles: the main path's own boxes, slots and table."""
    state = sim.initial_state()
    for _ in range(cycles_before):
        state, _ = sim.cycle(state)
    seen = []
    launch = corridor_ops.expand_boxes

    def record(*args):
        seen.append(tuple(a.clone() if torch.is_tensor(a) else a
                          for a in args))
        return launch(*args)
    corridor_ops.expand_boxes = record
    try:
        sim.cycle(state)
    finally:
        corridor_ops.expand_boxes = launch
    if len(seen) != 1:
        raise AssertionError(f"{len(seen)} face-expansion calls in one "
                             "cycle, expected 1")
    return seen[0]


def forest30_expand_inputs(dev):
    """The face expansion's inputs for the 30 m forest's 20 agents, each
    seeded at its start toward its goal, against the margin table of that
    world (forest30_world, at 0.25 m)."""
    m, _, esdf = forest30_world(dev)
    b = CorridorBuilder(esdf, m.world_min, m.world_max,
                        agent_radius=float(m.agents[0].radius))
    pts = torch.as_tensor(np.array([a.start for a in m.agents]),
                          dtype=torch.float32, device=dev)
    goals = torch.as_tensor(np.array([a.goal for a in m.agents]),
                            dtype=torch.float32, device=dev)
    lo, hi = b.initial_box(pts)
    wmin, wmax = b._world_bounds(torch.float32)
    return (lo, hi, b._axis_order(lo, hi, goals), ~b._obstructed(lo, hi),
            b.sat, b._wmin32, wmin, wmax)


def expand_sat_reads(args):
    """The distinct SAT entries that the face expansion must read on these
    inputs, its tries, and each agent's try outcomes in order.  The plain
    version's round-robin is replayed (expand_boxes_plain's loop); a try
    reads the table only when its slab is in bounds, and then the eight
    corners of each inclusion-exclusion term that is neither dropped at the
    world minimum nor empty (OccupancySAT.box_obstructed and _box_count).
    (The kernel reads a round's speculated tries and every term's clamped
    corners all the same; the bound counts what the function needs.)"""
    lo, hi, cand, seed_ok, sat, wmin32, wmin, wmax = args
    N, dev, res = lo.shape[0], lo.device, sat.resolution
    rows = torch.arange(N, device=dev)
    offs = torch.arange(1, 7, device=dev)
    active = seed_ok[:, None].expand(N, 6).clone()
    p = torch.full((N,), 5, dtype=torch.int64, device=dev)
    T = sat._corner_bits                                   # (8, 3)
    S = sat.sat.shape
    slabs, reads, tries = [], [], 0
    outcomes = [[] for _ in range(N)]

    class Recorder:     # the table, noting the slab of each try
        resolution = res

        def box_obstructed(self, s_lo, s_hi, at_min):
            slabs.append((s_lo, s_hi, at_min))
            return sat.box_obstructed(s_lo, s_hi, at_min)

    while bool(active.any()):
        going = active.any(-1)
        slots = (p[:, None] + offs[None, :]) % 6
        first = torch.argmax(torch.gather(active, 1, slots).to(torch.uint8),
                             dim=-1)
        p2 = slots[rows, first]
        lo2, hi2, ok = corridor_ops.try_expand(Recorder(), lo, hi,
                                               cand[rows, p2], wmin32, wmin,
                                               wmax)
        s_lo, s_hi, at_min = slabs.pop()
        inb = ((s_lo.to(wmin.dtype) * res > wmin - SP_EPSILON).all(-1) &
               (s_hi.to(wmin.dtype) * res < wmax + SP_EPSILON).all(-1))
        # the terms' cell boxes (N, 8, 3), then their corners (N, 8, 8, 3)
        l = s_lo.long() - sat._k0
        h = s_hi.long() - sat._k0
        a = l - 1 + at_min.long()
        t_lo = torch.where(T, l[:, None, :], a[:, None, :])
        t_hi = torch.where(T, l[:, None, :], h[:, None, :])
        lo_c = torch.minimum(t_lo.clamp(min=0), sat._dims)
        hi_c = torch.minimum((t_hi + 1).clamp(min=0), sat._dims)
        read = (~(T & at_min[:, None, :]).any(-1) &
                ~(hi_c <= lo_c).any(-1) & (going & inb)[:, None])
        corner = torch.where(T, hi_c[:, :, None, :], lo_c[:, :, None, :])
        flat = (corner[..., 0] * S[1] + corner[..., 1]) * S[2] + \
            corner[..., 2]
        reads.append(flat[read].reshape(-1))
        tries += int(going.sum())
        for i, o in zip(going.nonzero().flatten().tolist(),
                        ok[going].tolist()):
            outcomes[i].append(o)
        lo = torch.where(going[:, None], lo2, lo)
        hi = torch.where(going[:, None], hi2, hi)
        active[rows, p2] = torch.where(going, ok, active[rows, p2])
        p = torch.where(going, p2, p)
    return int(torch.cat(reads).unique().numel()), tries, outcomes


def spec_rounds(outcomes, k):
    """The kernel's rounds for one agent's try outcomes at k tries
    speculated a round: a round commits up to k tries, through the first
    failure among them."""
    rounds, i = 0, 0
    while i < len(outcomes):
        seg = outcomes[i:i + k]
        i += seg.index(False) + 1 if False in seg else len(seg)
        rounds += 1
    return rounds


def expand_bound(args, out):
    """The least time of the face expansion on these inputs: the boxes,
    slots, flags and bounds read once, the boxes written once, and each
    SAT entry that its tries need read once (int32, expand_sat_reads).
    Returns (bound, entries, tries, each agent's try outcomes)."""
    entries, tries, outcomes = expand_sat_reads(args)
    small = [t for t in args if torch.is_tensor(t)]
    return (bound(tensor_bytes(*small, *out) + 4 * entries, 0.0), entries,
            tries, outcomes)


def compare_expand(dev, forest_sim):
    """Phase 12: the face-expansion kernel against its plain version, bit
    for bit, one launch a call, on forest20's cycle-4 and cycle-21 calls
    and the 30 m forest's seeds, with kernel / plain ms, the bound, the
    busiest agent's tries and the kernel's rounds at the K it speculates
    (corridor_ops.spec_k).  Returns the cycle-4 numbers."""
    main = None
    k = corridor_ops.spec_k()
    for name, args in (("forest20 cycle 4", capture_expand_call(forest_sim,
                                                                3)),
                       ("forest20 cycle 21", capture_expand_call(forest_sim,
                                                                 20)),
                       ("forest30 starts", forest30_expand_inputs(dev))):
        want = corridor_ops.expand_boxes_plain(*args)
        corridor_ops.reset_counts()
        got = corridor_ops.expand_boxes(*args)
        torch.cuda.synchronize()
        if corridor_ops.expand_launches != 1:
            raise AssertionError(f"expand_boxes {name}: "
                                 f"{corridor_ops.expand_launches} launches "
                                 "in one call")
        if not (torch.equal(got[0], want[0]) and
                torch.equal(got[1], want[1])):
            bad = ((got[0] != want[0]) | (got[1] != want[1])).any(-1)
            raise AssertionError(f"expand_boxes {name}: kernel differs from "
                                 f"its plain version for agents "
                                 f"{bad.nonzero().flatten().tolist()}")
        err = max((g - w).abs().max().item() for g, w in zip(got, want))
        t_k = median_ms(lambda: corridor_ops.expand_boxes(*args), reps=20)
        t_p = median_ms(lambda: corridor_ops.expand_boxes_plain(*args),
                        reps=5)
        (b_ms, b_by), entries, tries, outcomes = expand_bound(args, want)
        busy = max(range(len(outcomes)), key=lambda i: len(outcomes[i]))
        rounds = [spec_rounds(o, k) for o in outcomes]
        phase("12 captured", f"expand_boxes {name}: N={args[0].shape[0]}, "
                             f"table {tuple(args[4].sat.shape)}, {tries} "
                             f"tries reading {entries} distinct entries, "
                             f"the busiest agent ({busy}) "
                             f"{len(outcomes[busy])} tries in "
                             f"{rounds[busy]} rounds of K={k} (most rounds "
                             f"{max(rounds)}, {sum(rounds)} in all), "
                             f"bit-equal to its plain version, one launch; "
                             f"{t_k:.4f} ms vs plain {t_p:.4f} ms, bound "
                             f"{b_ms:.7f} ms ({b_by})")
        if main is None:
            main = (err, t_k, t_p, (b_ms, b_by))
    return main


def random1024_sim(dev, seed=RANDOM1024_SEED):
    """The benchmark cell random1024's simulator: the mission of its
    traffic at `seed`, its configuration's Param and dtype
    (lscbench/cell.py, which imports nothing of the program)."""
    bench = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "lscbench")
    if bench not in sys.path:
        sys.path.insert(0, bench)
    import cell as cell_mod
    from lsc_planner_tpu_torch import config, missions
    c = cell_mod.find("random1024")
    mission = cell_mod.build_mission(missions, c.mission_arrays(seed),
                                     c.config["agent"])
    return SyncSimulator(mission, cell_mod.build_param(config, c.config),
                         device=dev, dtype=getattr(torch, c.config["dtype"]))


def capture_planes_call(sim, cycles_before):
    """The inputs of the LSC planes call of one cycle of sim after
    cycles_before cycles: (args, kwargs) of that constraints.lsc_planes
    call."""
    state = sim.initial_state()
    for _ in range(cycles_before):
        state, _ = sim.cycle(state)
    seen = []
    launch = constraints.lsc_planes

    def record(*args, **kw):
        seen.append(([a.clone() for a in args],
                     {k: v.clone() if torch.is_tensor(v) else v
                      for k, v in kw.items()}))
        return launch(*args, **kw)
    constraints.lsc_planes = record
    try:
        sim.cycle(state)
    finally:
        constraints.lsc_planes = launch
    if len(seen) != 1:
        raise AssertionError(f"{len(seen)} LSC planes calls in one cycle, "
                             "expected 1")
    return seen[0]


def planes_ops(K, guard):
    """The correctly rounded additions, subtractions, multiplications,
    divisions and square roots of one hull of K control points in the
    LSC planes' function (csrc/planes.cu, op for op the plain version's):
    the downwash and the relative points, every subset's bordered system
    (sizes 1 to 3), the interior test (K > 3), the normal, and each
    point's margin and right-hand side."""
    ops = 7 + 9 * K                      # downwash, 1 / dw; rel
    for S in range(1, min(K, 3) + 1):
        sub = 3 * S * (S + 1) + 2 * S + 3          # Gram, ridge
        for j in range(S):                         # Cholesky
            sub += 2 * j + 3 + (S - 1 - j) * (2 * j + 1)
        sub += 2 * sum(2 * i + 1 for i in range(S))    # G w = 1
        sub += 4 * S + 6 * S + 6                   # lam, cand, d2
        ops += math.comb(K, S) * sub
    if K > 3:
        ops += K * 17 + 1                          # interior test
    ops += 1 + 3 + 1                               # dist, normal, z / dw
    ops += K * (3 + 4 + 2 + (4 if guard else 0) + 3 + 5)
    return ops


def planes_bound(args, kw, out):
    """bound() of one LSC planes call: its inputs read once, the normals
    and right-hand sides written once (the mask is a view), and
    planes_ops a hull."""
    N, O, M, K = args[1].shape[:4]
    ins = [a for a in args if torch.is_tensor(a)] + \
        [v for v in kw.values() if torch.is_tensor(v)]
    guard = kw.get("guard_margin", 0.0) > 0.0
    return bound(tensor_bytes(*ins, out.normal, out.rhs),
                 N * O * M * planes_ops(K, guard))


def compare_planes(dev, forest_sim):
    """Phase 18: the LSC planes kernel against its plain version, bit for
    bit, one launch a call, on the fourth cycle's call of the benchmark's
    random1024 and of forest20, with kernel / plain ms and the bound.
    Returns {name: (max abs error, kernel ms, plain ms, bound)}."""
    out = {}
    for name, sim in (("random1024 cycle 4", random1024_sim(dev)),
                      ("forest20 cycle 4", forest_sim)):
        args, kw = capture_planes_call(sim, 3)
        want = lsc_ops.lsc_planes_plain(*args, **kw)
        lsc_ops.reset_counts()
        got = lsc_ops.lsc_planes(*args, **kw)
        torch.cuda.synchronize()
        if lsc_ops.lsc_planes_launches != 1:
            raise AssertionError(f"lsc_planes {name}: "
                                 f"{lsc_ops.lsc_planes_launches} launches "
                                 "in one call")
        diff = sum(int((bits(g) != bits(w)).sum()) for g, w in (
            (got.normal, want.normal), (got.rhs, want.rhs)))
        if diff or not torch.equal(got.mask, want.mask):
            raise AssertionError(f"lsc_planes {name}: {diff} bits differ "
                                 "from the plain version's")
        t_k = median_ms(lambda: lsc_ops.lsc_planes(*args, **kw))
        t_p = median_ms(lambda: lsc_ops.lsc_planes_plain(*args, **kw),
                        reps=20)
        b_ms, b_by = planes_bound(args, kw, want)
        N, O, M, K = args[1].shape[:4]
        phase("18 planes", f"lsc_planes {name}: (N, O, M, K) = "
                           f"{(N, O, M, K)}, {N * O * M} hulls, bit-equal "
                           f"to its plain version, one launch; {t_k:.4f} ms"
                           f" vs plain {t_p:.4f} ms, bound {b_ms:.6f} ms "
                           f"({b_by})")
        out[name] = (0.0, t_k, t_p, (b_ms, b_by))
    return out


def differing_bits(a, b):
    """Bits that differ between tensors a and b of one dtype and shape
    (a bool counts one bit)."""
    if a.dtype == torch.bool:
        return int((a != b).sum())
    nbits = 8 * a.element_size()
    view = {4: torch.int32, 8: torch.int64}[a.element_size()]
    x = torch.bitwise_xor(a.view(view), b.view(view)).to(torch.int64)
    if nbits == 32:
        x = x & 0xFFFFFFFF
    return sum(int(((x >> i) & 1).sum()) for i in range(nbits))


def captured_bits(sim, what, name="12 captured"):
    """From the state after CAPTURE_BEFORE uncaptured cycles, CAPTURE_K
    cycles through the captured graph (the one fly_captured's run
    captured: same shapes) against CAPTURE_K uncaptured ones: raises
    unless every SwarmState field has the same bits."""
    state = sim.initial_state()
    for _ in range(CAPTURE_BEFORE):
        state, _ = sim.cycle(state)
    want = state
    for _ in range(CAPTURE_K):
        want, _ = sim.cycle(want)
    multi = sim.make_scan_cycle(CAPTURE_K)
    got, _ = multi(state)
    torch.cuda.synchronize()
    diffs = {f: differing_bits(a, b) for f, a, b in zip(got._fields, got,
                                                          want)
             if a is not None}
    phase(name, f"{what}: {CAPTURE_K} captured cycles after "
                f"{CAPTURE_BEFORE} against {CAPTURE_K} uncaptured: "
                f"differing bits {sum(diffs.values())} "
                f"({', '.join(f'{k} {v}' for k, v in diffs.items())})")
    if any(diffs.values()):
        raise AssertionError(f"{what}: captured cycles differ from "
                             f"uncaptured ones in {diffs}")


def fly_captured(sim, what, uncaptured, max_iterations=None,
                 finishes=True):
    """A mission through run(steps_per_dispatch=CAPTURE_K), which captures
    its graph: the same cycles and distance as its uncaptured run, and the
    mission gates.  The counters, set to 0 before the run, move only in
    its warm-up cycle and its capture (a replay moves none): each kernel's
    count is (CAPTURE_K + 1) / CAPTURE_K of the block's."""
    param = sim.param
    reset_launch_counts()
    summary = sim.run(max_iterations=max_iterations,
                      steps_per_dispatch=CAPTURE_K)
    torch.cuda.synchronize()
    counts = launch_counts()
    # the graph that run() captured for the mission's shapes
    g = sim.cycle_graph(CAPTURE_K, sim.initial_state())
    block = {k: v for k, v in g.launches.items() if v}
    cycles = summary["iterations"]
    check_mission(summary, param, sim.N, what + " captured",
                  finished=finishes)
    if sim.corridor is not None and not summary["safety_ratio_obs"] >= 1.0:
        raise AssertionError(f"{what} captured: obstacle safety "
                             f"{summary['safety_ratio_obs']} < 1")
    same = (cycles == uncaptured["iterations"] and
            summary["total_flight_distance"] ==
            uncaptured["total_flight_distance"])
    phase("12 captured", f"{what} run(steps_per_dispatch={CAPTURE_K}): "
                         f"{cycles} cycles, distance "
                         f"{summary['total_flight_distance']:.6f} m "
                         f"(uncaptured {uncaptured['iterations']} cycles, "
                         f"{uncaptured['total_flight_distance']:.6f} m), "
                         f"min safety {summary['safety_ratio_agent']:.4f}, "
                         f"min obstacle safety "
                         f"{summary['safety_ratio_obs']:.4f}, QPFAILED "
                         f"{summary['qp_failures']}; ms a cycle captured "
                         f"{1e3 * summary['average_planning_time']:.2f} "
                         f"(blocks after the first; "
                         f"{1e3 * summary['wall_time'] / cycles:.2f} run "
                         f"wall / cycles, capture included), uncaptured "
                         f"{1e3 * uncaptured['average_planning_time']:.2f} "
                         f"({1e3 * uncaptured['wall_time'] / cycles:.2f}); "
                         "capture + instantiate "
                         f"{trace.last_seconds('graph.capture'):.2f} s; "
                         f"kernel launches captured in a block {block}")
    if not block or any(counts[k] * CAPTURE_K != v * (CAPTURE_K + 1)
                        for k, v in g.launches.items()):
        raise AssertionError(f"{what} captured: launches {counts} against "
                             f"{block} a block of {CAPTURE_K} cycles and a "
                             "warm-up cycle")
    if not same:
        raise AssertionError(f"{what} captured: {cycles} cycles, "
                             f"{summary['total_flight_distance']} m against "
                             f"{uncaptured['iterations']} cycles, "
                             f"{uncaptured['total_flight_distance']} m "
                             "uncaptured")
    return summary


def check_mission(summary, param, qn, what, finished=True):
    """A run() summary finished under the cap (unless `finished` is False:
    a run of a fixed number of cycles), safely, with no QPFAILED and
    finite final positions; raises otherwise."""
    cycles = summary["iterations"]
    pos = summary["final_state"].pos
    if finished and not cycles < param.multisim_max_planner_iteration:
        raise AssertionError(f"{what}: did not finish within {cycles} "
                             "cycles")
    if not summary["safety_ratio_agent"] >= 1.0 or summary["is_collided"]:
        raise AssertionError(f"{what}: collision, safety "
                             f"{summary['safety_ratio_agent']}")
    if summary["qp_failures"]:
        raise AssertionError(f"{what}: {summary['qp_failures']} QPFAILED "
                             "reports")
    if pos.shape != (qn, 3) or not bool(torch.isfinite(pos).all()):
        raise AssertionError(f"{what}: non-finite final positions")


def time_obstacle_step(sim):
    """Times sim's host obstacle step (SyncSimulator.dynamic_inputs) in
    each cycle of its runs: returns the list the seconds go to."""
    times, step = [], sim.dynamic_inputs

    def timed(*args):
        t0 = time.perf_counter()
        out = step(*args)
        times.append(time.perf_counter() - t0)
        return out
    sim.dynamic_inputs = timed
    return times


def fly_dynamic_mode(dev, mode, noise, min_obs, cycles=None):
    """One dyn64 run() under prediction `mode` (set after validated(), as
    the JAX package's tests set it) with observation noise `noise`:
    obstacle safety above min_obs, 40 factor_solve and 80 resolve launches
    a cycle (and one planes launch a cycle and a QPFAILED report), and,
    run to the finish (cycles None), the mission gates; a
    run of `cycles` cycles is held to finite positions.  Returns (summary,
    host step ms a cycle)."""
    param = Param(goal_mode=GoalMode.PRIOR_BASED, obs_observer_stddev=noise)
    sim = SyncSimulator(dyn64_mission(), param, device=dev,
                        dtype=torch.float32)
    sim.param.prediction_mode = mode
    host = time_obstacle_step(sim)
    what = f"dyn64 {mode.name}" + (f" noise {noise} m" if noise else "")
    reports = count_reports(sim)
    reset_launch_counts()
    summary = sim.run(max_iterations=cycles)
    torch.cuda.synchronize()
    done = summary["iterations"]
    pos = summary["final_state"].pos
    if cycles is None:
        check_mission(summary, sim.param, MAIN_B, what)
    elif done != cycles or not bool(torch.isfinite(pos).all()):
        raise AssertionError(f"{what}: {done} cycles of {cycles}, finite "
                             f"positions {bool(torch.isfinite(pos).all())}")
    if not summary["safety_ratio_obs"] > min_obs:
        raise AssertionError(f"{what}: obstacle safety "
                             f"{summary['safety_ratio_obs']} <= {min_obs}")
    check_launches(what, factor_solve=done * param.qp_iterations,
                   resolve=done * param.qp_iterations *
                   (1 + param.qp_correctors),
                   lsc_planes=done + len(reports))
    host_ms = 1e3 * statistics.mean(host)
    phase("13 dynamic", f"{what}: {done} cycles"
                        f"{' (finished)' if cycles is None else ''}, safety "
                        f"{summary['safety_ratio_agent']:.4f}, obstacle "
                        f"safety {summary['safety_ratio_obs']:.4f} (bound "
                        f"{min_obs}), {summary['qp_failures']} QPFAILED, "
                        f"{1e3 * summary['wall_time'] / done:.2f} ms/cycle "
                        f"(run wall / cycles; "
                        f"{1e3 * summary['average_planning_time']:.2f} ms "
                        f"mean after the first), host obstacle step "
                        f"{host_ms:.2f} ms a cycle, {done * 40} factor_solve"
                        f" and {done * 80} resolve launches")
    return summary, host_ms


def fly_dynamic(dev):
    """Phase 13: dyn64 with each prediction mode, then dyn1024."""
    summary, _ = fly_dynamic_mode(dev, PredictionMode.PREVIOUS_SOLUTION,
                                  0.0, 0.85)
    cycles = summary["iterations"]
    band = max(0.2 * JAX_CPU_F32_DYN64_CYCLES, 10)
    if not abs(cycles - JAX_CPU_F32_DYN64_CYCLES) <= band:
        raise AssertionError(f"dyn64: {cycles} cycles, more than {band} off "
                             f"the JAX CPU f32 run's "
                             f"{JAX_CPU_F32_DYN64_CYCLES}")
    phase("13 dynamic", f"dyn64 finished in {cycles} cycles (JAX CPU f32: "
                        f"{JAX_CPU_F32_DYN64_CYCLES}, band {band:g})")
    # Under ORACLE and the Kalman filters the agents predict one another at
    # constant velocity (simulator.py:542-550 of the JAX package), which
    # the LSC planes' safety argument does not cover: in dyn64's converging
    # crowd the JAX package's own runs break the agent gates.  40 cycles on
    # a CPU (tests/test_torch_f32_missions.py dyn64_oracle_f64 ...): ORACLE
    # in f64, min safety 0.8954 at cycle 27 (the port 0.9155; the two
    # within 1.2e-5 m a cycle up to cycle 21), in f32 2 QPFAILED at cycles
    # 37-38 (min safety 1.0086); the Kalman filters in f64, 0.9656 and a
    # QPFAILED at cycle 39 (the port 1.0315; within 5.3e-6 m a cycle up to
    # cycle 27), in f32 1.0132 and none.  These runs are held to what the
    # modes change, the obstacle safety, and their agent figures are
    # printed beside the JAX package's f32 ones.
    for mode, noise, min_obs, jax_f32 in (
            (PredictionMode.ORACLE, 0.0, 0.85, "1.0086, 2 QPFAILED"),
            (PredictionMode.LINEAR_KALMAN_FILTER, DYN_NOISE, 0.8,
             "1.0132, 0 QPFAILED")):
        fly_dynamic_mode(dev, mode, noise, min_obs, DYN_MODE_CYCLES)
        phase("13 dynamic", f"  (the JAX package's CPU f32 run of these "
                            f"cycles: min safety {jax_f32})")

    # dyn1024: K-NN columns plus the obstacles' through the fused kernel
    param = Param(goal_mode=GoalMode.PRIOR_BASED, max_neighbors=BIG_K)
    sim = SyncSimulator(dyn1024_mission(), param, device=dev,
                        dtype=torch.float32)
    host = time_obstacle_step(sim)
    rows, launch = [], ipm.ipm_lsc_fused

    def record(*args, **kw):        # the row groups C of each fused call
        rows.append(args[5].shape[1])
        return launch(*args, **kw)
    ipm.ipm_lsc_fused = record
    try:
        reset_launch_counts()
        summary = sim.run(max_iterations=DYN1024_CYCLES)
        torch.cuda.synchronize()
    finally:
        ipm.ipm_lsc_fused = launch
    check_mission(summary, param, BIG_N, "dyn1024", finished=False)
    check_launches("dyn1024", fused_ipm=DYN1024_CYCLES,
                   lsc_planes=DYN1024_CYCLES)
    want_c = BIG_K + DYN1024_OBSTACLES
    if rows != [want_c] * DYN1024_CYCLES:
        raise AssertionError(f"dyn1024: fused calls at C = {rows}, expected "
                             f"{DYN1024_CYCLES} at {want_c}")
    phase("13 dynamic", f"dyn1024 (K={BIG_K} + {DYN1024_OBSTACLES} straight "
                        f"obstacles): {DYN1024_CYCLES} cycles, one fused "
                        f"launch a cycle at C = {want_c}, min safety "
                        f"{summary['safety_ratio_agent']:.4f}, obstacle "
                        f"safety {summary['safety_ratio_obs']:.4f}, 0 "
                        f"QPFAILED, "
                        f"{1e3 * summary['wall_time'] / DYN1024_CYCLES:.2f} "
                        f"ms/cycle (run wall / cycles; "
                        f"{1e3 * summary['average_planning_time']:.2f} ms "
                        f"mean after the first), host obstacle step "
                        f"{1e3 * statistics.mean(host):.2f} ms a cycle")


def forest20_bt_world(dev, tmpdir):
    """forest20's occupancy (ESDF.from_boxes(...).occ) written to a .bt in
    tmpdir with save_bt and loaded with ESDF.from_bt on dev: raises unless
    its distance field, occupancy and origin are those of
    ESDF.from_occupancy of that occupancy, bit for bit.  Returns (forest20's
    mission without its boxes, the loaded ESDF)."""
    m = forest_mission()
    res = Param().world_resolution
    boxes = np.stack([np.concatenate([o.pose - o.dimensions,
                                      o.pose + o.dimensions])
                      for o in m.obstacles])
    src = ESDF.from_boxes(boxes, m.world_min, m.world_max, resolution=res,
                          device=dev)
    path = os.path.join(tmpdir, "forest20.bt")
    t0 = time.perf_counter()
    nodes = save_bt(path, occupancy_to_keys(src.occ, src.origin_key), res)
    t1 = time.perf_counter()
    esdf = ESDF.from_bt(path, m.world_min, m.world_max, device=dev)
    t2 = time.perf_counter()
    ref = ESDF.from_occupancy(src.occ, src.origin_key, res, device=dev)
    if not (np.array_equal(esdf.occ, src.occ) and
            np.array_equal(esdf.origin_key, ref.origin_key) and
            esdf.resolution == ref.resolution and
            torch.equal(bits(esdf.dist), bits(ref.dist))):
        raise AssertionError("forest20 .bt: ESDF.from_bt differs from "
                             "ESDF.from_occupancy of the occupancy written")
    phase("14 worlds", f"forest20 .bt: {nodes} octree nodes, "
                       f"{os.path.getsize(path)} B, save_bt {t1 - t0:.2f} s,"
                       f" ESDF.from_bt {t2 - t1:.2f} s; dist "
                       f"{tuple(esdf.dist.shape)} and occupancy "
                       f"({100 * esdf.occ.mean():.2f} % occupied) bit-equal "
                       "to ESDF.from_occupancy's")
    m.obstacles = []
    return m, esdf


def fly_forest20_bt(dev):
    """Phase 14: forest20 in its .bt world through run() on the card."""
    with tempfile.TemporaryDirectory() as tmpdir:
        mission, esdf = forest20_bt_world(dev, tmpdir)
    param = Param(goal_mode=GoalMode.PRIOR_BASED, world_use_octomap=True)
    sim = SyncSimulator(mission, param, device=dev, dtype=torch.float32,
                        esdf=esdf)
    reset_launch_counts()
    summary = sim.run()
    torch.cuda.synchronize()
    cycles = summary["iterations"]
    check_mission(summary, param, FOREST_N, "forest20 .bt")
    band = max(0.2 * JAX_CPU_F32_FOREST_BT_CYCLES, 10)
    if not abs(cycles - JAX_CPU_F32_FOREST_BT_CYCLES) <= band:
        raise AssertionError(f"forest20 .bt: {cycles} cycles, more than "
                             f"{band} off the JAX CPU f32 run's "
                             f"{JAX_CPU_F32_FOREST_BT_CYCLES}")
    launches = check_launches(
        "forest20 .bt", wavefront=2 * cycles,
        factor_solve=cycles * param.qp_iterations,
        resolve=cycles * param.qp_iterations * (1 + param.qp_correctors),
        expand_boxes=cycles, lsc_planes=cycles)
    phase("14 worlds", f"forest20 .bt flown: finished in {cycles} cycles "
                       f"(JAX CPU f32: {JAX_CPU_F32_FOREST_BT_CYCLES}), "
                       f"safety {summary['safety_ratio_agent']:.4f}, 0 "
                       f"QPFAILED, distance "
                       f"{summary['total_flight_distance']:.3f} m, "
                       f"{1e3 * summary['wall_time'] / cycles:.2f} ms/cycle "
                       f"(run wall / cycles; "
                       f"{1e3 * summary['average_planning_time']:.2f} ms "
                       f"mean after the first), launches {launches}")


def fly_forest20_castray(dev, forest_stages):
    """Phase 14: forest20 with the exact castRay: CASTRAY_CYCLES uncaptured
    cycles, then run(steps_per_dispatch=CAPTURE_K) of as many cycles, which
    captures the bisection in its graph: the same bits in every field."""
    param = Param(goal_mode=GoalMode.PRIOR_BASED,
                  grid_los_exact_castray=True)
    sim = SyncSimulator(forest_mission(), param, device=dev,
                        dtype=torch.float32)
    what = "forest20 castray"
    state = sim.initial_state()
    reset_launch_counts()
    stats = []
    t0 = time.perf_counter()
    for _ in range(CASTRAY_CYCLES):
        state, info = sim.cycle(state)
        stats.append(torch.stack([info.safety_step_min.double(),
                                  info.qp_failed.sum().double()]).tolist())
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0) / CASTRAY_CYCLES
    c = CASTRAY_CYCLES
    check_launches(what, wavefront=2 * c, factor_solve=c * 40,
                   resolve=c * 80, expand_boxes=c, lsc_planes=c)
    safety, failed = (np.asarray(v) for v in zip(*stats))
    if not safety.min() >= 1.0 or failed.sum():
        raise AssertionError(f"{what}: min safety {safety.min()}, "
                             f"{int(failed.sum())} QPFAILED")
    reset_launch_counts()
    summary = sim.run(max_iterations=c, steps_per_dispatch=CAPTURE_K)
    torch.cuda.synchronize()
    k = CAPTURE_K + 1       # the warm-up cycle and the captured ones
    check_launches(what + " captured", wavefront=2 * k, factor_solve=k * 40,
                   resolve=k * 80, expand_boxes=k, lsc_planes=k)
    got = summary["final_state"]
    diffs = {f: differing_bits(a, b) for f, a, b in zip(got._fields, got,
                                                          state)
             if a is not None}
    if summary["iterations"] != c or any(diffs.values()):
        raise AssertionError(f"{what}: run(steps_per_dispatch={CAPTURE_K}) "
                             f"of {summary['iterations']} cycles differs "
                             f"from {c} uncaptured cycles in {diffs}")
    st = stage_times(sim, [(sim.goal_planner, "plan",
                            "goal planning (grid)")])
    label = "goal planning (grid)"
    phase("14 worlds", f"{what} (castray depth "
                       f"{sim.goal_planner.grid_planner.castray_depth}): "
                       f"{c} cycles, min safety {safety.min():.4f}, 0 "
                       f"QPFAILED, {ms:.2f} ms/cycle uncaptured, "
                       f"{1e3 * summary['average_planning_time']:.2f} "
                       f"captured (blocks after the first); "
                       f"run(steps_per_dispatch={CAPTURE_K}) of {c} cycles: "
                       f"differing bits {sum(diffs.values())}; grid goal "
                       f"stage {st[label]:.2f} ms (median of 5 cycles after "
                       f"20, a sync around each; phase 10's sampled rays "
                       f"{forest_stages[label]:.2f} ms)")


def mode_case(name, mis=None):
    """(mission, Param keywords, cycles) of MODE_CASES[name]; the mission
    from the missions module `mis` (the port's by default)."""
    qn, kw, cycles = MODE_CASES[name]
    kw = dict(dict(goal_mode=GoalMode.PRIOR_BASED), **kw)
    radius = max(4.0, 0.45 * qn / math.pi)
    w = radius + 2.0
    make = make_circle_mission if mis is None else mis.make_circle_mission
    return (make(qn, radius=radius, z=kw.get("world_z_2d", 1.0),
                 world=(-w, -w, 0, w, w, 2.5)), kw, cycles)


def orca_case(name, mis=None):
    """(mission, Param keywords, cycles) of ORCA_CASES[name]: the circle of
    bench.py's geometry (radius max(4, 0.45 N / pi), world +-(radius + 2))
    with agent i's goal agent (i + N // 3) mod N's start
    (tests/test_orca.py's rotational exchange; the antipodal swap is
    ORCA's known standstill), the ORCA planner, in the missions module
    `mis` (the port's by default)."""
    qn, kw, cycles = ORCA_CASES[name]
    kw = dict(kw, planner_mode=PlannerMode.ORCA)
    radius = max(4.0, 0.45 * qn / math.pi)
    w = radius + 2.0
    make = make_circle_mission if mis is None else mis.make_circle_mission
    m = make(qn, radius=radius, z=kw.get("world_z_2d", 1.0),
             world=(-w, -w, 0, w, w, 2.5))
    starts = [a.start for a in m.agents]
    for qi, a in enumerate(m.agents):
        a.goal = starts[(qi + qn // 3) % qn].copy()
    return m, kw, cycles


def exp_push():
    """exp64's observed offsets of the agents EXP_PUSHED, (4, 3) metres."""
    rng = np.random.default_rng(EXP_SEED)
    mag = rng.uniform(0.3, 0.5, size=len(EXP_PUSHED))
    th = rng.uniform(0.0, 2.0 * math.pi, size=len(EXP_PUSHED))
    return np.stack([mag * np.cos(th), mag * np.sin(th),
                     np.zeros_like(mag)], axis=1)


def as_numpy(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def fly_cycles(sim, step, cycles, inject=False):
    """Up to `cycles` cycles of step (sim.cycle, or the JAX package's
    sim._cycle_jit: this works with either package's simulator), to the
    finish when the mission finishes first; with inject, exp64's
    disturbance through sim.inject_positions before cycle
    EXP_INJECT_CYCLE.  Returns a dict: cycles, finished, distance, the
    min step safety (and after the injection cycle), QPFAILED, and for the
    injection cycle its max primal residual, whether its trajectories are
    finite, the pushed agents' slack flags and SFC-initialized flags
    before it and every flag after it, and the final state."""
    state = sim.initial_state()
    out = dict(safety=math.inf, safety_after=math.inf, qp_failures=0,
               finished=False)
    for it in range(cycles):
        if inject and it == EXP_INJECT_CYCLE:
            real = np.array(as_numpy(sim.propagate(state)[0]), np.float64)
            real[list(EXP_PUSHED)] += exp_push()
            state = sim.inject_positions(state, real)
            out["flags_set"] = as_numpy(state.slack_flags).nonzero()[0]
            out["sfc_reset"] = (~as_numpy(state.sfc_initialized)
                                ).nonzero()[0]
        state, info = step(state)
        safety = float(as_numpy(info.safety_step_min))
        out["safety"] = min(out["safety"], safety)
        if inject and it > EXP_INJECT_CYCLE:
            out["safety_after"] = min(out["safety_after"], safety)
        out["qp_failures"] += int(as_numpy(info.qp_failed).sum())
        if inject and it == EXP_INJECT_CYCLE:
            out["inject_primal"] = float(as_numpy(info.primal_res).max())
            out["inject_finite"] = bool(np.isfinite(
                as_numpy(state.traj)).all())
            out["flags_after"] = int(as_numpy(state.slack_flags).sum())
            out["sfc_after"] = bool(as_numpy(state.sfc_initialized).all())
        if sim.is_finished(state):
            out["finished"] = True
            break
    out.update(cycles=it + 1, distance=float(as_numpy(state.distance)),
               state=state)
    return out


def mode_sim(dev, name):
    """(simulator on the card in f32, Param, cycles) of MODE_CASES[name]."""
    tm, kw, cycles = mode_case(name)
    param = Param(**kw)
    return (SyncSimulator(tm, param, device=dev, dtype=torch.float32), param,
            cycles)


def chol_launches(param, cycles, n, dtype=torch.float32, reports=0):
    """A dense-row mission's kernel launches at its KKT size n: 40
    factor_solve and 80 resolve a cycle, on the kernels chol.large_design
    picks for n in the run's dtype, and one LSC planes launch a cycle in
    the LSC planner mode and one a QPFAILED report (count_reports)."""
    sfx = {None: "", "cluster": "_cluster", "tiled": "_tiled"}[
        chol.large_design(n, dtype)]
    lsc = param.planner_mode == PlannerMode.LSC
    return {"factor_solve" + sfx: cycles * param.qp_iterations,
            "resolve" + sfx: cycles * param.qp_iterations *
            (1 + param.qp_correctors),
            "lsc_planes": (cycles if lsc else 0) + reports}


def count_reports(sim):
    """The list that sim's QPFAILED violation reports append to: run()
    makes one for each cycle with a QPFAILED agent, and each computes the
    LSC planes once (one planes launch, in any planner mode)."""
    calls = []
    report = sim.qp_violation_report

    def counted(*args, **kw):
        calls.append(1)
        return report(*args, **kw)
    sim.qp_violation_report = counted
    return calls


def kkt_n(sim, param):
    """The QP's KKT size: nv, plus C M slack entries in the slack QP."""
    slack = param.planner_mode == PlannerMode.RECIPROCAL_RSFC or \
        param.multisim_experiment
    return sim.optimizer.nv + (sim.N * param.M if slack else 0)


def in_band(cycles, ref):
    return abs(cycles - ref) <= max(0.2 * ref, 10)


def fly_bvc64(dev):
    """bvc64 to the finish through the one-warp chol kernels (dense rows at
    n = 45): held to the JAX package's CPU f32 run, which finishes."""
    sim, param, _ = mode_sim(dev, "bvc64")
    reset_launch_counts()
    summary = sim.run()
    torch.cuda.synchronize()
    cycles = summary["iterations"]
    launches = check_launches(
        "bvc64", **chol_launches(param, cycles, kkt_n(sim, param)))
    check_mission(summary, param, sim.N, "bvc64")
    if not in_band(cycles, JAX_CPU_F32_BVC64[0]):
        raise AssertionError(f"bvc64: {cycles} cycles, JAX CPU f32 "
                             f"{JAX_CPU_F32_BVC64[0]}")
    phase("15 modes", f"bvc64 (BVC, POSITION prediction and initial "
                      f"trajectory) finished in {cycles} cycles (JAX CPU "
                      f"f32: {JAX_CPU_F32_BVC64[0]} cycles, safety "
                      f"{JAX_CPU_F32_BVC64[1]}), safety "
                      f"{summary['safety_ratio_agent']:.4f}, 0 QPFAILED, "
                      f"{1e3 * summary['wall_time'] / cycles:.2f} ms/cycle "
                      f"(run wall / cycles), launches {launches}")
    return launches


def cycle_qp(sim, state):
    """sim.cycle(state) -> (the new state, (its QPFAILED agents, each
    agent's primal residual and complementarity gap (N,) numpy)), the gap
    read from the QP result that plan_block hands the cycle."""
    seen = []
    plan = sim.plan_block

    def record(*args, **kw):
        out = plan(*args, **kw)
        seen.append(out[0])
        return out
    sim.plan_block = record
    try:
        state, info = sim.cycle(state)
    finally:
        del sim.plan_block
    return state, (info.qp_failed.nonzero().flatten().tolist(),
                   as_numpy(seen[0].primal_res), as_numpy(seen[0].gap))


# the runs, besides the plain chol versions' in f32, that phase 15 makes of
# each of rsfc64's QPFAILED cycles: (label, device (None: the card's),
# dtype)
CARD_RERUNS = (("card f64", None, torch.float64),)


@contextlib.contextmanager
def plain_chol():
    """chol's factor_solve and resolve replaced by their plain versions
    while the block runs."""
    fs, rs = chol.chol_factor_solve, chol.chol_resolve
    chol.chol_factor_solve = chol.chol_factor_solve_plain
    chol.chol_resolve = chol.chol_resolve_plain
    try:
        yield
    finally:
        chol.chol_factor_solve, chol.chol_resolve = fs, rs


def rerun_cycle(name, sim, prev, ways=CARD_RERUNS):
    """The cycle from state prev (sim's, f32 on the card) run again with
    the plain chol versions on sim's card and dtype, then once for each
    (label, device, dtype) of ways by a new simulator of mode case name.
    Returns {run: (QPFAILED agents, primal residuals, gaps)}."""
    tm, kw, _ = mode_case(name)
    fields = state_to_numpy(prev)
    with plain_chol():
        out = {"card f32, plain chol": cycle_qp(sim, prev)[1]}
    for label, device, dtype in ways:
        device = sim.device if device is None else device
        other = SyncSimulator(tm, Param(**kw), device=device, dtype=dtype)
        out[label] = cycle_qp(other, state_from_numpy(
            fields, device=device, dtype=dtype))[1]
    return out


def qp_failures_rerun(sim, name, cycles, ways=CARD_RERUNS):
    """Steps sim's cycles from its initial state (the kernels' run, bit for
    bit) and runs each cycle that has a QPFAILED agent again from the state
    before it (rerun_cycle): [(cycle, the kernels' QPFAILED agents, their
    primal residuals and gaps, the state before the cycle, the reruns)]."""
    state, out = sim.initial_state(), []
    for it in range(cycles):
        prev = state
        state, (failed, res, gap) = cycle_qp(sim, prev)
        if failed:
            out.append((it, failed, res, gap, prev,
                        rerun_cycle(name, sim, prev, ways)))
    return out


def qp_failure_lines(failures):
    """One line a failing cycle: each run's QPFAILED agents and, for the
    kernels' failing agents, their primal residuals and gaps."""
    lines = []
    for it, failed, res, gap, _, reruns in failures:
        runs = {"card f32, kernels": (failed, res, gap), **reruns}
        lines.append(f"cycle {it}: " + "; ".join(
            f"{label} QPFAILED {agents} (" + ", ".join(
                f"agent {a} primal {r[a]:.3e} gap {g[a]:.3e}"
                for a in failed) + ")"
            for label, (agents, r, g) in runs.items()))
    return lines


def fly_slack(dev, name, dtype, ref, tol, design):
    """A slack-QP mission of MODE_CASES on the card in dtype for its
    cycles through run(): its KKT size on the large-n chol design `design`
    (chol.large_design), 40 factor_solve and 80 resolve launches a cycle
    on that design's kernels, finite trajectories, safety > 0.9
    (tests/test_modes.py's bound for RSFC), distance within tol (relative)
    of ref[0] (the distance of a CPU run of the same cycles).  Returns
    (sim, param, the run's summary, the launches)."""
    tm, kw, cycles = mode_case(name)
    param = Param(**kw)
    sim = SyncSimulator(tm, param, device=dev, dtype=dtype)
    reports = count_reports(sim)
    reset_launch_counts()
    summary = sim.run(max_iterations=cycles)
    torch.cuda.synchronize()
    n = kkt_n(sim, param)
    launches = check_launches(name, **chol_launches(param, cycles, n, dtype,
                                                    len(reports)))
    if chol.large_design(n, dtype) != design:
        raise AssertionError(f"{name}: n = {n} in {dtype} is on the "
                             f"{chol.large_design(n, dtype)} design, not "
                             f"the {design} one")
    dist = summary["total_flight_distance"]
    state = summary["final_state"]
    if summary["iterations"] != cycles or \
            not bool(torch.isfinite(state.traj).all()):
        raise AssertionError(f"{name}: {summary['iterations']} cycles, "
                             "finite trajectories "
                             f"{bool(torch.isfinite(state.traj).all())}")
    if not summary["safety_ratio_agent"] > 0.9:
        raise AssertionError(f"{name}: safety "
                             f"{summary['safety_ratio_agent']} <= 0.9")
    if not abs(dist - ref[0]) <= tol * ref[0]:
        raise AssertionError(f"{name} {dtype}: distance {dist} m, the CPU "
                             f"reference {ref[0]} m (tolerance {tol:.0%})")
    return sim, param, summary, launches


def check_captured(name, sim, summary):
    """The same cycles as the run() of summary through
    run(steps_per_dispatch=CAPTURE_K), its final state bit for bit with
    that run's: (the captured run's summary, {field: differing bits})."""
    reset_launch_counts()
    captured = sim.run(max_iterations=summary["iterations"],
                       steps_per_dispatch=CAPTURE_K)
    torch.cuda.synchronize()
    got, state = captured["final_state"], summary["final_state"]
    diffs = {f: differing_bits(a, b) for f, a, b in zip(got._fields, got,
                                                          state)
             if a is not None}
    if any(diffs.values()):
        raise AssertionError(f"{name}: run(steps_per_dispatch={CAPTURE_K}) "
                             f"differs from run() in {diffs}")
    return captured, diffs


def print_qp_failures(name, failures):
    for line in qp_failure_lines(failures) or ["none"]:
        phase("15 modes", f"{name} QPFAILED, each failing cycle run again "
                          "from the state before it: " + line)


def fly_rsfc64(dev):
    """rsfc64, 20 cycles: every cycle the slack QP at n = 45 + 64 x 5 =
    365 on the cluster chol kernels (a cluster of 2 blocks a matrix;
    fly_slack: within 10 % of the JAX package's CPU f32 distance); its
    QPFAILED cycles again on the card (qp_failures_rerun; the state
    before cycle 3 is f32-hard, tests/test_torch_qpfailed.py); then the
    same 20 cycles through run(steps_per_dispatch=CAPTURE_K), bit for
    bit.  Returns the launches of the uncaptured run."""
    sim, param, summary, launches = fly_slack(
        dev, "rsfc64", torch.float32, JAX_CPU_F32_RSFC64, 0.1, "cluster")
    cycles = summary["iterations"]
    failures = qp_failures_rerun(sim, "rsfc64", cycles)
    ms = 1e3 * summary["wall_time"] / cycles
    from lsc_planner_tpu_torch.ops import qp as qp_ops
    st = stage_times(sim, [(sim.optimizer, "solve", "optimizer.solve"),
                           (qp_ops, "solve_qp", "solve_qp"),
                           (chol, "chol_factor_solve", "factor_solve"),
                           (chol, "chol_resolve", "resolve")],
                     cycles_before=5)
    captured, diffs = check_captured("rsfc64", sim, summary)
    phase("15 modes", f"rsfc64 (RECIPROCAL_RSFC, the slack QP at n = "
                      f"{kkt_n(sim, param)}): {cycles} cycles, distance "
                      f"{summary['total_flight_distance']:.4f} m (JAX CPU "
                      f"f32 {JAX_CPU_F32_RSFC64[0]:.4f} m), safety "
                      f"{summary['safety_ratio_agent']:.4f} (JAX "
                      f"{JAX_CPU_F32_RSFC64[1]}), {summary['qp_failures']} "
                      f"QPFAILED (JAX {JAX_CPU_F32_RSFC64[2]}), {ms:.2f} "
                      f"ms/cycle uncaptured, "
                      f"{1e3 * captured['average_planning_time']:.2f} "
                      f"captured (blocks after the first), launches "
                      f"{launches}; run(steps_per_dispatch={CAPTURE_K}): "
                      f"differing bits {sum(diffs.values())} over "
                      f"{len(diffs)} fields")
    n_fs = param.qp_iterations
    n_rs = n_fs * (1 + param.qp_correctors)
    print_qp_failures("rsfc64", failures)
    phase("15 modes", "rsfc64 stage ms (median of 5 cycles after 5, a sync "
                      "around each call): " + ", ".join(
                          f"{k} {v:.3f}" for k, v in st.items()) +
          f"; a cycle's {n_fs} factor_solve and {n_rs} resolve calls "
          f"{n_fs * st['factor_solve'] + n_rs * st['resolve']:.2f}")
    return launches


def fly_rsfc96(dev, chol_ms):
    """rsfc96 (f32): 20 cycles of the slack QP at n = 45 + 96 x 5 = 525,
    B = 96, on the tiled design (fly_slack: within 10 % of the JAX
    package's CPU f32 distance); its QPFAILED cycles again on the card
    (qp_failures_rerun); then the same cycles through
    run(steps_per_dispatch=CAPTURE_K), bit for bit.  ms a cycle
    uncaptured and captured, and the chol kernels' share of a captured
    cycle: launches x kernel ms (chol_ms, phase 4's times on rsfc96's own
    systems) over the captured ms.  Returns the launches."""
    sim, param, summary, launches = fly_slack(
        dev, "rsfc96", torch.float32, JAX_CPU_F32_RSFC96, 0.1, "tiled")
    cycles = summary["iterations"]
    failures = qp_failures_rerun(sim, "rsfc96", cycles)
    captured, diffs = check_captured("rsfc96", sim, summary)
    n_fs = param.qp_iterations
    n_rs = n_fs * (1 + param.qp_correctors)
    cap_ms = 1e3 * captured["average_planning_time"]
    chol_cycle = n_fs * chol_ms["factor_solve"][0] + \
        n_rs * chol_ms["resolve"][0]
    phase("15 modes", f"rsfc96 (RECIPROCAL_RSFC, f32, the slack QP at n = "
                      f"{kkt_n(sim, param)}, B = {sim.N}, tiled): {cycles} "
                      f"cycles, distance "
                      f"{summary['total_flight_distance']:.4f} m (JAX CPU "
                      f"f32 {JAX_CPU_F32_RSFC96[0]:.4f} m), safety "
                      f"{summary['safety_ratio_agent']:.4f} (JAX "
                      f"{JAX_CPU_F32_RSFC96[1]}), {summary['qp_failures']} "
                      f"QPFAILED (JAX {JAX_CPU_F32_RSFC96[2]}), "
                      f"{1e3 * summary['wall_time'] / cycles:.2f} ms/cycle "
                      f"uncaptured, {cap_ms:.2f} captured (blocks after the "
                      f"first); the chol kernels {n_fs} x "
                      f"{chol_ms['factor_solve'][0]:.4f} + {n_rs} x "
                      f"{chol_ms['resolve'][0]:.4f} = {chol_cycle:.2f} ms, "
                      f"{100 * chol_cycle / cap_ms:.1f} % of a captured "
                      f"cycle; launches {launches}; "
                      f"run(steps_per_dispatch={CAPTURE_K}): differing bits "
                      f"{sum(diffs.values())} over {len(diffs)} fields "
                      f"[{smi_line()}]")
    print_qp_failures("rsfc96", failures)
    return launches


def kernels_vs_plain_cycles(sim, cycles):
    """Steps sim's cycles from its initial state (the kernels' run, bit for
    bit) and runs each cycle again from the same state with the plain chol
    versions on the same card and dtype: [(cycle, the largest difference
    of the new trajectories (m), the kernels' (QPFAILED agents, max primal
    residual, max gap), the plain versions')]."""
    state, out = sim.initial_state(), []
    for it in range(cycles):
        prev = state
        state, (failed, res, gap) = cycle_qp(sim, prev)
        with plain_chol():
            plain, (failed_p, res_p, gap_p) = cycle_qp(sim, prev)
        out.append((it, float((state.traj - plain.traj).abs().max()),
                    (failed, float(res.max()), float(gap.max())),
                    (failed_p, float(res_p.max()), float(gap_p.max()))))
    return out


def fly_rsfc64_f64(dev):
    """rsfc64 in f64: its 20 cycles at n = 365 on the tiled design
    (fly_slack, within 10 % of the JAX package's CPU f64 distance: the
    mission-level band), QPFAILED no more than JAX's f64 run's.  The
    precision gate (kernels_vs_plain_cycles): from the state before each
    of the 20 cycles, that cycle on the tiled kernels against the same
    cycle with the plain chol versions in f64 on the card, each with the
    same QPFAILED agents, the kernels' max primal residual <=
    max(F64_PRIMAL_TOL, F64_PLAIN_RATIO x the plain versions') and max
    gap <= F64_PLAIN_RATIO x theirs.
    The trajectories' difference and the distances from JAX's and the
    port's own CPU f64 runs are printed.  Returns the launches."""
    sim, param, summary, launches = fly_slack(
        dev, "rsfc64", torch.float64, JAX_CPU_F64_RSFC64, 0.1, "tiled")
    cycles = summary["iterations"]
    if summary["qp_failures"] > JAX_CPU_F64_RSFC64[2]:
        raise AssertionError(f"rsfc64 f64: {summary['qp_failures']} "
                             f"QPFAILED, JAX CPU f64 {JAX_CPU_F64_RSFC64[2]}")
    per_cycle = kernels_vs_plain_cycles(sim, cycles)
    bad = [c for c in per_cycle
           if c[2][0] != c[3][0] or
           not c[2][1] <= max(F64_PRIMAL_TOL, F64_PLAIN_RATIO * c[3][1]) or
           not c[2][2] <= F64_PLAIN_RATIO * c[3][2]]
    if bad:
        raise AssertionError(f"rsfc64 f64: cycles on the tiled kernels "
                             f"against the plain chol versions from the "
                             f"same state, (cycle, max |traj diff| m, "
                             f"(QPFAILED, primal, gap) tiled, plain): {bad} "
                             f"(limits: primal max({F64_PRIMAL_TOL}, "
                             f"{F64_PLAIN_RATIO} x plain), gap "
                             f"{F64_PLAIN_RATIO} x plain)")
    dist = summary["total_flight_distance"]
    phase("15 modes", f"rsfc64 f64 (the slack QP at n = {kkt_n(sim, param)}"
                      f", tiled): {cycles} cycles, distance {dist:.6f} m "
                      f"(JAX CPU f64 {JAX_CPU_F64_RSFC64[0]:.6f} m, "
                      f"{100 * (dist / JAX_CPU_F64_RSFC64[0] - 1):+.4f} %; "
                      f"the port's CPU f64 run {PORT_CPU_F64_RSFC64[0]:.6f}"
                      f" m, {100 * (dist / PORT_CPU_F64_RSFC64[0] - 1):+.4f} "
                      "%), "
                      f"safety {summary['safety_ratio_agent']:.4f} (JAX "
                      f"{JAX_CPU_F64_RSFC64[1]}), {summary['qp_failures']} "
                      f"QPFAILED (JAX {JAX_CPU_F64_RSFC64[2]}), "
                      f"{1e3 * summary['wall_time'] / cycles:.2f} ms/cycle, "
                      f"launches {launches}")
    phase("15 modes", "rsfc64 f64, each cycle from the kernels' state on "
                      "the tiled kernels and on the plain chol versions, "
                      "tiled/plain by cycle (limits: primal max("
                      f"{F64_PRIMAL_TOL:.0e}, {F64_PLAIN_RATIO:g} x plain), "
                      f"gap {F64_PLAIN_RATIO:g} x plain): max primal " +
          " ".join(f"{c[2][1]:.1e}/{c[3][1]:.1e}" for c in per_cycle) +
          "; max gap " + " ".join(f"{c[2][2]:.1e}/{c[3][2]:.1e}"
                                  for c in per_cycle) +
          "; max |traj diff| m " + " ".join(f"{c[1]:.1e}"
                                            for c in per_cycle) +
          "; QPFAILED agents the same in every cycle")
    return launches


def fly_exp64(dev):
    """exp64: experiment mode through cycle() and inject_positions (run()
    paces itself to real time): before cycle EXP_INJECT_CYCLE the agents
    EXP_PUSHED are observed 0.3-0.5 m off; that cycle's slack QP stays
    finite and near-feasible (max primal residual < 0.1, as
    tests/test_disturbance.py), the pushed agents' SFCs were re-seeded and
    every flag is cleared after it; then to the finish or 60 cycles,
    safety > 0.8 after the injection cycle (test_disturbance.py's
    bound)."""
    sim, param, cycles = mode_sim(dev, "exp64")
    reset_launch_counts()
    t0 = time.perf_counter()
    out = fly_cycles(sim, sim.cycle, cycles, inject=True)
    torch.cuda.synchronize()
    done = out["cycles"]
    ms = 1e3 * (time.perf_counter() - t0) / done
    launches = check_launches(
        "exp64", **chol_launches(param, done, kkt_n(sim, param)))
    pushed = list(EXP_PUSHED)
    checks = {
        "inject flags": list(out["flags_set"]) == pushed,
        "SFC re-seeded": list(out["sfc_reset"]) == pushed,
        "finite": out["inject_finite"],
        "primal < 0.1": out["inject_primal"] < 0.1,
        "flags cleared": out["flags_after"] == 0 and out["sfc_after"],
        "safety after > 0.8": out["safety_after"] > 0.8,
    }
    if not all(checks.values()):
        raise AssertionError(f"exp64: {checks}, {out}")
    phase("15 modes", f"exp64 (experiment mode, {len(pushed)} agents pushed "
                      f"0.3-0.5 m before cycle {EXP_INJECT_CYCLE}): that "
                      f"cycle's max primal residual {out['inject_primal']:.2e}"
                      f", flags set {pushed} and cleared, SFCs re-seeded; "
                      f"{done} cycles"
                      f"{' (finished)' if out['finished'] else ''}"
                      f", min safety after it {out['safety_after']:.4f} "
                      f"(overall {out['safety']:.4f}), {out['qp_failures']} "
                      f"QPFAILED, distance {out['distance']:.4f} m; JAX CPU "
                      f"f32: {JAX_CPU_F32_EXP64}; {ms:.2f} ms/cycle "
                      f"(cycle() with a host read a cycle, the injection "
                      f"included); launches {launches}")


def fly_circle64_2d(dev):
    """circle64-2d to the finish through the one-warp chol kernels (n =
    26): z within 0.05 m of z_2d, cycles within the band of the JAX
    package's CPU f32 run; then CAPTURE_K captured cycles after
    CAPTURE_BEFORE against uncaptured ones, bit for bit."""
    sim, param, _ = mode_sim(dev, "circle64_2d")
    reset_launch_counts()
    summary = sim.run()
    torch.cuda.synchronize()
    cycles = summary["iterations"]
    launches = check_launches("circle64-2d",
                              **chol_launches(param, cycles,
                                              kkt_n(sim, param)))
    check_mission(summary, param, sim.N, "circle64-2d")
    z_err = (summary["final_state"].traj[..., 2] -
             param.world_z_2d).abs().max().item()
    if not z_err <= 0.05 or not in_band(cycles, JAX_CPU_F32_2D64[0]):
        raise AssertionError(f"circle64-2d: z off by {z_err} m, {cycles} "
                             f"cycles (JAX CPU f32 {JAX_CPU_F32_2D64[0]})")
    phase("15 modes", f"circle64-2d finished in {cycles} cycles (JAX CPU "
                      f"f32: {JAX_CPU_F32_2D64[0]}), safety "
                      f"{summary['safety_ratio_agent']:.4f} (JAX "
                      f"{JAX_CPU_F32_2D64[1]}), 0 QPFAILED, z within "
                      f"{z_err:.2e} m of z_2d, "
                      f"{1e3 * summary['wall_time'] / cycles:.2f} ms/cycle, "
                      f"launches {launches}")
    captured_bits(sim, "circle64-2d", name="15 modes")
    return launches


def fly_circle128_2d(dev):
    """circle128-2d, 20 all-pairs cycles (C = 128) through the fused IPM's
    2-D instantiation ("auto"): one launch a cycle, safety >= 1, 0
    QPFAILED, distance within 10 % of the JAX package's CPU run of the
    same cycles (its f64 run: its f32 run drifts, see JAX_CPU_2D128).
    Returns the launches."""
    sim, param, cycles = mode_sim(dev, "circle128_2d")
    reset_launch_counts()
    summary = sim.run(max_iterations=cycles)
    torch.cuda.synchronize()
    launches = check_launches("circle128-2d", fused_ipm=cycles,
                              lsc_planes=cycles)
    check_mission(summary, param, sim.N, "circle128-2d", finished=False)
    dist = summary["total_flight_distance"]
    if not abs(dist - JAX_CPU_2D128[1]) <= 0.1 * JAX_CPU_2D128[1]:
        raise AssertionError(f"circle128-2d: distance {dist} m, JAX CPU f64 "
                             f"{JAX_CPU_2D128[1]} m")
    phase("15 modes", f"circle128-2d, {cycles} cycles through the 2-D fused "
                      f"IPM: distance {dist:.4f} m (JAX CPU: f32 "
                      f"{JAX_CPU_2D128[0]:.4f} m, f64 {JAX_CPU_2D128[1]:.4f}"
                      f" m), safety {summary['safety_ratio_agent']:.4f}, 0 "
                      f"QPFAILED, {1e3 * summary['wall_time'] / cycles:.2f} "
                      f"ms/cycle, launches {launches}")
    return launches


def fly_rh64(dev):
    """rh64: 40 cycles under GoalMode.RIGHT_HAND: safety >= 1, finite
    trajectories, JAX's distance beside the port's."""
    sim, param, cycles = mode_sim(dev, "rh64")
    reset_launch_counts()
    summary = sim.run(max_iterations=cycles)
    torch.cuda.synchronize()
    done = summary["iterations"]
    launches = check_launches(
        "rh64", **chol_launches(param, done, kkt_n(sim, param)))
    check_mission(summary, param, sim.N, "rh64", finished=False)
    phase("15 modes", f"rh64 (RIGHT_HAND), {done} cycles: distance "
                      f"{summary['total_flight_distance']:.4f} m (JAX CPU "
                      f"f32: {JAX_CPU_F32_RH64[0]:.4f} m in "
                      f"{JAX_CPU_F32_RH64[1]} cycles), safety "
                      f"{summary['safety_ratio_agent']:.4f}, 0 QPFAILED, "
                      f"{1e3 * summary['wall_time'] / done:.2f} ms/cycle")


def fly_modes(dev, rsfc96_chol_ms):
    """Phase 15: the other planner modes.  Returns the launches of the
    large-n chol kernels (rsfc64: the cluster kernels; rsfc96 and rsfc64
    in f64: the tiled design) and of the 2-D fused IPM (circle128-2d)."""
    fly_bvc64(dev)
    large = fly_rsfc64(dev)
    tiled = fly_rsfc96(dev, rsfc96_chol_ms)
    tiled64 = fly_rsfc64_f64(dev)
    fly_exp64(dev)
    fly_circle64_2d(dev)
    fused2d = fly_circle128_2d(dev)
    fly_rh64(dev)
    return large, tiled, tiled64, fused2d


def orca_sim(dev, name):
    """(simulator on the card in f32, Param, cycles) of ORCA_CASES[name]."""
    tm, kw, cycles = orca_case(name)
    param = Param(**kw)
    return (SyncSimulator(tm, param, device=dev, dtype=torch.float32), param,
            cycles)


def check_orca(summary, sim, name, cycles):
    """An ORCA run() summary against the JAX package's CPU f32 run of the
    same mission: to the finish (cycles None) within max(20 %, 10) of its
    cycles, else its distance within 10 %; min sampled safety > 0.75
    (tests/test_orca.py's bar: ORCA is not hard-safe), finite positions,
    no kernel launched.  Returns the line's gate text."""
    ref_cycles, ref_dist, ref_safety = JAX_CPU_F32_ORCA[name]
    done, dist = summary["iterations"], summary["total_flight_distance"]
    safety = summary["safety_ratio_agent"]
    check_launches(name)
    if not bool(torch.isfinite(summary["final_state"].pos).all()):
        raise AssertionError(f"{name}: non-finite final positions")
    if not safety > 0.75:
        raise AssertionError(f"{name}: min safety {safety} <= 0.75")
    rel = abs(dist - ref_dist) / ref_dist
    if cycles is None:
        if not (done < ORCA_CAP and in_band(done, ref_cycles)):
            raise AssertionError(f"{name}: {done} cycles against JAX's "
                                 f"{ref_cycles} (cap {ORCA_CAP})")
        gate = f"finished in {done} cycles (JAX CPU f32: {ref_cycles})"
    else:
        if not rel <= 0.10:
            raise AssertionError(f"{name}: distance {dist} m, {100 * rel:.1f}"
                                 f" % off JAX's {ref_dist} m (limit 10 %)")
        gate = f"{done} cycles"
    return (f"{gate}, distance {dist:.4f} m (JAX CPU f32 {ref_dist:.4f} m, "
            f"{100 * rel:.2f} % off), min safety {safety:.4f} (JAX "
            f"{ref_safety:.4f})")


def fly_orca_captured(sim, name, cycles, uncaptured):
    """The same mission through run(steps_per_dispatch=CAPTURE_K): the
    uncaptured run's cycles and distance, bit for bit.  Returns its
    summary."""
    reset_launch_counts()
    summary = sim.run(max_iterations=cycles or ORCA_CAP,
                      steps_per_dispatch=CAPTURE_K)
    torch.cuda.synchronize()
    check_launches(name + " captured")
    if (summary["iterations"], summary["total_flight_distance"]) != (
            uncaptured["iterations"], uncaptured["total_flight_distance"]):
        raise AssertionError(
            f"{name} captured: {summary['iterations']} cycles, "
            f"{summary['total_flight_distance']} m against "
            f"{uncaptured['iterations']}, "
            f"{uncaptured['total_flight_distance']} m uncaptured")
    return summary


def continuous_audit(sim, what, cycles=20):
    """The continuous-time audit of sim's trajectories after `cycles`
    cycles beside a sampled audit of the same trajectories over their
    whole horizon (1,000 samples): the continuous ratio may never exceed
    the sampled one by more than 1e-4 (it is a lower bound).  Returns
    (continuous, sampled)."""
    state = sim.initial_state()
    for _ in range(cycles):
        state, _ = sim.cycle(state)
    p = sim.param
    cont = float(audit.continuous_safety_ratio(state.traj, sim.radius,
                                               sim.downwash))
    ts = np.linspace(0.0, p.M * p.dt, 1001)[:-1]
    pos = audit.positions_at(state.traj, ts, p.dt)
    sampled = float(audit.pairwise_safety_ratio(pos, sim.radius,
                                                sim.downwash).min())
    if not cont <= sampled + 1e-4:
        raise AssertionError(f"{what}: continuous audit {cont} above the "
                             f"sampled {sampled}")
    phase("16 orca", f"{what} at cycle {cycles}: continuous audit "
                     f"{cont:.6f}, sampled over the horizon {sampled:.6f}")
    return cont, sampled


def cycle_kernels(sim, state):
    """CUDA kernels (launches, memory copies and sets apart) of one
    uncaptured cycle from `state`, counted by torch.profiler as
    scripts/profile_forest20_torch.py counts them, and the cycle's peak
    device memory (torch.cuda.max_memory_allocated) in MiB."""
    sim.cycle(state)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        sim.cycle(state)
        torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    device = [e for e in prof.key_averages()
              if str(getattr(e, "device_type", "")).endswith("CUDA")]
    copies = sum(e.count for e in device
                 if e.key.startswith(("Memcpy", "Memset")))
    kernels = sum(e.count for e in device) - copies
    return kernels, copies, peak / 2 ** 20, (peak - base) / 2 ** 20


def fly_orca(dev, circle_sim):
    """Phase 16: the ORCA planner and the host surface (see the module
    docstring)."""
    # orca64 to the finish, uncaptured and captured, and its audit
    sim, param, cycles = orca_sim(dev, "orca64")
    reset_launch_counts()
    run = sim.run(max_iterations=cycles or ORCA_CAP)
    torch.cuda.synchronize()
    gate = check_orca(run, sim, "orca64", cycles)
    cap = fly_orca_captured(sim, "orca64", cycles, run)
    wall_ms = 1e3 * run['wall_time'] / run['iterations']
    phase("16 orca", f"orca64 (ORCA, STATIC goals): {gate}; ms/cycle "
                     f"uncaptured {wall_ms:.2f} (run wall / cycles; "
                     f"{1e3 * run['average_planning_time']:.2f} mean after "
                     f"the first), captured "
                     f"{1e3 * cap['average_planning_time']:.2f} (blocks "
                     f"after the first, {CAPTURE_K} cycles a block; the "
                     "same cycles and distance, 0 kernel launches)")
    continuous_audit(sim, "orca64")
    del sim

    for name in ("orca64_goal", "orca64_2d"):
        sim, param, cycles = orca_sim(dev, name)
        reset_launch_counts()
        run = sim.run(max_iterations=cycles)
        torch.cuda.synchronize()
        gate = check_orca(run, sim, name, cycles)
        if param.world_dimension == 2:
            z = run["final_state"].pos[:, 2]
            dz = float((z - param.world_z_2d).abs().max())
            if not dz <= 0.05:
                raise AssertionError(f"{name}: z {dz} m off the plane")
            gate += f", max |z - z_2d| {dz:.2e} m"
        phase("16 orca", f"{name}: {gate}; "
                         f"{1e3 * run['wall_time'] / run['iterations']:.2f} "
                         "ms/cycle uncaptured")
        del sim

    # orca1024: 40 cycles uncaptured and captured, the graph's bits, the
    # kernels a cycle and the peak memory
    sim, param, cycles = orca_sim(dev, "orca1024")
    reset_launch_counts()
    run = sim.run(max_iterations=cycles)
    torch.cuda.synchronize()
    gate = check_orca(run, sim, "orca1024", cycles)
    cap = fly_orca_captured(sim, "orca1024", cycles, run)
    captured_bits(sim, "orca1024", name="16 orca")
    state = sim.initial_state()
    for _ in range(CAPTURE_BEFORE):
        state, _ = sim.cycle(state)
    kernels, copies, peak, extra = cycle_kernels(sim, state)
    phase("16 orca", f"orca1024: {gate}; ms/cycle uncaptured "
                     f"{1e3 * run['wall_time'] / cycles:.2f} (run wall / "
                     f"cycles; {1e3 * run['average_planning_time']:.2f} "
                     "mean after the first), captured "
                     f"{1e3 * cap['average_planning_time']:.2f}; one "
                     f"uncaptured cycle after {CAPTURE_BEFORE}: {kernels} "
                     f"CUDA kernels, {copies} copies and sets "
                     f"(torch.profiler), peak device memory {peak:.1f} MiB "
                     f"({extra:.1f} MiB above the state's)")
    del sim

    # the continuous audit on LSC trajectories, and stage profiles
    cont, _ = continuous_audit(circle_sim, "circle64 (LSC)")
    if not cont >= 1.0:
        raise AssertionError(f"circle64: continuous audit {cont} < 1")
    prof = circle_sim.run(max_iterations=20, profile=True)
    torch.cuda.synchronize()
    st = stage_times(circle_sim, [
        (circle_sim.goal_planner, "plan", "goal_planning"),
        (constraints, "lsc_planes", "lsc_generation"),
        (circle_sim.optimizer, "solve", "traj_optimization")])
    phase("16 orca", "circle64 run(max_iterations=20, profile=True) "
                     "stage_times, ms (profile_stages: each stage alone "
                     "from the final state, the mean of 5 synced calls): " +
          ", ".join(f"{k} {1e3 * v:.2f}"
                    for k, v in prof["stage_times"].items()))
    phase("16 orca", "the same stages inside cycles (stage_times: median "
                     "of 5 cycles after 20, a sync around each call; "
                     "lsc_planes without the K-NN selection, solve with "
                     "the SFC rows it is given): " +
          ", ".join(f"{k} {v:.2f}" for k, v in st.items()))

    # the CLI, as a user runs it
    fly_cli()


def sharded_world_of_one(dev, mission, param, cycles):
    """17a: a process group of one rank (this process) on nccl, the
    mission's cycles through make_sharded_cycle, each cycle also run by
    sim.cycle from the same state.  Returns (differing traj bits over the
    cycles, ms a sharded cycle with its stats read, the sharded cycles'
    fused-IPM launches)."""
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group(
            "nccl", init_method="file://" + os.path.join(tmp, "store"),
            world_size=1, rank=0)
        try:
            sim = SyncSimulator(mission, param, device=dev,
                                dtype=torch.float32)
            cycle = shard.make_sharded_cycle(sim, shard.make_mesh(
                device=dev))
            state = cycle.shard(sim.initial_state())
            sim_mod.synchronize(dev)
            reset_launch_counts()
            bits, seconds, fused = 0, [], 0
            for _ in range(cycles):
                before = ipm.fused_launches
                t0 = time.perf_counter()
                nxt, info = cycle(state)
                safety, failed, _ = cycle.stats(nxt, info).tolist()
                seconds.append(time.perf_counter() - t0)
                fused += ipm.fused_launches - before
                if safety < 1.0 or failed:
                    raise AssertionError(f"17a: safety {safety}, "
                                         f"{int(failed)} QPFAILED")
                ref, _ = sim.cycle(state)
                bits += differing_bits(nxt.traj, ref.traj)
                state = nxt
        finally:
            dist.destroy_process_group()
    return bits, 1e3 * statistics.mean(seconds[1:]), fused


def slowest_ms(results, key="seconds"):
    """The slowest rank's mean ms a cycle after the first."""
    return max(1e3 * float(np.mean(r[key][1:])) for r in results)


def check_rank_launches(what, results, want):
    """Each rank's kernel launches (its launch_counts() over the run) are
    `want` (0 for a kernel not named)."""
    for rank, r in enumerate(results):
        got = r["launches"]
        expect = {k: want.get(k, 0) for k in got}
        if got != expect:
            raise AssertionError(f"{what}: rank {rank} kernel launches "
                                 f"{got}, expected {expect}")


def fly_sharded(dev, big_run):
    """Phase 17: the sharded cycle (parallel/shard.py) on the card.
    big_run is phase 8's run of circle1024.  17a: a world of one rank on
    nccl against sim.cycle, 0 differing traj bits.  17b: SHARD_RANKS gloo
    ranks as processes sharing the card: gates min safety >= 1, 0
    QPFAILED, one fused launch a rank a cycle, distance within 10 % of
    phase 8's; the trajectories at SHARD_DIFF_CYCLE against the single
    process's (printed, not gated: the factored QP's static-row
    equilibration is a max over the batch, which a rank's block may not
    share);
    profile_sharded.  17c: the same ranks as 2 hosts x 2 chips, 0
    differing bits against 17b.  17d: lanes1024 through run(cycle_fn=...)
    with the halo and the sort: in f64 finished, safe, 0 QPFAILED; in f32
    safe, 0 QPFAILED, the agents not home printed; ms a cycle and exchange
    ms beside the all_gather exchange's.  17e:
    dryrun_multichip(SHARD_RANKS, "gloo", "cuda").  Returns rank 0's fused-IPM
    launches in 17b."""
    smi = smi_line()
    n, cycles, world, lanes_n = BIG_N, SHARD_CYCLES, SHARD_RANKS, LANES_N
    param = Param(goal_mode=GoalMode.PRIOR_BASED, max_neighbors=BIG_K)
    mission = circle_mission(n)
    t_phase = time.perf_counter()

    bits, ms_one, fused_one = sharded_world_of_one(dev, mission, param,
                                                   cycles)
    if bits or fused_one != cycles:
        raise AssertionError(f"17a: {bits} differing traj bits, "
                             f"{fused_one} fused launches in {cycles} "
                             "cycles")
    ms_8 = big_run["average_planning_time"] * 1e3
    phase("17 sharded", f"17a nccl world of one: circle{n} K={BIG_K}, "
                        f"{cycles} cycles through make_sharded_cycle, each "
                        "against sim.cycle from the same state: 0 "
                        f"differing traj bits, {fused_one} fused launches;"
                        f" {ms_one:.2f} ms/cycle with the stats read "
                        f"(phase 8: {ms_8:.2f} ms mean after the first) "
                        f"[{smi}]")

    # the single process's trajectories at SHARD_DIFF_CYCLE
    single = SyncSimulator(mission, param, device=dev, dtype=torch.float32)
    state = single.initial_state()
    for _ in range(SHARD_DIFF_CYCLE):
        state, _ = single.cycle(state)
    single_traj = state.traj.cpu().numpy()

    lanes = make_lane_mission(lanes_n)
    lane_param = Param(goal_mode=GoalMode.PRIOR_BASED,
                       max_neighbors=LANES_K)
    f32, keep = torch.float32, (SHARD_DIFF_CYCLE, cycles)
    t0 = time.perf_counter()
    out = spawn_ranks(
        ranks.sequence, world, "gloo",
        (ranks.fly_cycles, (mission, param, f32, "cuda", cycles),
         dict(keep=keep)),
        (ranks.fly_cycles, (mission, param, f32, "cuda", cycles),
         dict(keep=keep, mesh_shape=(2, world // 2))),
        (ranks.profile, (mission, param, f32, "cuda"), {}),
        (ranks.run_mission, (lanes, lane_param, torch.float64,
                             "cuda", LANES_CAP),
         dict(halo_shards=1, sort_key="axis:1")),
        (ranks.run_mission, (lanes, lane_param, f32, "cuda",
                             LANES_F32_CYCLES),
         dict(halo_shards=1, sort_key="axis:1")),
        (ranks.fly_cycles, (lanes, lane_param, f32, "cuda",
                            LANES_AG_CYCLES), dict(keep=())),
        (ranks.profile, (lanes, lane_param, f32, "cuda"),
         dict(halo_shards=1)),
        (ranks.profile, (lanes, lane_param, f32, "cuda"), {}))
    spawn_s = time.perf_counter() - t0
    (flat, grid, prof, lane_run, lane_f32, lane_ag, prof_halo,
     prof_ag) = zip(*out)

    # 17b
    L = n // world
    check_rank_launches("17b", flat, {"fused_ipm": cycles,
                                      "lsc_planes": cycles})
    safety = min(float(r["safety"].min()) for r in flat)
    failed = int(sum(r["failed"].sum() for r in flat))
    dist_b = flat[0]["distance"]
    rel = abs(dist_b - big_run["total_flight_distance"]) / \
        big_run["total_flight_distance"]
    if not (safety >= 1.0 and failed == 0 and rel <= 0.10):
        raise AssertionError(f"17b: safety {safety}, {failed} QPFAILED, "
                             f"distance {dist_b} m ({100 * rel:.1f} % off "
                             "phase 8's, limit 10 %)")
    for r in flat[1:]:
        for c in keep:
            if differing_bits(torch.as_tensor(r["traj"][c]),
                              torch.as_tensor(flat[0]["traj"][c])):
                raise AssertionError("17b: ranks disagree on the swarm")
    diff = float(np.abs(flat[0]["traj"][SHARD_DIFF_CYCLE] -
                        single_traj).max())
    p = prof[0]
    phase("17 sharded", f"17b {world} gloo ranks sharing the card, "
                        f"circle{n} K={BIG_K}, all_gather, {cycles} cycles,"
                        f" L={L} (one fused launch a rank a cycle at B={L},"
                        f" C={BIG_K}): slowest rank "
                        f"{slowest_ms(flat):.2f} ms/cycle (phase 8: "
                        f"{ms_8:.2f}), min safety {safety:.4f}, 0 QPFAILED,"
                        f" distance {dist_b:.2f} m (phase 8 "
                        f"{big_run['total_flight_distance']:.2f} m, "
                        f"{100 * rel:.2f} % off), traj max diff from the "
                        f"single process at cycle {SHARD_DIFF_CYCLE} "
                        f"{diff:.3e} m; profile_sharded exchange "
                        f"{1e3 * p['exchange']:.3f} ms, cycle "
                        f"{1e3 * p['cycle_total']:.2f} ms [{smi}]")

    # 17c
    check_rank_launches("17c", grid, {"fused_ipm": cycles,
                                      "lsc_planes": cycles})
    bits_c = sum(differing_bits(torch.as_tensor(g["traj"][c]),
                                torch.as_tensor(f["traj"][c]))
                 for g, f in zip(grid, flat) for c in keep)
    if bits_c or grid[0]["distance"] != dist_b:
        raise AssertionError(f"17c: {bits_c} differing bits against 17b, "
                             f"distance {grid[0]['distance']} against "
                             f"{dist_b}")
    phase("17 sharded", f"17c the same {world} ranks as 2 hosts x "
                        f"{world // 2} chips (all_gather): 0 differing traj"
                        f" bits against 17b at cycles {keep}, distance "
                        f"equal; slowest rank {slowest_ms(grid):.2f} "
                        "ms/cycle")

    # 17d
    s0 = lane_run[0]
    for s in lane_run[1:]:
        if any(s[k] != s0[k] for k in ("iterations", "qp_failures",
                                        "total_flight_distance")):
            raise AssertionError("17d: ranks disagree on the run")
    if not (s0["iterations"] < LANES_CAP and not s0["is_collided"] and
            s0["safety_ratio_agent"] >= 1.0 and s0["qp_failures"] == 0):
        raise AssertionError(
            f"17d: lanes{lanes_n} {s0['iterations']} cycles (cap "
            f"{LANES_CAP}), safety {s0['safety_ratio_agent']}, "
            f"{s0['qp_failures']} QPFAILED")
    check_rank_launches("17d f64", lane_run, {
        "factor_solve": s0["iterations"] * lane_param.qp_iterations,
        "resolve": s0["iterations"] * lane_param.qp_iterations *
        (1 + lane_param.qp_correctors), "lsc_planes": s0["iterations"]})
    f64_ms = max(1e3 * s["average_planning_time"] for s in lane_run)
    phase("17 sharded", f"17d lanes{lanes_n} K={LANES_K} f64 on {world} "
                        "ranks, halo 1 with an axis:1 sort before every "
                        f"cycle, run(cycle_fn=...): finished in "
                        f"{s0['iterations']} cycles, min safety "
                        f"{s0['safety_ratio_agent']:.4f}, 0 QPFAILED, "
                        f"{s0['total_flight_distance']:.2f} m, chol "
                        f"launches on rank 0 {s0['launches']['factor_solve']}"
                        f" + {s0['launches']['resolve']}; slowest rank "
                        f"{f64_ms:.2f} ms/cycle (sort included)")
    s1 = lane_f32[0]
    fs = s1["final_state"]
    away = np.linalg.norm(fs["pos"] - fs["desired_goal"], axis=-1) >= \
        lane_param.goal_threshold
    if not (s1["safety_ratio_agent"] >= 1.0 and s1["qp_failures"] == 0):
        raise AssertionError(f"17d f32: safety {s1['safety_ratio_agent']},"
                             f" {s1['qp_failures']} QPFAILED")
    check_rank_launches("17d f32", lane_f32,
                        {"fused_ipm": s1["iterations"],
                         "lsc_planes": s1["iterations"]})
    near = np.abs(fs["start"][:, 1]) <= 150.0
    far_y = np.sort(fs["start"][away, 1])
    span = f"{far_y[0]:.1f}..{far_y[-1]:.1f} m" if far_y.size else "none"
    halo_ms = max(1e3 * s["average_planning_time"] for s in lane_f32)
    phase("17 sharded", f"17d the same in f32, {s1['iterations']} cycles: "
                        f"min safety {s1['safety_ratio_agent']:.4f}, 0 "
                        f"QPFAILED, {int(away.sum())} of {lanes_n} agents "
                        f"not home ({int((away & near).sum())} of the "
                        f"{int(near.sum())} within 150 m of the origin; "
                        f"the lanes of those not home at y {span}), one "
                        "fused launch a rank a cycle; slowest rank "
                        f"{halo_ms:.2f} ms/cycle (sort included), exchange "
                        f"{1e3 * prof_halo[0]['exchange']:.3f} ms; the "
                        f"all_gather exchange, {LANES_AG_CYCLES} cycles: "
                        f"{slowest_ms(lane_ag):.2f} ms/cycle, exchange "
                        f"{1e3 * prof_ag[0]['exchange']:.3f} ms [{smi}]")
    phase("17 sharded", f"17b-17d: one spawn of {world} ranks, "
                        f"{spawn_s:.1f} s")

    # 17e
    t0 = time.perf_counter()
    parts = shard.dryrun_multichip(world, "gloo", "cuda")
    got = sorted(parts[0])
    phase("17 sharded", f"17e dryrun_multichip({world}, 'gloo', 'cuda'): "
                        f"parts {got} passed on every rank (b: halo vs "
                        f"all_gather {parts[0]['b']['max_diff']:.2e} m; e: "
                        f"fallback {parts[0]['e']['fallback_err']:.2e} m), "
                        f"{time.perf_counter() - t0:.1f} s; phase 17 "
                        f"{time.perf_counter() - t_phase:.1f} s")
    return flat[0]["launches"]["fused_ipm"]


def fly_cli():
    """python -m lsc_planner_tpu_torch.cli: a generated 64-agent circle,
    20 cycles on the card with the result CSV saved, and its replay: the
    summary's keys and the replayed start positions."""
    from lsc_planner_tpu_torch.missions import load_mission
    from lsc_planner_tpu_torch.sim.replay import read_result_csv
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.dirname(os.path.abspath(__file__))] +
        [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep)
         if p]))
    with tempfile.TemporaryDirectory() as tmpdir:
        mission = os.path.join(tmpdir, "circle64.json")
        logs = os.path.join(tmpdir, "log")

        def cli(*args):
            out = subprocess.run(
                ["python3", "-m", "lsc_planner_tpu_torch.cli", *args],
                capture_output=True, text=True, env=env, timeout=300)
            if out.returncode:
                raise AssertionError(f"cli {args}: exit {out.returncode}\n"
                                     f"{out.stderr[-2000:]}")
            return out.stdout.strip().splitlines()[-1]
        t0 = time.perf_counter()
        cli("--generate", "circle:64", "--out", mission)
        summary = json.loads(cli("--mission", mission, "--max-iterations",
                                 "20", "--save-result", "--log-dir", logs))
        keys = {"mission", "stage_times", "total_flight_time",
                "total_flight_distance", "is_collided", "safety_ratio_agent",
                "safety_ratio_obs", "average_planning_time",
                "min_planning_time", "max_planning_time", "iterations",
                "qp_failures", "wall_time", "planner_mode"}
        if set(summary) != keys or summary["iterations"] != 20 or \
                summary["is_collided"]:
            raise AssertionError(f"cli: summary {summary}")
        (csv,) = [f for f in os.listdir(logs) if f.startswith("result_")]
        replay = json.loads(cli("--replay", os.path.join(logs, csv)))
        data = read_result_csv(os.path.join(logs, csv))
        starts = np.stack([a.start for a in load_mission(mission).agents])
        err = float(np.abs(data.pos[0] - starts).max())
        if replay["agents"] != 64 or replay["rows"] != 40 or not err <= 1e-5:
            raise AssertionError(f"cli: replay {replay}, start error {err}")
        phase("16 orca", f"cli: --generate circle:64, --mission (20 cycles "
                         f"on the card, safety "
                         f"{summary['safety_ratio_agent']:.4f}, "
                         f"{1e3 * summary['average_planning_time']:.2f} ms "
                         f"mean) --save-result, --replay: {replay['rows']} "
                         f"rows of {replay['agents']} agents, start "
                         f"positions within {err:.1e} m of the mission's; "
                         f"{time.perf_counter() - t0:.1f} s for the three "
                         "processes")


def main():
    # 1. the card
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke needs a CUDA device; "
                           "torch.cuda.is_available() is False")
    dev = torch.device("cuda")
    print(smi_line(), flush=True)
    phase("1 device", f"{torch.cuda.get_device_name(0)}, torch "
                      f"{torch.__version__}, CUDA {torch.version.cuda}")

    # 2. build (the one-block measurement build of chol.cu beside it)
    t0 = time.perf_counter()
    chol_builds = chol_builds_start()
    _build.load_library()
    built = trace.last_seconds("build.nvcc")
    phase("2 build", f"{_build.library_path().name}: nvcc "
                     f"{'%.2f s' % built if built is not None else 'cached'}"
                     f", load {time.perf_counter() - t0:.2f} s")
    if _build.build_log:
        summary = ptxas_summary(_build.build_log)
        phase("2 build", summary)
        phase("2 build", f"{check_no_spills(summary)} cluster chol kernel "
                         "instantiations, 0 B spilled each")
        phase("2 build", f"{check_no_spills(summary, 'tiled_')} tiled chol "
                         "kernel instantiations (the factor and the solve, "
                         "f32 and f64), 0 B spilled each")
    nf, Ru, M, n1 = 13, 69, 5, 6        # the main path's QP shape
    for B, C in ((BIG_N, BIG_K), (MAIN_B, MAIN_B), (ALL_N, ALL_N)):
        pl = ipm.fused_plan(B, nf, Ru, C, M, n1)
        phase("2 build", f"fused IPM layout at B={B}, C={C}: rows in "
                         f"{'shared' if pl['rows_in_smem'] else 'device'} "
                         f"memory, {pl['qps_a_block']} QPs a block, "
                         f"{pl['smem_bytes']} B shared a block, "
                         f"{pl['qps_an_sm']} QPs resident an SM")

    # 3. TF32 guard
    err = audit.precision_self_check(dev)
    phase("3 precision", f"positions_at f32 max error {err:.3e} m "
                         "(limit 1e-3)")

    # 4. kernels vs plain versions
    results = compare_kernels(dev)
    compare_large_chol(dev)
    large = time_large_chol(dev, {name: f.result()[0]
                                  for name, f in chol_builds.items()})
    cycle_parity(dev)

    # 5. the main path below 128 agents: the chol kernels
    qn = MAIN_B
    param = Param(goal_mode=GoalMode.PRIOR_BASED)
    sim = SyncSimulator(circle_mission(qn), param, device=dev,
                        dtype=torch.float32)
    reset_launch_counts()
    summary = sim.run()
    torch.cuda.synchronize()
    cycles = summary["iterations"]
    check_mission(summary, param, qn, "circle64")
    launches = check_launches(
        "circle64", factor_solve=cycles * param.qp_iterations,
        resolve=cycles * param.qp_iterations * (1 + param.qp_correctors),
        lsc_planes=cycles)
    ms_cycle = summary["wall_time"] / cycles * 1e3
    phase("5 mission", f"circle{qn} PRIOR_BASED f32: finished in {cycles} "
                       f"cycles (JAX CPU f32: {JAX_CPU_F32_CYCLES}), safety "
                       f"{summary['safety_ratio_agent']:.4f}, 0 QPFAILED, "
                       f"{ms_cycle:.2f} ms/cycle (run wall / cycles; "
                       f"{1e3 * summary['average_planning_time']:.2f} ms "
                       f"mean after the first), launches {launches}")

    # 6. the fused kernel vs its plain version, on the QPs of the fourth
    # cycle of the two missions that run it
    big = SyncSimulator(circle_mission(BIG_N),
                        Param(goal_mode=GoalMode.PRIOR_BASED,
                              max_neighbors=BIG_K),
                        device=dev, dtype=torch.float32)
    small = SyncSimulator(circle_mission(MAIN_B),
                          Param(goal_mode=GoalMode.PRIOR_BASED,
                                qp_fused_mode="on"),
                          device=dev, dtype=torch.float32)
    all_pairs = SyncSimulator(circle_mission(ALL_N),
                              Param(goal_mode=GoalMode.PRIOR_BASED),
                              device=dev, dtype=torch.float32)
    big_call = capture_fused_call(big, 3)
    fused = compare_fused(
        [big_call, block_of_call(big_call, BIG_N // SHARD_RANKS),
         capture_fused_call(small, 3), capture_fused_call(all_pairs, 0),
         capture_fused_call(mode_sim(dev, "circle128_2d")[0], 0)])
    fused_err, fused_ms, fused_plain_ms, fused_bound_ = fused[(BIG_N, BIG_K,
                                                              3)]

    # 7. circle64 through the fused kernel
    fly_circle64_fused(small)

    # 8. the main path at 1024 agents: K-NN pruning and the fused kernel
    fused_launches, big_run = fly_circle1024(big)

    # 9. the wavefront kernel vs its plain version, on forest20's grids
    forest = SyncSimulator(forest_mission(), Param(
        goal_mode=GoalMode.PRIOR_BASED), device=dev, dtype=torch.float32)
    wave_err, wave_ms, wave_plain_ms, wave_bound = compare_wavefront(
        dev, forest)

    # 10. the obstacle-world path: forest20 to the finish
    forest_launches, forest_sim, forest_run, forest_stages = fly_forest20(dev)

    # 11. all pairs at 128 agents: C = 128 through the fused kernel
    fly_circle128_all_pairs(all_pairs)

    # 12. several cycles a dispatch: the face-expansion kernel, then one
    # CUDA graph of CAPTURE_K cycles on each main path
    expand_err, expand_ms, expand_plain_ms, expand_bound_ = compare_expand(
        dev, forest)
    for flown, what, run, kw in (
            (sim, "circle64", summary, {}),
            (big, "circle1024", big_run, dict(max_iterations=BIG_CYCLES,
                                              finishes=False)),
            (forest_sim, "forest20", forest_run, {})):
        fly_captured(flown, what, run, **kw)
        captured_bits(flown, what)

    # 13. dynamic obstacles, evaluated on the host each cycle
    fly_dynamic(dev)

    # 14. worlds: a .bt octomap, and the exact castRay
    fly_forest20_bt(dev)
    fly_forest20_castray(dev, forest_stages)

    # 15. the other planner modes: BVC, RSFC, experiment mode, 2-D worlds,
    # the right-hand goal rule
    large_launches, tiled_launches, tiled64_launches, fused2d_launches = \
        fly_modes(dev, large["tiled"][2])

    # 16. the ORCA planner, the continuous audit, stage profiles, the CLI
    fly_orca(dev, sim)

    # 17. the sharded cycle: a world of one on nccl, gloo ranks sharing
    # the card, the 2-axis layout, the halo on lanes1024, the dry run
    block_launches = fly_sharded(dev, big_run)

    # 18. the LSC planes kernel vs its plain version, on the benchmark's
    # random1024 and on forest20
    planes = compare_planes(dev, forest)

    errs, times = results[MAIN_B]
    source = "lsc_planner_tpu_torch/csrc/chol.cu"
    tiled_src = "lsc_planner_tpu_torch/csrc/chol_tiled.cuh"

    def chol_entry(name, key, replaces, nlaunch):
        b_ms, b_by = chol_bound(key, MAIN_B, N_QP)
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": nlaunch,
                "max_abs_err": errs[key][0], "ms": times[key][0],
                "plain_ms": times[key][1], "bound_ms": b_ms,
                "bound_by": b_by, "library_ms": times[key][2]}

    def large_entry(name, key, replaces, nlaunch, shape, errs_, times_,
                    elem=4, src=source):
        b_ms, b_by = chol_bound(key, *shape, elem)
        return {"name": name, "route": "cuda", "source": src,
                "replaces": replaces, "launches": nlaunch,
                "max_abs_err": errs_[key], "ms": times_[key][0],
                "plain_ms": times_[key][1], "bound_ms": b_ms,
                "bound_by": b_by, "library_ms": times_[key][2]}
    cluster, tiled, tiled64 = (large[k] for k in ("cluster", "tiled",
                                                   "tiled f64"))
    f2 = fused[(ALL_N, ALL_N, 2)]
    fb = fused[(BIG_N // SHARD_RANKS, BIG_K, 3)]
    kernels = [
        chol_entry("chol_factor_solve", "factor_solve",
                   "lsc_planner_tpu/ops/chol_pallas.py:108",
                   launches["factor_solve"]),
        chol_entry("chol_resolve", "resolve",
                   "lsc_planner_tpu/ops/chol_pallas.py:123",
                   launches["resolve"]),
        {"name": "ipm_lsc_fused", "route": "cuda",
         "source": "lsc_planner_tpu_torch/csrc/ipm.cu",
         "replaces": "lsc_planner_tpu/ops/ipm_pallas.py:122",
         "launches": fused_launches, "max_abs_err": fused_err,
         "ms": fused_ms, "plain_ms": fused_plain_ms,
         "bound_ms": fused_bound_[0], "bound_by": fused_bound_[1],
         "library_ms": None},
        {"name": "wavefront", "route": "cuda",
         "source": "lsc_planner_tpu_torch/csrc/wavefront.cu",
         "replaces": "lsc_planner_tpu/ops/wavefront_pallas.py:28",
         "launches": forest_launches["wavefront"], "max_abs_err": wave_err,
         "ms": wave_ms, "plain_ms": wave_plain_ms,
         "bound_ms": wave_bound[0], "bound_by": wave_bound[1],
         "library_ms": None},
        # nothing on the main path calls the factor alone, as in the JAX
        # package: its launches there are 0
        chol_entry("cholesky_batched", "factor",
                   "lsc_planner_tpu/ops/chol_pallas.py:26", 0),
        {"name": "expand_boxes", "route": "cuda",
         "source": "lsc_planner_tpu_torch/csrc/corridor.cu",
         "replaces": "lsc_planner_tpu/world/corridor.py:160 "
                     "(lax.while_loop; no Pallas kernel)",
         "launches": forest_launches["expand_boxes"],
         "max_abs_err": expand_err, "ms": expand_ms,
         "plain_ms": expand_plain_ms, "bound_ms": expand_bound_[0],
         "bound_by": expand_bound_[1], "library_ms": None},
        # n > 64 where a cluster of 1 or 2 blocks holds the factor
        # (the slack QP's n = 359-384), timed on rsfc64's systems
        large_entry("chol_factor_solve (n > 64, cluster)", "factor_solve",
                    "lsc_planner_tpu/ops/chol_pallas.py:108",
                    large_launches["factor_solve_cluster"], *cluster),
        large_entry("chol_resolve (n > 64, cluster)", "resolve",
                    "lsc_planner_tpu/ops/chol_pallas.py:123",
                    large_launches["resolve_cluster"], *cluster),
        # the factor alone has no caller, as at n <= 64
        large_entry("cholesky_batched (n > 64, cluster)", "factor",
                    "lsc_planner_tpu/ops/chol_pallas.py:26", 0, *cluster),
        # past what a cluster holds (f32 n > 384, f64 n > 256): the tiled
        # design, timed on rsfc96's systems (f32) and rsfc64's in f64, with
        # the launches of those flights (phase 15)
        large_entry("chol_factor_solve (n > 64, tiled)", "factor_solve",
                    "lsc_planner_tpu/ops/chol_pallas.py:108",
                    tiled_launches["factor_solve_tiled"], *tiled,
                    src=tiled_src),
        large_entry("chol_resolve (n > 64, tiled)", "resolve",
                    "lsc_planner_tpu/ops/chol_pallas.py:123",
                    tiled_launches["resolve_tiled"], *tiled, src=tiled_src),
        large_entry("cholesky_batched (n > 64, tiled)", "factor",
                    "lsc_planner_tpu/ops/chol_pallas.py:26", 0, *tiled,
                    src=tiled_src),
        large_entry("chol_factor_solve (n > 64, tiled, f64)", "factor_solve",
                    "lsc_planner_tpu/ops/chol_pallas.py:108",
                    tiled64_launches["factor_solve_tiled"], *tiled64, elem=8,
                    src=tiled_src),
        large_entry("chol_resolve (n > 64, tiled, f64)", "resolve",
                    "lsc_planner_tpu/ops/chol_pallas.py:123",
                    tiled64_launches["resolve_tiled"], *tiled64, elem=8,
                    src=tiled_src),
        large_entry("cholesky_batched (n > 64, tiled, f64)", "factor",
                    "lsc_planner_tpu/ops/chol_pallas.py:26", 0, *tiled64,
                    elem=8, src=tiled_src),
        {"name": "ipm_lsc_fused (ndim 2)", "route": "cuda",
         "source": "lsc_planner_tpu_torch/csrc/ipm.cu",
         "replaces": "lsc_planner_tpu/ops/ipm_pallas.py:122",
         "launches": fused2d_launches["fused_ipm"], "max_abs_err": f2[0],
         "ms": f2[1], "plain_ms": f2[2], "bound_ms": f2[3][0],
         "bound_by": f2[3][1], "library_ms": None},
        # phase 17b's path: each rank's block of circle1024, timed on the
        # first L of phase 8's cycle-4 QPs; launches on rank 0
        {"name": "lsc_planes", "route": "cuda",
         "source": "lsc_planner_tpu_torch/csrc/planes.cu",
         "replaces": "none (planner/constraints.py::lsc_planes, left to XLA "
                     "in the JAX package)",
         "launches": forest_launches["lsc_planes"],
         "max_abs_err": planes["random1024 cycle 4"][0],
         "ms": planes["random1024 cycle 4"][1],
         "plain_ms": planes["random1024 cycle 4"][2],
         "bound_ms": planes["random1024 cycle 4"][3][0],
         "bound_by": planes["random1024 cycle 4"][3][1], "library_ms": None},
        {"name": "ipm_lsc_fused (a rank's block, sharded)", "route": "cuda",
         "source": "lsc_planner_tpu_torch/csrc/ipm.cu",
         "replaces": "lsc_planner_tpu/ops/ipm_pallas.py:122",
         "launches": block_launches, "max_abs_err": fb[0], "ms": fb[1],
         "plain_ms": fb[2], "bound_ms": fb[3][0], "bound_by": fb[3][1],
         "library_ms": None},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
