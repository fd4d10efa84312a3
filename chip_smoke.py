#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA GPU (an H100 is the target).

    python3 chip_smoke.py

Phases, one line each; any failure raises and exits non-zero:
  1. a CUDA device is required; prints the card's name and power limit
  2. builds the kernels from lsc_planner_tpu_torch/csrc with nvcc
  3. audit.precision_self_check on the card (the TF32 guard)
  4. each chol kernel (factor_solve, resolve, and the factor alone,
     cholesky_batched) against its plain PyTorch version at n = 39,
     B in {1, 64, 130}, on IPM-like inputs; NaN stays in a non-SPD entry;
     kernel, plain and library times (CUDA events, median of 50); plus one
     f64 cycle of an 8-agent circle on the card against the CPU
  5. flies the 64-agent circle swap (PRIOR_BASED, float32, all-pairs LSC)
     through SyncSimulator.run() on the card and checks it finished safely
     through the kernels (launch counts = cycles * 40 and cycles * 80)
  6. the fused whole-IPM kernel against its plain version (f32, both held
     to an f64 plain run) on the QPs that the fourth cycle of phases 7 and
     8 hands it (B = 64, C = 64 and B = 1024, C = 32), with tolerances off
     (3 iterations) and at Param's tolerances; both times (CUDA events,
     median of 20)
  7. flies circle64 again with qp_fused_mode="on": every cycle's QP is one
     launch of the fused kernel, and no chol kernel runs
  8. 40 cycles of the bench's 1024-agent circle swap with K-NN pruning
     (K = 32) through the fused kernel ("auto"), checked for safety and
     against the JAX package's distance flown
  9. the wavefront kernel against its plain version, bit for bit: on the
     occupancy grids of the fourth cycle of forest20 (priority and static,
     N = 20), on random grids with unreachable cells and an occupied goal,
     and where the cap ends the loop (max_iters 8 and 13); kernel and
     plain times (CUDA events, median of 20), mean relaxation steps
 10. forest20 (20 agents in a seeded synthetic forest of 60 tree columns,
     simple_forest's bbox and resolution) flown with run() on the card
     through the grid planner, the SFC corridors and the chol kernels:
     finished, agent and obstacle safety >= 1, 0 QPFAILED, cycles within
     max(20 %, 10) of the JAX package's CPU f32 run, two wavefront
     launches and 40 factor_solve launches a cycle; stage times
Then the kernels' JSON line (every kernel: launches on its main path,
error against its plain version, kernel / plain / library ms, and the
bound for the same work computed from this run's inputs), and last
{"ok": true, "device": {...}}.  The script imports nothing of JAX.
"""
import json
import math
import re
import statistics
import subprocess
import time

import numpy as np
import torch

from lsc_planner_tpu_torch import (GoalMode, ObstacleSpec, Param,
                                   make_circle_mission, make_random_mission)
from lsc_planner_tpu_torch.convert import state_to_numpy
from lsc_planner_tpu_torch.ops import _build, chol, ipm, wavefront
from lsc_planner_tpu_torch.sim import audit
from lsc_planner_tpu_torch.sim import simulator as sim_mod
from lsc_planner_tpu_torch.sim.simulator import SyncSimulator

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
OFF3 = dict(iters=3, tol_gap=0.0, tol_rp=0.0, correctors=1)
FOREST_N, FOREST_SEED, FOREST_TREES = 20, 0, 60
FOREST_WORLD = (-5.0, -5.0, 0.0, 5.0, 5.0, 2.5)     # simple_forest's bbox
# The JAX package's SyncSimulator.run() of forest20 (seed 0, PRIOR_BASED,
# Param defaults) on a CPU in float32: 101 cycles, distance 109.926 m,
# min safety 1.0253, obstacle safety 1.8926, 0 QPFAILED.
JAX_CPU_F32_FOREST_CYCLES = 101
JAX_CPU_F32_FOREST_DIST = 109.9262466430664
# H100 peaks for the bounds (NVIDIA's data sheet, SXM): f32 outside the
# tensor cores and HBM3 bandwidth
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12


def phase(name, msg):
    print(f"[{name}] {msg}", flush=True)


def bound(nbytes, ops):
    """(least ms the H100 could take, "bytes" or "operations")."""
    t_b, t_o = nbytes / PEAK_BYTES, ops / PEAK_F32_FLOPS
    return (1e3 * max(t_b, t_o), "bytes" if t_b >= t_o else "operations")


def tensor_bytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


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


def ptxas_summary(log):
    """'kernel<type>: registers, stack, spills' for each kernel in nvcc's
    -Xptxas -v output."""
    out, name = [], None
    for line in log.splitlines():
        m = re.search(r"Function properties for \S*?([a-z_]+_kernel)"
                      r"(?:I([fd])E)?", line)
        if m:
            name = m.group(1) + (f"<{m.group(2)}>" if m.group(2) else "")
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores",
                      line)
        if m and name:
            out.append(f"{name}: {m.group(1)} B stack, {m.group(2)} B "
                       "spilled")
        m = re.search(r"Used (\d+) registers", line)
        if m and out:
            out[-1] += f", {m.group(1)} registers"
    return "; ".join(out)


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


def compare_kernels(dev):
    """Phase 4: kernel vs plain at the main path's n for several B."""
    out = {}
    for B in (1, MAIN_B, 130):
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
        torch.cuda.synchronize()
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
        if not torch.equal(torch.triu(Fk, 1), torch.zeros_like(Fk)):
            raise AssertionError(f"cholesky_batched B={B}: nonzero entries "
                                 "above the diagonal")
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
              f" {t['resolve'][0]:.4f} ms vs plain {t['resolve'][1]:.4f} ms, "
              f"cholesky_solve {t['resolve'][2]:.4f} ms; cholesky_batched "
              f"err {errs['factor'][0]:.3e} (plain f32 "
              f"{errs['factor'][1]:.3e}) {t['factor'][0]:.4f} ms vs plain "
              f"{t['factor'][1]:.4f} ms, cholesky_ex {t['factor'][2]:.4f} ms")

    # a non-SPD instance turns into NaN in its own entry only
    Hs, r1, r2 = ipm_like_system(MAIN_B, N_QP, seed=7)
    Hs[5, 7, 7] = -1.0
    H = torch.as_tensor(Hs, device=dev, dtype=torch.float32)
    L, x = chol.chol_factor_solve(H, torch.as_tensor(r1, device=dev,
                                                     dtype=torch.float32))
    y = chol.chol_resolve(L, torch.as_tensor(r2, device=dev,
                                             dtype=torch.float32))
    F = chol.cholesky_batched(H)
    for name, v in (("factor_solve", x), ("resolve", y),
                    ("cholesky_batched", F.flatten(1))):
        bad = (~torch.isfinite(v).all(-1)).nonzero().flatten().tolist()
        if bad != [5]:
            raise AssertionError(f"{name}: non-finite entries {bad}, "
                                 "expected [5]")
    if not bool(torch.isnan(F[5][torch.tril(torch.ones_like(
            F[5], dtype=torch.bool))]).all()):
        raise AssertionError("cholesky_batched: the non-SPD entry's lower "
                             "triangle is not all NaN")
    phase("4 kernels", "non-SPD entry 5 of 64 -> NaN in entry 5 only")
    return out


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


def fused_obj_primal(args, y):
    """Objective 0.5 y'Py + q'y and max row violation at y, float64."""
    P_blk, q, _, U, b_pairs, nsc, scale, b_pl, F_seg, _ = args
    y3 = y.double().reshape(y.shape[0], 3, -1)
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
    (circle1024) and B = 64, C = 64 (circle64 under qp_fused_mode="on").
    The kernel is held to what f32 rounding does to the plain version: its
    y error and (at Param's tolerances, a solution rather than a third
    iterate) its objective error within 4x the plain f32 ones (+ 1e-4 m,
    + 1e-3 of the objective scale), its mean tile iteration count no
    farther from the f64 one than the plain f32 count is (or 1), and at
    Param's tolerances a primal residual < 1e-4.
    Returns the B = 1024 numbers at Param's tolerances."""
    main, failed = None, []
    for a32, prod in calls:
        a64 = [a.double() for a in a32]
        B, C = a32[5].shape[:2]
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
            phase("6 fused", f"B={B} C={C} {case}: y err {e_k:.3e} (plain "
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
            if (B, case) == (BIG_N, "param"):
                main = (e_k, t_k, t_p, fused_bound(a32, kw))
    if failed:
        raise AssertionError("fused kernel: " + "; ".join(failed))
    return main


def fused_bound(args, kw):
    """The bound of one fused IPM call: its inputs read once and outputs
    written once, against the f32 operations of the iterations these QPs
    ran (each QP's own count, from the kernel).  An iteration's operations
    are those of the factored rows (a multiply-add counts 2): the plane
    Gram through its per-segment weights W (6 dimension pairs x R rows)
    and F_seg' W F_seg on the symmetric blocks, the static rows' symmetric
    Gram, the factor (nv^3 / 3), and for each of its 2 + correctors KKT
    solves and the exit test the two row products and (KKT only) the two
    triangular substitutions (nv^2 each).  Elementwise work is left out."""
    P_blk, U, F_seg = args[0], args[3], args[8]
    C = args[5].shape[1]
    nf, Ru = P_blk.shape[-1], U.shape[1]
    nv, MI = 3 * nf, F_seg.shape[0] * F_seg.shape[1]
    R, S = C * MI, 3 * Ru
    sym, full = nf * (nf + 1) / 2, nf * nf
    gram = 4 * 6 * R + 2 * MI * (3 * sym + 3 * full) + 2 * Ru * 3 * sym
    rows = (2 * 3 * MI * nf + 6 * R + 2 * S * nf +      # A v
            2 * 3 * MI * C + 2 * nv * (Ru + MI))        # A' w
    kkts = 2 + kw.get("correctors", 0)
    per_iter = gram + nv ** 3 / 3 + kkts * (rows + 2 * nv * nv) + rows
    out = ipm.ipm_lsc_fused(*args, **kw, qp_counts=True)
    ops = per_iter * out[4].double().sum().item()
    return bound(tensor_bytes(*args) + tensor_bytes(*out), ops)


def fly_circle64_fused(sim):
    """Phase 7: circle64 with every cycle's QP through the fused kernel."""
    param = sim.param
    chol.reset_counts()
    ipm.reset_counts()
    summary = sim.run()
    torch.cuda.synchronize()
    cycles = summary["iterations"]
    check_mission(summary, param, MAIN_B, "circle64 fused")
    launches = (ipm.fused_launches, chol.factor_solve_launches,
                chol.resolve_launches)
    if launches != (cycles, 0, 0):
        raise AssertionError(f"circle64 fused: launches (fused, "
                             f"factor_solve, resolve) {launches}, expected "
                             f"({cycles}, 0, 0)")
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
    chol.reset_counts()
    ipm.reset_counts()
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
    launches = (ipm.fused_launches, chol.factor_solve_launches,
                chol.resolve_launches)
    safety, failed, overflow, iters = (np.asarray(s) for s in zip(*stats))
    dist = float(state.distance)
    if launches != (BIG_CYCLES, 0, 0):
        raise AssertionError(f"circle1024: launches (fused, factor_solve, "
                             f"resolve) {launches}, expected "
                             f"({BIG_CYCLES}, 0, 0)")
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
    return launches[0]


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


def compare_wavefront(dev, forest_sim):
    """Phase 9: the wavefront kernel against its plain version, bit for
    bit, step counts included.  Returns the numbers of the forest20
    priority grids (the first launch of a cycle)."""
    calls = capture_wavefront_calls(forest_sim, 3)
    cases = [("forest20 cycle 4, priority", *calls[0]),
             ("forest20 cycle 4, static", *calls[1])]
    for shape, max_iters in (((20, 11, 41, 41), 139), ((3, 5, 21, 21), 70),
                             ((4, 7, 13, 29), 13), ((20, 11, 41, 41), 8)):
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
        unreachable = (got >= wavefront.BIG).sum().item() - \
            (occ > 0.5).sum().item()
        phase("9 wavefront", f"{name}: N={occ.shape[0]} grid "
                             f"{tuple(occ.shape[1:])} bit-exact; mean steps "
                             f"{steps.double().mean().item():.1f} (cap "
                             f"{cap}, {int((steps >= cap).sum())} agents "
                             f"capped), unreachable free cells "
                             f"{unreachable}; {t_k:.4f} ms vs plain "
                             f"{t_p:.4f} ms")
        if main is None:
            err = (got - want).abs().max().item()
            cells = occ[0].numel()
            nbytes = tensor_bytes(occ, goal, got)
            # ~12 operations a cell a step: six neighbour loads + adds +
            # mins, the blocked test and the store
            ops = 12.0 * cells * steps.double().sum().item()
            main = (err, t_k, t_p, bound(nbytes, ops))
    return main


def stage_times(sim, cycles_before=20, timed=5):
    """Median ms of the grid goal planning, the corridor update and the
    QP in `timed` cycles after `cycles_before`, each with a sync around
    it, and of the whole cycle with the stage syncs."""
    state = sim.initial_state()
    for _ in range(cycles_before):
        state, _ = sim.cycle(state)
    times = {"goal planning (grid)": [], "corridor update": [], "QP": [],
             "cycle": []}
    orig = (sim.goal_planner.plan, sim_mod.update_sfc, sim.optimizer.solve)

    def timed_fn(fn, key):
        def run(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            times[key].append(1e3 * (time.perf_counter() - t0))
            return out
        return run
    sim.goal_planner.plan = timed_fn(orig[0], "goal planning (grid)")
    sim_mod.update_sfc = timed_fn(orig[1], "corridor update")
    sim.optimizer.solve = timed_fn(orig[2], "QP")
    try:
        for _ in range(timed):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, _ = sim.cycle(state)
            torch.cuda.synchronize()
            times["cycle"].append(1e3 * (time.perf_counter() - t0))
    finally:
        del sim.goal_planner.plan, sim.optimizer.solve
        sim_mod.update_sfc = orig[1]
    return {k: statistics.median(v) for k, v in times.items()}


def fly_forest20(dev):
    """Phase 10: forest20 to the finish through run() on the card.
    Returns the launch counts of its run."""
    param = Param(goal_mode=GoalMode.PRIOR_BASED)
    sim = SyncSimulator(forest_mission(), param, device=dev,
                        dtype=torch.float32)
    grid = sim.goal_planner.grid_planner
    occ_share = float(sim.esdf.occ.mean())
    chol.reset_counts()
    ipm.reset_counts()
    wavefront.reset_counts()
    summary = sim.run()
    torch.cuda.synchronize()
    launches = {"wavefront": wavefront.wavefront_launches,
                "factor_solve": chol.factor_solve_launches,
                "resolve": chol.resolve_launches,
                "fused": ipm.fused_launches}
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
    want = {"wavefront": 2 * cycles,
            "factor_solve": cycles * param.qp_iterations,
            "resolve": (cycles * param.qp_iterations *
                        (1 + param.qp_correctors)),
            "fused": 0}
    if launches != want:
        raise AssertionError(f"forest20: launches {launches} != {want}")
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
    st = stage_times(sim)
    phase("10 forest20", "stage ms (median of 5 cycles after 20, a sync "
                         "around each): " +
          ", ".join(f"{k} {v:.2f}" for k, v in st.items()))
    return launches


def check_mission(summary, param, qn, what):
    """A run() summary finished under the cap, safely, with no QPFAILED and
    finite final positions; raises otherwise."""
    cycles = summary["iterations"]
    pos = summary["final_state"].pos
    if not cycles < param.multisim_max_planner_iteration:
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


def main():
    # 1. the card
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke needs a CUDA device; "
                           "torch.cuda.is_available() is False")
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(smi, flush=True)
    phase("1 device", f"{torch.cuda.get_device_name(0)}, torch "
                      f"{torch.__version__}, CUDA {torch.version.cuda}")

    # 2. build
    t0 = time.perf_counter()
    _build.load_library()
    built = _build.build_seconds
    phase("2 build", f"{_build.library_path().name}: nvcc "
                     f"{'%.2f s' % built if built is not None else 'cached'}"
                     f", load {time.perf_counter() - t0:.2f} s")
    if _build.build_log:
        phase("2 build", ptxas_summary(_build.build_log))

    # 3. TF32 guard
    err = audit.precision_self_check(dev)
    phase("3 precision", f"positions_at f32 max error {err:.3e} m "
                         "(limit 1e-3)")

    # 4. kernels vs plain versions
    results = compare_kernels(dev)
    cycle_parity(dev)

    # 5. the main path below 128 agents: the chol kernels
    qn = MAIN_B
    param = Param(goal_mode=GoalMode.PRIOR_BASED)
    sim = SyncSimulator(circle_mission(qn), param, device=dev,
                        dtype=torch.float32)
    chol.reset_counts()
    ipm.reset_counts()
    summary = sim.run()
    torch.cuda.synchronize()
    launches = {"factor_solve": chol.factor_solve_launches,
                "resolve": chol.resolve_launches}
    cycles = summary["iterations"]
    check_mission(summary, param, qn, "circle64")
    if ipm.fused_launches:
        raise AssertionError(f"circle64: {ipm.fused_launches} fused launches "
                             "on the chol path")
    want = {"factor_solve": cycles * param.qp_iterations,
            "resolve": cycles * param.qp_iterations *
            (1 + param.qp_correctors)}
    if launches != want:
        raise AssertionError(f"kernel launches {launches} != {want}")
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
    fused_err, fused_ms, fused_plain_ms, fused_bound_ = compare_fused(
        [capture_fused_call(sim, 3) for sim in (big, small)])

    # 7. circle64 through the fused kernel
    fly_circle64_fused(small)

    # 8. the main path at 1024 agents: K-NN pruning and the fused kernel
    fused_launches = fly_circle1024(big)

    # 9. the wavefront kernel vs its plain version, on forest20's grids
    forest = SyncSimulator(forest_mission(), Param(
        goal_mode=GoalMode.PRIOR_BASED), device=dev, dtype=torch.float32)
    wave_err, wave_ms, wave_plain_ms, wave_bound = compare_wavefront(
        dev, forest)

    # 10. the obstacle-world path: forest20 to the finish
    forest_launches = fly_forest20(dev)

    errs, times = results[MAIN_B]
    n, B = N_QP, MAIN_B
    chol_bounds = {
        "factor_solve": bound(4 * (2 * B * n * n + 2 * B * n),
                              B * (n ** 3 / 3 + 2 * n * n)),
        "resolve": bound(4 * (B * n * n + 2 * B * n), B * 2 * n * n),
        "factor": bound(4 * 2 * B * n * n, B * n ** 3 / 3),
    }
    source = "lsc_planner_tpu_torch/csrc/chol.cu"

    def chol_entry(name, key, replaces, nlaunch):
        b_ms, b_by = chol_bounds[key]
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": nlaunch,
                "max_abs_err": errs[key][0], "ms": times[key][0],
                "plain_ms": times[key][1], "bound_ms": b_ms,
                "bound_by": b_by, "library_ms": times[key][2]}
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
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
