#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA GPU (an H100 is the target).

    python3 chip_smoke.py

Phases, one line each; any failure raises and exits non-zero:
  1. a CUDA device is required; prints the card's name and power limit
  2. builds the kernels from lsc_planner_tpu_torch/csrc with nvcc
  3. audit.precision_self_check on the card (the TF32 guard)
  4. each kernel against its plain PyTorch version at n = 39,
     B in {1, 64, 130}, on IPM-like inputs; NaN stays in a non-SPD entry;
     both times (CUDA events, median of 50); plus one f64 cycle of an
     8-agent circle on the card against the CPU
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
Then the kernels' JSON line, and last {"ok": true, "device": {...}}.
The script imports nothing of JAX.
"""
import json
import math
import re
import statistics
import subprocess
import time

import numpy as np
import torch

from lsc_planner_tpu_torch import GoalMode, Param, make_circle_mission
from lsc_planner_tpu_torch.convert import state_to_numpy
from lsc_planner_tpu_torch.ops import _build, chol, ipm
from lsc_planner_tpu_torch.sim import audit
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


def phase(name, msg):
    print(f"[{name}] {msg}", flush=True)


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
        t = {
            "factor_solve": (median_ms(lambda: chol.chol_factor_solve(H, R1)),
                             median_ms(lambda: chol.chol_factor_solve_plain(
                                 H, R1))),
            "resolve": (median_ms(lambda: chol.chol_resolve(Lk, R2)),
                        median_ms(lambda: chol.chol_resolve_plain(Lk, R2))),
        }
        out[B] = (errs, t)
        phase("4 kernels",
              f"B={B} n={N_QP}: factor_solve err {errs['factor_solve'][0]:.3e}"
              f" (plain f32 {errs['factor_solve'][1]:.3e}) "
              f"{t['factor_solve'][0]:.4f} ms vs plain "
              f"{t['factor_solve'][1]:.4f} ms; resolve err "
              f"{errs['resolve'][0]:.3e} (plain f32 {errs['resolve'][1]:.3e})"
              f" {t['resolve'][0]:.4f} ms vs plain {t['resolve'][1]:.4f} ms")

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
                main = (e_k, t_k, t_p)
    if failed:
        raise AssertionError("fused kernel: " + "; ".join(failed))
    return main


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
    fused_err, fused_ms, fused_plain_ms = compare_fused(
        [capture_fused_call(sim, 3) for sim in (big, small)])

    # 7. circle64 through the fused kernel
    fly_circle64_fused(small)

    # 8. the main path at 1024 agents: K-NN pruning and the fused kernel
    fused_launches = fly_circle1024(big)

    errs, times = results[MAIN_B]
    source = "lsc_planner_tpu_torch/csrc/chol.cu"
    kernels = [
        {"name": "chol_factor_solve", "route": "cuda", "source": source,
         "replaces": "lsc_planner_tpu/ops/chol_pallas.py:108",
         "launches": launches["factor_solve"],
         "max_abs_err": errs["factor_solve"][0],
         "ms": times["factor_solve"][0],
         "plain_ms": times["factor_solve"][1]},
        {"name": "chol_resolve", "route": "cuda", "source": source,
         "replaces": "lsc_planner_tpu/ops/chol_pallas.py:123",
         "launches": launches["resolve"],
         "max_abs_err": errs["resolve"][0],
         "ms": times["resolve"][0], "plain_ms": times["resolve"][1]},
        {"name": "ipm_lsc_fused", "route": "cuda",
         "source": "lsc_planner_tpu_torch/csrc/ipm.cu",
         "replaces": "lsc_planner_tpu/ops/ipm_pallas.py:122",
         "launches": fused_launches, "max_abs_err": fused_err,
         "ms": fused_ms, "plain_ms": fused_plain_ms},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
