#!/usr/bin/env python3
"""Dump the port's kernels' outputs on fixed inputs, and compare two dumps
bit for bit: a check that a kernel source change kept a kernel's bits.
Also the large-n chol kernels' split of time by phase, and the face
expansion's clock stamps.

    PYTHONPATH=<checkout> python3 scripts/kernel_bits_torch.py dump OUT.pt
    python3 scripts/kernel_bits_torch.py compare A.pt B.pt
    PYTHONPATH=. python3 scripts/kernel_bits_torch.py split [OUT.json]
    PYTHONPATH=. python3 scripts/kernel_bits_torch.py designs [OUT.json]
    PYTHONPATH=. python3 scripts/kernel_bits_torch.py corridor [OUT.json]

`dump` runs on one CUDA GPU with the package on PYTHONPATH (this checkout,
or another one unpacked with `git archive`): the fused IPM in 3-D at the
main path's shapes (B, C) = (1024, 32), (64, 64), (128, 128), Param's
tolerances, with each QP's own iteration count; factor_solve, resolve and
the factor alone at n = 39 and 64, f32 and f64, and at the large n of the
slack QP (B = 64, n = 365, f32) and of the tiled design (n = 1024,
f32); the face expansion's boxes on forest20's cycle-4 and cycle-21
calls and the 30 m forest's seeds (expand_cases); each fused call's time,
each large-n kernel's and each face expansion's (CUDA events, median of
20), with the large-n design that ran ("block" in a checkout without
chol.large_design).  The inputs are made from numpy seeds with
the package's own tables, so two checkouts get the same inputs.
`compare` prints, as one JSON line, the card that made each dump, the
differing bits of every output (0 where equal), the large-n designs and
both dumps' times, and exits non-zero when any bits differ in an output
whose kernel design is the same in both dumps.  Compare two checkouts'
times only from dumps made in one call on one card, in turns (A, B, B,
A).

`split` builds csrc/chol.cu alone with -DLSC_CHOL_STAMPS (clock64
intervals), once as the package builds it and once with
-DLSC_CHOL_MAX_G=0 -DLSC_CHOL_ONE_BLOCK (the first design past the
clusters, one block a matrix, at every large n), apart from the
package's library, and prints as JSON, on IPM-like systems, each phase's
cycles a launch of factor_solve, the factor alone and resolve beside the
event-timed ms of the stamped and of the unstamped build, and the card's
name, power limit and SM clock: for the cluster and the one-block kernels
at the slack QP's B = 64, n = 365 in f32 (STAMPS: load, diagonal
factors, panel solves, trailing updates, L out, forward and backward
substitution, total; the first matrix's blocks, csrc/chol_cluster.cuh),
and for the tiled design at B = 64, n = 1024 and B = 96, n = 525 in f32
and B = 64, n = 365 in f64 (TILED_STAMPS, csrc/chol_tiled.cuh: the
factor's flag waits, updates, POTRF, TRSM, tile writes and last tasks of
the first matrix's tasks, as thread 0 of each task's block sees them,
with the number of its tasks and k-tiles; the solve's chain (diagonal
solves) and its waits for the streamers' partials, the streamers' loads
and FMAs and their waits for the chain, summed over the streamers, and
the solve's total, all in block 0).  The diagonal factors overlap the
trailing updates in the cluster kernel (look-ahead); its other phases
are intervals of the first block's thread 0 between cluster barriers.

`corridor` builds csrc/corridor.cu alone for each K of CORRIDOR_KS
(-DLSC_CORRIDOR_K, the tries a round speculates), with
-DLSC_CORRIDOR_STAMPS (each agent's tries, rounds, and clock64 cycles in
table reads and in the rest: slot search, bound tests, addresses, commit)
and without, and prints as JSON, on forest20's cycle-4 and cycle-21 calls
and the 30 m forest's seeds, for each K: the tries and rounds, the cycles
a try over all agents, the busiest agent's (most tries) tries, rounds,
cycles, cycles a try and a round, the event-timed ms of the stamped and
the unstamped build, with ptxas's registers and spills; and the K the
package's build takes, and the card's name, power limit and SM clock.

`designs` times four builds of chol.cu in turns at B = 64 on IPM-like
systems, f32 and f64, at the n of DESIGN_CASES: the package's (clusters
of 1 or 2 blocks where they hold the factor, else the tiled design),
-DLSC_CHOL_MAX_G=0 -DLSC_CHOL_ONE_BLOCK (one block a matrix at every
large n), -DLSC_CHOL_MAX_G=8 (clusters of up to 8 blocks, the tiled
design past them) and -DLSC_CHOL_MAX_G=0 (the tiled design at every
large n): the measurement behind the plan's cluster sizes and its
boundary.
"""
import ctypes
import json
import statistics
import subprocess
import sys

import numpy as np
import torch


def fused_inputs(B, C, seed):
    """ipm_lsc_fused's inputs on the production row structure (as
    tests/test_torch_cuda.py::fused_problem builds them), float32."""
    from lsc_planner_tpu_torch import Param
    from lsc_planner_tpu_torch.planner.optimizer import TrajOptimizer

    rng = np.random.default_rng(seed)
    opt = TrajOptimizer(Param())
    nf, M, n1 = opt.nf, opt.M, opt.n + 1
    U = opt.static_blocked[0]
    U = U / np.maximum(np.linalg.norm(U, axis=-1, keepdims=True), 1e-3)
    Lb = rng.normal(size=(B, nf, nf)) * 0.3
    P_blk = Lb @ np.swapaxes(Lb, -1, -2) + 2.0 * np.eye(nf)
    q = rng.normal(size=(B, 3 * nf))
    y0 = rng.normal(size=(B, 3 * nf)) * 0.1
    b_pairs = -rng.uniform(0.5, 5.0, size=(B, 2, U.shape[0] * U.shape[1]))
    nsc = rng.normal(size=(B, C, M, 3))
    F_seg = opt.F_seg
    row = np.linalg.norm(nsc, axis=-1)[..., None] * \
        np.linalg.norm(F_seg, axis=-1)
    live = (rng.uniform(size=(B, C, M, n1)) > 0.3) & (row >= 1e-3)
    scale = np.where(live, 1.0 / np.maximum(row, 1e-3), 0.0)
    b_pl = np.where(live, -rng.uniform(0.05, 1.0, size=row.shape) * row *
                    scale, -1.0)
    sigma = np.abs(np.einsum("nff->nf", P_blk)).mean(-1)
    return [torch.as_tensor(a, dtype=torch.float32, device="cuda")
            for a in (P_blk, q, y0, U, b_pairs, nsc, scale, b_pl, F_seg,
                      sigma)]


def spd_inputs(B, n, seed, dtype):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(B, 3 * n, n))
    d = np.exp(rng.uniform(-np.log(1e3), np.log(1e3), size=(B, 3 * n)))
    H = np.eye(n) + np.einsum("brv,br,brw->bvw", A, d, A)
    dsc = 1.0 / np.sqrt(np.einsum("bvv->bv", H))
    return [torch.as_tensor(a, dtype=dtype, device="cuda")
            for a in (H * dsc[:, :, None] * dsc[:, None, :],
                      rng.normal(size=(B, n)))]


def median_ms(fn, reps=20):
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


def dump(path):
    from lsc_planner_tpu_torch.ops import chol, ipm

    if not torch.cuda.is_available():
        raise RuntimeError("kernel_bits_torch.py dump needs a CUDA device")
    out = {"device": torch.cuda.get_device_name(0), "ms": {}}
    kw = dict(iters=40, tol_gap=1e-3, tol_rp=1e-4, tol_rd=0.2, tol_step=1e-3,
              correctors=1, qp_counts=True)
    for B, C in ((1024, 32), (64, 64), (128, 128)):
        args = fused_inputs(B, C, B + C)
        res = ipm.ipm_lsc_fused(*args, **kw)
        for name, t in zip(("y", "lam_s", "lam_p", "gap", "iters"), res):
            out[f"fused B={B} C={C} {name}"] = t.cpu()
        out["ms"][f"fused B={B} C={C}"] = median_ms(
            lambda: ipm.ipm_lsc_fused(*args, **kw))
    for n in (39, 64):
        for dtype in (torch.float32, torch.float64):
            H, r = spd_inputs(64, n, n, dtype)
            L, x = chol.chol_factor_solve(H, r)
            key = f"chol n={n} {str(dtype)[6:]}"
            out[key + " L"] = L.cpu()
            out[key + " x"] = x.cpu()
            out[key + " resolve"] = chol.chol_resolve(L, r).cpu()
            out[key + " factor"] = chol.cholesky_batched(H).cpu()
    out["design"] = {}
    for n in (365, 1024):
        H, r = large_inputs(64, n, n)
        key = f"chol large n={n} float32"
        out["design"][key] = (chol.large_design(n, torch.float32)
                              if hasattr(chol, "large_design") else "block")
        L, x = chol.chol_factor_solve(H, r)
        out[key + " L"] = L.cpu()
        out[key + " x"] = x.cpu()
        out[key + " resolve"] = chol.chol_resolve(L, r).cpu()
        out[key + " factor"] = chol.cholesky_batched(H).cpu()
        out["ms"][key + " factor_solve"] = median_ms(
            lambda: chol.chol_factor_solve(H, r))
        out["ms"][key + " resolve"] = median_ms(
            lambda: chol.chol_resolve(L, r))
        out["ms"][key + " factor"] = median_ms(
            lambda: chol.cholesky_batched(H))
    from lsc_planner_tpu_torch.ops import corridor as corridor_ops
    for name, args in expand_cases(torch.device("cuda")).items():
        lo, hi = corridor_ops.expand_boxes(*args)
        out[f"expand {name} lo"] = lo.cpu()
        out[f"expand {name} hi"] = hi.cpu()
        out["ms"][f"expand {name}"] = median_ms(
            lambda: corridor_ops.expand_boxes(*args))
    torch.save(out, path)


def large_inputs(B, n, seed):
    """spd_inputs at a large n in float32, made in f64 on the card from a
    torch seed (numpy's three-operand einsum takes minutes at n = 1024)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    f64 = dict(device="cuda", dtype=torch.float64)
    A = torch.randn(B, 3 * n, n, generator=g, **f64)
    d = torch.exp(torch.empty(B, 3 * n, **f64).uniform_(
        -np.log(1e3), np.log(1e3), generator=g))
    H = torch.eye(n, **f64) + A.mT @ (A * d[..., None])
    dsc = torch.rsqrt(torch.diagonal(H, dim1=-2, dim2=-1))
    H = H * dsc[:, :, None] * dsc[:, None, :]
    return [H.float(), torch.randn(B, n, generator=g, **f64).float()]


STAMPS = ("load", "diagonal factors", "panel solves", "trailing updates",
          "tile updates", "cluster barrier waits", "L out",
          "forward substitution", "backward substitution", "solve flag waits",
          "solve publishing", "total")
# csrc/chol_tiled.cuh's stamps (enum Stamp), in cycles but for the counts
TILED_STAMPS = ("factor flag waits", "factor updates", "factor POTRF",
                "factor TRSM", "factor tile writes", "factor last tasks",
                "factor tasks (count)", "factor k-tiles (count)",
                "solve chain", "solve chain waits", "solve streaming",
                "solve streamer waits", "solve total",
                "factor TRSM's wait for L_jj")
# builds of csrc/chol.cu: the package's (the cluster kernels at the slack
# QP's n = 365 in f32, the tiled design past the clusters), the first
# design past the clusters (one block a matrix) at every large n,
# clusters of up to 8 blocks, the tiled design at every large n
BUILDS = {"cluster": [], "block": ["LSC_CHOL_MAX_G=0", "LSC_CHOL_ONE_BLOCK"],
          "clusters up to 8": ["LSC_CHOL_MAX_G=8"],
          "tiled": ["LSC_CHOL_MAX_G=0"]}
# the tiled design's shapes that `split` stamps: (B, n, dtype)
TILED_SPLIT = ((64, 1024, torch.float32), (96, 525, torch.float32),
               (64, 365, torch.float64))


def chol_builds(names, stamps):
    """{name: library} of csrc/chol.cu alone for the BUILDS names, with
    the clock stamps (LSC_CHOL_STAMPS) or without, built at once in
    threads."""
    from concurrent.futures import ThreadPoolExecutor

    from lsc_planner_tpu_torch.ops import _build

    extra = ["LSC_CHOL_STAMPS"] if stamps else []
    with ThreadPoolExecutor(len(names)) as pool:
        libs = {d: pool.submit(_build.load_variant, ["chol.cu"],
                               BUILDS[d] + extra) for d in names}
        return {d: f.result()[0] for d, f in libs.items()}


def chol_calls(H, r, L, x):
    """{kind: call(lib)} launching factor_solve, the factor alone and
    resolve of `lib` (a build of csrc/chol.cu) on H, r into L, x (with the
    tiled design's workspace, which the other designs do not read)."""
    from lsc_planner_tpu_torch.ops import _build, chol

    B, n = r.shape
    sfx = "f32" if H.dtype == torch.float32 else "f64"
    dev = H.device
    work = torch.empty(chol.tiled_work_ints(n, B), dtype=torch.int32,
                       device=dev)
    return {
        "factor_solve": lambda lb: _build.launch(
            getattr(lb, "lsc_chol_factor_solve_" + sfx), dev, H.data_ptr(),
            r.data_ptr(), L.data_ptr(), x.data_ptr(), work.data_ptr(), B, n),
        "factor": lambda lb: _build.launch(
            getattr(lb, "lsc_chol_factor_" + sfx), dev, H.data_ptr(),
            L.data_ptr(), work.data_ptr(), B, n),
        "resolve": lambda lb: _build.launch(
            getattr(lb, "lsc_chol_resolve_" + sfx), dev, L.data_ptr(),
            r.data_ptr(), x.data_ptr(), B, n),
    }


def smi():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,"
         "clocks.max.sm", "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()


def emit(out, path):
    line = json.dumps(out)
    print(line)
    if path:
        with open(path, "w") as f:
            f.write(line + "\n")


def split(path=None):
    """The large-n chol kernels' phase split (see the module note)."""
    if not torch.cuda.is_available():
        raise RuntimeError("kernel_bits_torch.py split needs a CUDA device")
    designs = ("cluster", "block")
    stamped = chol_builds(designs, True)
    normal = chol_builds(designs, False)
    out = {"device": torch.cuda.get_device_name(0), "phases": STAMPS,
           "tiled phases": TILED_STAMPS}
    # (design, B, n, dtype, the build, its stamps' reader and names)
    cases = [(name, 64, 365, torch.float32, name, "lsc_chol_stamps",
              STAMPS) for name in designs] + \
        [("tiled", B, n, dtype, "cluster", "lsc_chol_tiled_stamps",
          TILED_STAMPS) for B, n, dtype in TILED_SPLIT]
    for name, B, n, dtype, build, reader, names in cases:
        H, r = (t.to(dtype) for t in large_inputs(B, n, n))
        L, x = torch.empty_like(H), torch.empty_like(r)
        stamps = (ctypes.c_ulonglong * len(names))()
        lib = stamped[build]
        read = getattr(lib, reader)
        for kind, call in chol_calls(H, r, L, x).items():
            for lb in (lib, normal[build]):    # warm, and L for resolve
                if call(lb):
                    raise RuntimeError(f"{name} {kind}: launch failed")
            torch.cuda.synchronize()
            if read(stamps, 1):
                raise RuntimeError(f"{reader} failed")
            if call(lib):
                raise RuntimeError(f"{name} {kind}: launch failed")
            torch.cuda.synchronize()
            if read(stamps, 1):
                raise RuntimeError(f"{reader} failed")
            out[f"{name} B={B} n={n} {str(dtype)[6:]} {kind}"] = {
                "cycles": dict(zip(names, map(int, stamps))),
                "ms_stamped": median_ms(lambda: call(lib)),
                "ms": median_ms(lambda: call(normal[build]))}
    out["smi"] = smi()
    emit(out, path)


def expand_cases(dev):
    """{name: expand_boxes's arguments} of the face expansion's calls that
    chip_smoke phase 12 checks: forest20's cycle-4 and cycle-21 calls and
    the 30 m forest's 20 seeds."""
    import chip_smoke
    from lsc_planner_tpu_torch import GoalMode, Param
    from lsc_planner_tpu_torch.sim.simulator import SyncSimulator

    forest = SyncSimulator(chip_smoke.forest_mission(), Param(
        goal_mode=GoalMode.PRIOR_BASED), device=dev, dtype=torch.float32)
    return {"forest20 cycle 4": chip_smoke.capture_expand_call(forest, 3),
            "forest20 cycle 21": chip_smoke.capture_expand_call(forest, 20),
            "forest30 starts": chip_smoke.forest30_expand_inputs(dev)}


CORRIDOR_STAMPS = ("tries", "rounds", "read cycles", "rest cycles")
# the builds of csrc/corridor.cu that `corridor` stamps: the tries a round
# each speculates (-DLSC_CORRIDOR_K)
CORRIDOR_KS = (1, 4, 6, 8)


def stamp_summary(rows):
    """The stamps (N rows of CORRIDOR_STAMPS) of one launch: totals, the
    busiest agent's (most tries) stamps and its cycles a try and a round."""
    tries = [r[0] for r in rows]
    busy = max(range(len(rows)), key=lambda i: tries[i])
    b = rows[busy]
    cyc = b[2] + b[3]
    return {"tries": sum(tries), "rounds": sum(r[1] for r in rows),
            "cycles a try, all agents": sum(r[2] + r[3] for r in rows) /
            max(sum(tries), 1),
            "busiest agent": {"agent": busy, **dict(zip(CORRIDOR_STAMPS, b)),
                              "cycles": cyc,
                              "cycles a try": cyc / max(b[0], 1),
                              "cycles a round": cyc / max(b[1], 1),
                              "read cycles a round": b[2] / max(b[1], 1)}}


def corridor(path=None):
    """The face expansion's clock stamps (see the module note)."""
    from lsc_planner_tpu_torch.ops import _build
    from lsc_planner_tpu_torch.ops import corridor as corridor_ops

    if not torch.cuda.is_available():
        raise RuntimeError("kernel_bits_torch.py corridor needs a CUDA "
                           "device")
    builds = {(k, st): _build.load_variant(
        ["corridor.cu"], [f"LSC_CORRIDOR_K={k}"] +
        (["LSC_CORRIDOR_STAMPS"] if st else []))
        for k in CORRIDOR_KS for st in (True, False)}
    out = {"device": torch.cuda.get_device_name(0), "stamps":
           CORRIDOR_STAMPS, "K taken": corridor_ops.spec_k(),
           "ptxas": {f"K={k}" + (" stamped" if st else ""): [
               line for line in (log or "").splitlines()
               if "registers" in line or "spill" in line]
               for (k, st), (_, log) in builds.items()},
           "cases": {}}
    for name, args in expand_cases(torch.device("cuda")).items():
        dev = args[0].device
        want = corridor_ops.expand_boxes_plain(*args)
        case = out["cases"][name] = {"N": args[0].shape[0],
                                     "table": list(args[4].sat.shape)}
        for k in CORRIDOR_KS:
            sfx, eargs, got, _ins = corridor_ops.entry_args(*args)
            st = torch.zeros(args[0].shape[0], len(CORRIDOR_STAMPS),
                             dtype=torch.int64, device=dev)
            timed = getattr(builds[k, True][0],
                            "lsc_expand_boxes_stamped_" + sfx)
            plain = getattr(builds[k, False][0], "lsc_expand_boxes_" + sfx)

            def run_stamped():
                return _build.launch(timed, dev, *eargs, st.data_ptr())

            def run_normal():
                return _build.launch(plain, dev, *eargs)
            for call in (run_normal, run_stamped):
                got[0].fill_(0)
                got[1].fill_(0)
                if call():
                    raise RuntimeError(f"{name} K={k}: launch failed")
                torch.cuda.synchronize()
                if not (torch.equal(got[0], want[0]) and
                        torch.equal(got[1], want[1])):
                    raise AssertionError(f"{name} K={k}: boxes differ from "
                                         "the plain version")
            case[f"K={k}"] = {**stamp_summary(st.cpu().tolist()),
                              "ms_stamped": median_ms(run_stamped),
                              "ms": median_ms(run_normal)}
    out["smi"] = smi()
    emit(out, path)


# (dtype, n) that `designs` times: the slack QP's n and the edges of the
# cluster sizes of 1, 2, 4 and 8 blocks in each dtype
DESIGN_CASES = tuple((torch.float32, n) for n in (65, 199, 288, 365, 399,
                                                   544, 640)) + \
    tuple((torch.float64, n) for n in (65, 128, 192, 199, 256, 300, 352,
                                       365, 384))


def designs(path=None):
    """The four BUILDS at B = 64 on IPM-like systems (DESIGN_CASES):
    ms of factor_solve, the factor alone and resolve (CUDA events, median
    of 20) of each, in turns (there and back), with the package's cluster
    size (null: the tiled design) and design."""
    from lsc_planner_tpu_torch.ops import chol

    if not torch.cuda.is_available():
        raise RuntimeError("kernel_bits_torch.py designs needs a CUDA "
                           "device")
    libs = chol_builds(tuple(BUILDS), False)
    out = {"device": torch.cuda.get_device_name(0), "B": 64, "cases": []}
    for dtype, n in DESIGN_CASES:
        H, r = (t.to(dtype) for t in large_inputs(64, n, n))
        L, x = torch.empty_like(H), torch.empty_like(r)
        plan = chol.large_plan(n, dtype)
        case = {"dtype": str(dtype)[6:], "n": n,
                "G": plan[0] if plan else None,
                "design": chol.large_design(n, dtype)}
        for kind, call in chol_calls(H, r, L, x).items():
            for name in BUILDS:
                if call(libs[name]):
                    raise RuntimeError(f"{name} {kind} n={n}: launch "
                                       "failed")
            ms = {name: [] for name in BUILDS}
            for name in tuple(BUILDS) + tuple(reversed(BUILDS)):
                ms[name].append(median_ms(lambda: call(libs[name])))
            case[kind] = ms
        out["cases"].append(case)
    out["smi"] = smi()
    emit(out, path)


def differing_bits(a, b):
    if a.shape != b.shape or a.dtype != b.dtype:
        return -1
    if a.dtype == torch.bool:
        return int((a != b).sum())
    view = {4: torch.int32, 8: torch.int64}[a.element_size()]
    x = torch.bitwise_xor(a.view(view), b.view(view)).to(torch.int64)
    if a.element_size() == 4:
        x = x & 0xFFFFFFFF
    return sum(int(((x >> i) & 1).sum()) for i in range(8 * a.element_size()))


def compare(path_a, path_b):
    a, b = torch.load(path_a), torch.load(path_b)
    meta = ("device", "ms", "design")
    diffs = {k: differing_bits(a[k], b[k]) for k in a
             if k not in meta and k in b}
    da, db = a.get("design", {}), b.get("design", {})
    # an output whose large-n kernel design differs between the dumps may
    # differ (its sums run in another order); every other must not
    redesigned = {k for k in diffs
                  if any(k.startswith(p) and da.get(p) != db.get(p)
                         for p in set(da) | set(db))}
    print(json.dumps({"devices": [a["device"], b["device"]],
                      "missing": sorted(set(a) ^ set(b)),
                      "differing_bits": diffs,
                      "designs": [da, db],
                      "redesigned": sorted(redesigned),
                      "ms": [a["ms"], b["ms"]]}))
    held = [v for k, v in diffs.items() if k not in redesigned]
    return 0 if not any(held) and set(a) == set(b) else 1


if __name__ == "__main__":
    if sys.argv[1:2] == ["dump"] and len(sys.argv) == 3:
        dump(sys.argv[2])
    elif sys.argv[1:2] == ["compare"] and len(sys.argv) == 4:
        sys.exit(compare(sys.argv[2], sys.argv[3]))
    elif sys.argv[1:2] == ["split"] and len(sys.argv) in (2, 3):
        split(*sys.argv[2:])
    elif sys.argv[1:2] == ["corridor"] and len(sys.argv) in (2, 3):
        corridor(*sys.argv[2:])
    elif sys.argv[1:2] == ["designs"] and len(sys.argv) in (2, 3):
        designs(*sys.argv[2:])
    else:
        sys.exit(__doc__)
