#!/usr/bin/env python3
"""rsfc64's QPFAILED cycles on one CUDA GPU: the state before the first one
saved as numpy (the fixture behind tests/test_torch_qpfailed.py), and the
port's card-to-CPU gap from that state.

    PYTHONPATH=. python3 scripts/qpfailed_state_torch.py save OUT.npz
    PYTHONPATH=. python3 scripts/qpfailed_state_torch.py gap STATE.npz

`save` flies chip_smoke's rsfc64 (RECIPROCAL_RSFC, f32, the large-n chol
kernels) for its 20 cycles; each cycle with a QPFAILED agent runs again
from the state before it with the plain chol versions on the card, in f64
on the card, and in f32 and f64 on the CPU (chip_smoke.qp_failures_rerun),
and one line a cycle prints each run's QPFAILED agents with the failing
agents' primal residuals and gaps.  OUT.npz holds the state before the
first failing cycle (SwarmState fields, None fields left out) and that
cycle's index as `cycle`.

`gap` runs the cycle from STATE.npz with the port on the card and on the
CPU, in f32 and in f64, and prints as JSON each run's QPFAILED agents and,
in each dtype, the largest difference between the card's and the CPU's
trajectories (m): the same code, with only the order of the reductions
changed (cuBLAS and the card's kernels against the CPU's plain versions).
"""
import json
import sys

import numpy as np
import torch

import chip_smoke
from lsc_planner_tpu_torch.convert import state_from_numpy, state_to_numpy

CPU_RERUNS = (("CPU f32", "cpu", torch.float32),
              ("CPU f64", "cpu", torch.float64))


def save(path):
    sim, _, cycles = chip_smoke.mode_sim(torch.device("cuda"), "rsfc64")
    failures = chip_smoke.qp_failures_rerun(
        sim, "rsfc64", cycles, chip_smoke.CARD_RERUNS + CPU_RERUNS)
    print(chip_smoke.smi_line())
    for line in chip_smoke.qp_failure_lines(failures) or ["none"]:
        print(line)
    if failures:
        it, _, _, _, prev, _ = failures[0]
        fields = {k: v for k, v in state_to_numpy(prev).items()
                  if v is not None}
        np.savez_compressed(path, cycle=np.int64(it), **fields)


def gap(path):
    fields = dict(np.load(path))
    cycle = int(fields.pop("cycle"))
    tm, kw, _ = chip_smoke.mode_case("rsfc64")
    out = {"smi": chip_smoke.smi_line(), "cycle": cycle}
    for name, dtype in (("f32", torch.float32), ("f64", torch.float64)):
        traj = {}
        for device in ("cuda", "cpu"):
            sim = chip_smoke.SyncSimulator(tm, chip_smoke.Param(**kw),
                                           device=device, dtype=dtype)
            state, info = sim.cycle(state_from_numpy(fields, device=device,
                                                     dtype=dtype))
            traj[device] = state.traj.double().cpu().numpy()
            out[f"{device} {name} QPFAILED"] = \
                info.qp_failed.nonzero().flatten().tolist()
        out[f"{name} card-CPU max |traj| m"] = float(
            np.abs(traj["cuda"] - traj["cpu"]).max())
    print(json.dumps(out))


if __name__ == "__main__":
    cmds = {"save": save, "gap": gap}
    if len(sys.argv) != 3 or sys.argv[1] not in cmds:
        sys.exit(__doc__)
    if not torch.cuda.is_available():
        raise RuntimeError("qpfailed_state_torch.py needs a CUDA device")
    cmds[sys.argv[1]](sys.argv[2])
