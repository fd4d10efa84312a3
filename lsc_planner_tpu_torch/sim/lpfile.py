"""CPLEX LP-format reader for the reference's exported QP models
(the port's copy of lsc_planner_tpu/sim/lpfile.py).

The reference dumps every QP as ``log/QPmodel.lp`` when logging is on and
always on solver failure (``src/traj_optimizer.cpp:62-69, 99-102``); the
conflict refiner writes ``log/conflict.lp``.  This module parses the LP
subset those exports use -- a quadratic objective ``lin + [quad] / 2``,
``Subject To`` rows (=, <=, >=), and a ``Bounds`` section with ``Free``
markers -- into dense arrays over the reference's control-point variable
layout ``{x,y,z}_{segment}_{ctrlpt}`` (dim-major, ``k * M(n+1) + m (n+1)
+ i``, matching ``traj_optimizer.cpp:261-539``).

This is the strongest reference cross-check available without CPLEX: the
exported model IS the reference's assembled QP, coefficient for
coefficient (see tests/test_lp_parity.py).
"""
from __future__ import annotations

import re
from typing import NamedTuple

import numpy as np

_VAR = re.compile(r"[xyz]_\d+_\d+$")


class LPModel(NamedTuple):
    P: np.ndarray        # (NV, NV) symmetric, obj = 0.5 x'Px + q'x + c
    q: np.ndarray        # (NV,)
    c: float             # objective constant
    A_eq: np.ndarray     # (R_eq, NV)
    b_eq: np.ndarray     # (R_eq,)
    A_in: np.ndarray     # (R_in, NV)  rows as  A_in x >= b_in
    b_in: np.ndarray     # (R_in,)
    lo: np.ndarray       # (NV,) variable lower bounds (-inf = free)
    hi: np.ndarray       # (NV,) upper bounds (+inf = free)
    M: int
    n: int


def _var_index(name: str, M: int, n: int) -> int:
    k = {"x": 0, "y": 1, "z": 2}[name[0]]
    m, i = (int(t) for t in name[2:].split("_"))
    return (k * M + m) * (n + 1) + i


def parse_lp(path: str, M: int = 5, n: int = 5) -> LPModel:
    txt = open(path, encoding="latin-1").read()
    obj = re.search(r"Minimize\s+\w+:(.*?)Subject To", txt, re.S).group(1)
    con = re.search(r"Subject To(.*?)(Bounds|End)", txt, re.S).group(1)
    bnd_m = re.search(r"Bounds(.*?)End", txt, re.S)
    bnd = bnd_m.group(1) if bnd_m else ""

    NV = 3 * M * (n + 1)
    P = np.zeros((NV, NV))
    q = np.zeros(NV)

    def parse_expr(s, row=None):
        """Accumulate terms into (P, q) or, if given, into `row`;
        returns the constant part."""
        toks = s.replace("\n", " ").split()
        i, sign, const = 0, 1.0, 0.0
        while i < len(toks):
            t = toks[i]
            if t == "+":
                i += 1
                continue
            if t == "-":
                sign = -sign
                i += 1
                continue
            coef = 1.0
            if not _VAR.match(t):
                coef = float(t)
                i += 1
                t = toks[i] if i < len(toks) else None
            if t is not None and _VAR.match(t):
                a = _var_index(t, M, n)
                i += 1
                nxt = toks[i] if i < len(toks) else None
                if nxt == "^2":
                    P[a, a] += sign * coef
                    i += 1
                elif nxt == "*":
                    b = _var_index(toks[i + 1], M, n)
                    i += 2
                    # CPLEX cross terms appear once; obj = 0.5 x'Px has
                    # coefficient P_ab on x_a x_b
                    P[a, b] += sign * coef / 2
                    P[b, a] += sign * coef / 2
                elif row is not None:
                    row[a] += sign * coef
                else:
                    q[a] += sign * coef
            else:
                const += sign * coef
            sign = 1.0
        return const

    mq = re.search(r"\[(.*?)\]\s*/\s*2", obj, re.S)
    if mq:
        parse_expr(mq.group(1))
        lin = obj[: mq.start()] + obj[mq.end():]
    else:
        lin = obj
    c = parse_expr(lin)

    A_eq, b_eq, A_in, b_in = [], [], [], []
    for line in re.split(r"\s(?=c\d+:)", con.strip()):
        line = line.strip()
        if not line or line.startswith("\\"):
            continue
        m = re.match(r"c\d+:\s*(.*?)(<=|>=|=)\s*([\d.eE+-]+)\s*$",
                     line, re.S)
        if m is None:  # comment block inside conflict dumps
            continue
        lhs, op, rhs = m.groups()
        row = np.zeros(NV)
        parse_expr(lhs, row)
        if op == "=":
            A_eq.append(row)
            b_eq.append(float(rhs))
        elif op == ">=":
            A_in.append(row)
            b_in.append(float(rhs))
        else:
            A_in.append(-row)
            b_in.append(-float(rhs))

    lo = np.full(NV, -np.inf)
    hi = np.full(NV, np.inf)
    for line in bnd.strip().splitlines():
        line = line.strip()
        if not line or re.match(r"[xyz]_\d+_\d+\s+Free", line):
            continue
        m = re.match(
            r"([\d.eE+-]+)\s*<=\s*([xyz]_\d+_\d+)\s*<=\s*([\d.eE+-]+)",
            line)
        if m:
            j = _var_index(m.group(2), M, n)
            lo[j], hi[j] = float(m.group(1)), float(m.group(3))

    def arr(rows, rhs):
        return (np.array(rows) if rows else np.zeros((0, NV)),
                np.array(rhs) if rhs else np.zeros(0))

    A_eq, b_eq = arr(A_eq, b_eq)
    A_in, b_in = arr(A_in, b_in)
    return LPModel(P=P, q=q, c=c, A_eq=A_eq, b_eq=b_eq,
                   A_in=A_in, b_in=b_in, lo=lo, hi=hi, M=M, n=n)


def bounds_as_rows(model: LPModel):
    """Variable bounds as extra  a'x >= b  rows."""
    NV = model.P.shape[0]
    rows, rhs = [], []
    for j in range(NV):
        if np.isfinite(model.lo[j]):
            e = np.zeros(NV)
            e[j] = 1.0
            rows.append(e)
            rhs.append(model.lo[j])
        if np.isfinite(model.hi[j]):
            e = np.zeros(NV)
            e[j] = -1.0
            rows.append(e)
            rhs.append(-model.hi[j])
    if not rows:
        return np.zeros((0, NV)), np.zeros(0)
    return np.array(rows), np.array(rhs)
