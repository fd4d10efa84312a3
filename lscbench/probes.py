"""What the per-layer metrics read from the program after the window of a
traced run, besides the trace: calls of the program's kernel wrappers,
recorded by wrapping them for one uncaptured cycle from the window's last
state.  Each result is kept in ``ctx.cache``, so metrics that read the
same call share one probe."""
from __future__ import annotations

import importlib

import torch


def _wrapped_cycle(ctx, module: str, names: tuple) -> dict:
    """{name: [(args, kwargs) of each call]} of the functions `names` of
    the program's module `module` during one cycle from ctx.state (the
    tensors cloned).  The cycle's result is discarded."""
    mod = importlib.import_module(f"{ctx.program.package.__name__}.{module}")
    seen = {name: [] for name in names}
    orig = {name: getattr(mod, name) for name in names}

    def recorder(name):
        def record(*args, **kw):
            seen[name].append(([a.clone() if torch.is_tensor(a) else a
                                for a in args], dict(kw)))
            return orig[name](*args, **kw)
        return record
    for name in names:
        setattr(mod, name, recorder(name))
    try:
        ctx.sim.cycle(ctx.state)
    finally:
        for name in names:
            setattr(mod, name, orig[name])
    return seen


def fused_call(ctx):
    """The window's last cycle's fused IPM call, relaunched: {"args",
    "kw", "outputs", "qp_iters" (each QP's own count), "ms" (device ms a
    call: CUDA events around 20 calls enqueued back to back)}; None when
    the cycle made no such call."""
    if "fused" not in ctx.cache:
        calls = _wrapped_cycle(ctx, "ops.ipm", ("ipm_lsc_fused",))
        calls = calls["ipm_lsc_fused"]
        if not calls:
            ctx.cache["fused"] = None
        else:
            ipm = importlib.import_module(
                f"{ctx.program.package.__name__}.ops.ipm")
            args, kw = calls[0]
            out = ipm.ipm_lsc_fused(*args, **kw, qp_counts=True)
            for _ in range(2):
                ipm.ipm_lsc_fused(*args, **kw)
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            reps = 20
            a.record()
            for _ in range(reps):
                ipm.ipm_lsc_fused(*args, **kw)
            b.record()
            b.synchronize()
            ctx.cache["fused"] = {
                "args": args, "kw": kw,
                "outputs": [t for t in out if torch.is_tensor(t)],
                "qp_iters": out[4].double().cpu(),
                "ms": a.elapsed_time(b) / reps}
    return ctx.cache["fused"]


def chol_shapes(ctx):
    """{kind: (B, n, element bytes)} of the n <= 64 chol calls of the
    window's last cycle (kind "factor_solve" or "resolve")."""
    if "chol" not in ctx.cache:
        calls = _wrapped_cycle(ctx, "ops.chol",
                               ("chol_factor_solve", "chol_resolve"))
        shapes = {}
        for name, kind in (("chol_factor_solve", "factor_solve"),
                           ("chol_resolve", "resolve")):
            for args, _ in calls[name]:
                m = args[0]
                shapes[kind] = (int(m.reshape(-1, *m.shape[-2:]).shape[0]),
                                int(m.shape[-1]), m.element_size())
        ctx.cache["chol"] = shapes
    return ctx.cache["chol"]
