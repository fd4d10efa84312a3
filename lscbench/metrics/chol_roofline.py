"""chol_roofline: the n <= 64 chol kernels' share of their roofline in
the traced stretch, in %: for each launch of factor_solve_kernel and
resolve_kernel (csrc/chol.cu) roofline.chol_bound at the batch and size
of the cycle's calls (probes.chol_shapes), summed, over the same
launches' device time.  None where the stretch launched neither."""
import probes
import roofline
import tracing

KINDS = {"factor_solve_kernel": "factor_solve", "resolve_kernel": "resolve"}


def probe(ctx):
    return probes.chol_shapes(ctx)


def read(rec):
    t, shapes = rec.trace, rec.probes.get("chol_roofline")
    if not t or not shapes:
        return None
    bound_ms = busy_s = 0.0
    for key, (dev_s, count) in t["kernels"].items():
        kind = KINDS.get(tracing.kernel_name(key))
        if not tracing.own_kernel(key) or kind not in shapes:
            continue
        B, n, elem = shapes[kind]
        bound_ms += count * roofline.chol_bound(kind, B, n, elem)[0]
        busy_s += dev_s
    if busy_s <= 0:
        return None
    return 100.0 * bound_ms / (1e3 * busy_s)
