"""launches_per_cycle: kernel launches in the traced stretch (copies and
sets apart) over the planning cycles it ran."""


def read(rec):
    t = rec.trace
    if not t or not t["kernels"]:
        return None
    return sum(v[1] for v in t["kernels"].values()) / t["cycles"]
