"""cycle_ms: the window's host wall time over every planning cycle
completed in it (k a dispatch, speculative cycles after a finish
included), in ms."""


def read(rec):
    return 1e3 * rec.window_s / rec.cycles if rec.cycles else None
