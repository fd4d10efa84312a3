"""setup_s: seconds from the process's start to the window's first
dispatch: imports, the CUDA context, loading (or, on a checkout's first
run, building) the kernel library, the mission and the simulator (and a
world's ESDF), the warm-up cycle, the capture of k cycles and one
replay."""


def read(rec):
    return rec.setup_s
