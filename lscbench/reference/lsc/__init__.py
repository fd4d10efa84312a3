"""The benchmark's plain reference of the LSC planner's cycle: a frozen
copy of the plain PyTorch paths of lsc_planner_tpu_torch (its config,
missions, ops, planner, world and sim modules, cut to what one cycle of
the benchmark's configurations runs).  Every hand-written kernel's call is
replaced by its plain version (``torch.linalg.cholesky_ex`` and triangular
solves, the Jacobi wavefront, the batched face expansion), and the fused
IPM by the factored IPM on the same QP.  It imports nothing of the port
or of JAX, so a later change to the port leaves it as it is; the repo's
CPU tests hold these plain paths to the JAX package in float64.
"""
