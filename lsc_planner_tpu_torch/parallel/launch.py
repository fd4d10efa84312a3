"""Start the ranks of a sharded run as processes on this host (the port's
counterpart of the JAX package's device set).

``spawn_ranks(fn, world, backend, *args)`` starts `world` processes with
torch.multiprocessing under the spawn start method (CUDA does not survive
a fork), joins them into one process group through a ``file://`` store in
a temporary directory (no TCP port, so that several runs on one host never
meet), runs ``fn(*args)`` on each with torch on one thread, and returns
the ranks' results, which come back through files (numpy arrays and plain
Python values).  `fn` must be a module-level function of a module that
imports neither jax nor the test suite: each rank imports it afresh.

The caller names the backend: ``"nccl"`` needs one card a rank and raises
when the world is larger than ``torch.cuda.device_count()``; ``"gloo"``
runs ranks on the CPU or several ranks on one card.  A rank that raises
fails the whole call (the other ranks are stopped), as does a run past
TIMEOUT_S seconds.
"""
from __future__ import annotations

import datetime
import os
import pickle
import tempfile
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

BACKENDS = ("gloo", "nccl")
TIMEOUT_S = 900.0       # a whole run's limit, and a collective's


def spawn_ranks(fn, world: int, backend: str, *args) -> list:
    """fn(*args) on each of `world` ranks of a new process group; returns
    [rank 0's result, rank 1's, ...]."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r} is not one of {BACKENDS}")
    if world < 1:
        raise ValueError(f"world of {world} ranks")
    if backend == "nccl":
        cards = torch.cuda.device_count() if torch.cuda.is_available() \
            else 0
        if world > cards:
            raise RuntimeError(
                f"nccl needs one card a rank: {world} ranks, {cards} cards "
                "(NCCL refuses two ranks on one device; use gloo to share "
                "a card)")
    with tempfile.TemporaryDirectory(prefix="lsc_ranks_") as tmp:
        ctx = mp.start_processes(_rank_main,
                                 args=(fn, world, backend, tmp, args),
                                 nprocs=world, join=False,
                                 start_method="spawn")
        deadline = time.monotonic() + TIMEOUT_S
        try:
            while not ctx.join(timeout=1.0):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{world} ranks of {fn.__name__} "
                                       f"ran past {TIMEOUT_S} s")
        finally:
            for proc in ctx.processes:
                if proc.is_alive():
                    proc.terminate()
                    proc.join(timeout=10.0)
        results = []
        for rank in range(world):
            with open(os.path.join(tmp, f"rank{rank}.pkl"), "rb") as f:
                results.append(pickle.load(f))
        return results


def _rank_main(rank: int, fn, world: int, backend: str, tmp: str,
               args) -> None:
    torch.set_num_threads(1)
    if backend == "nccl":
        torch.cuda.set_device(rank)
    dist.init_process_group(
        backend, init_method=f"file://{os.path.join(tmp, 'store')}",
        world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=TIMEOUT_S))
    # a rank that raises exits with its traceback and leaves the group as
    # it is: its peers may be inside a collective, and spawn_ranks stops
    # them
    out = fn(*args)
    dist.destroy_process_group()
    part = os.path.join(tmp, f"rank{rank}.pkl.part")
    with open(part, "wb") as f:
        pickle.dump(out, f)
    os.replace(part, os.path.join(tmp, f"rank{rank}.pkl"))
