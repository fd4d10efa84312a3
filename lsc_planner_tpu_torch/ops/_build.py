"""Build the package's CUDA sources with nvcc and load them with ctypes.

The kernels in ``csrc/`` have a plain C interface, so nvcc builds them
without compiling PyTorch's headers: one ``nvcc -c`` a source, all started
together, then one ``nvcc -shared`` link.  The build happens at first
use, into ``lsc_planner_tpu_torch/_build/`` (listed in .gitignore), under
a file name keyed by the source and flag hash, so an edited source is
rebuilt and an unchanged one is loaded as it is.  A file lock a library
(``build_lock``) makes processes that start together, such as the ranks
of a sharded run, build each library once: the first builds, the others
wait and load its build.
"""
from __future__ import annotations

import contextlib
import ctypes
import fcntl
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path

import torch

from .. import trace

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
SOURCES = ("chol.cu", "ipm.cu", "wavefront.cu", "corridor.cu", "trace.cu",
           "planes.cu")
HEADERS = ("warp_chol.cuh",      # included by chol.cu and ipm.cu
           "chol_cluster.cuh",   # included by chol.cu
           "chol_tiled.cuh")     # included by chol.cu
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_lib = None
_variant_lock = threading.Lock()   # apart: a variant builds beside _lib
_variants = {}
# nvcc's output of the build made by this process (ptxas: registers, shared
# memory, spills per kernel); None: loaded a library built earlier, or
# nothing loaded yet.  The build's and the load's wall time are the set-up
# spans build.nvcc and build.load (trace.py).
build_log = None

_PTR = ctypes.c_void_p
_INT = ctypes.c_int
_SIGNATURES = {
    # inputs and outputs (and the tiled factor's workspace, or null); B, n;
    # stream
    "lsc_chol_factor_solve_f32": [_PTR] * 5 + [_INT] * 2 + [_PTR],
    "lsc_chol_factor_solve_f64": [_PTR] * 5 + [_INT] * 2 + [_PTR],
    "lsc_chol_resolve_f32": [_PTR] * 3 + [_INT] * 2 + [_PTR],
    "lsc_chol_factor_f32": [_PTR] * 3 + [_INT] * 2 + [_PTR],
    "lsc_chol_factor_f64": [_PTR] * 3 + [_INT] * 2 + [_PTR],
    "lsc_chol_resolve_f64": [_PTR] * 3 + [_INT] * 2 + [_PTR],
    # n, element bytes; out (3 x long long)
    "lsc_chol_cluster_plan": [_INT, _INT, _PTR],
    # out (host, chol_cluster::kStamps x unsigned long long), reset
    "lsc_chol_stamps": [_PTR, _INT],
    # out (host, chol_tiled::kTsStamps x unsigned long long), reset
    "lsc_chol_tiled_stamps": [_PTR, _INT],
    # n, B: the tiled workspace's ints (returns long long)
    "lsc_chol_tiled_work": [_INT, _INT],
    # n, B, task; out (3 x int): returns the number of tasks (long long)
    "lsc_chol_tiled_task": [_INT, _INT, ctypes.c_longlong, _PTR],
    # 10 inputs, 5 outputs, scratch; scratch floats; rows_smem, qpb (from
    # the plan), D, N, nf, Ru, C, M, n1, iters, correctors; reg, s_min,
    # tol_gap, tol_rp, tol_rd, tol_step; stream
    "lsc_ipm_fused_f32": [_PTR] * 16 + [ctypes.c_longlong] +
                         [ctypes.c_int] * 11 + [ctypes.c_float] * 6 + [_PTR],
    # D, N, nf, Ru, C, M, n1, rows_mode; out (6 x long long)
    "lsc_ipm_fused_plan": [ctypes.c_int] * 8 + [_PTR],
    # occ, goal, out, steps; N, Z, Y, X, max_iters; stream
    "lsc_wavefront_f32": [_PTR] * 4 + [ctypes.c_int] * 5 + [_PTR],
    # lo0, hi0, cand, seed_ok, sat; S0, S1, S2; k0 (3); wmin32, wmin, wmax;
    # res, eps, eps_f; lo_out, hi_out; N; stream
    "lsc_expand_boxes_f32": [_PTR] * 5 + [ctypes.c_int] * 3 +
                            [ctypes.c_longlong] * 3 + [_PTR] * 3 +
                            [ctypes.c_double] * 3 + [_PTR] * 2 +
                            [ctypes.c_int, _PTR],
    # the build's tries a round (LSC_CORRIDOR_K)
    "lsc_expand_boxes_k": [],
    # the tracer's stage stamp: slot (int64, device); stream
    "lsc_trace_stamp": [_PTR, _PTR],
    # init_traj, obs_pred, agent radius and downwash, obstacle radius and
    # downwash, obs_is_agent, slack flags and sizes (or null); guard;
    # normal, rhs; N, O, M, K; stream
    "lsc_planes_f32": [_PTR] * 9 + [ctypes.c_double] + [_PTR] * 2 +
                      [_INT] * 4 + [_PTR],
}
_SIGNATURES["lsc_expand_boxes_f64"] = _SIGNATURES["lsc_expand_boxes_f32"]
_SIGNATURES["lsc_planes_f64"] = _SIGNATURES["lsc_planes_f32"]
_LONG_RESULTS = ("lsc_chol_tiled_work", "lsc_chol_tiled_task")
# the measurement build's (-DLSC_CORRIDOR_STAMPS): the same, then the
# stamps (N, 4) uint64 before the stream
_STAMPED = _SIGNATURES["lsc_expand_boxes_f32"][:-1] + [_PTR, _PTR]
_SIGNATURES["lsc_expand_boxes_stamped_f32"] = _STAMPED
_SIGNATURES["lsc_expand_boxes_stamped_f64"] = _STAMPED


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("cannot build the CUDA kernels: no CUDA toolkit "
                           "(nvcc) was found")
    nvcc = Path(CUDA_HOME) / "bin" / "nvcc"
    if not nvcc.exists():
        raise RuntimeError(f"cannot build the CUDA kernels: {nvcc} is "
                           "missing")
    return str(nvcc)


def library_path(sources=SOURCES, flags=NVCC_FLAGS) -> Path:
    h = hashlib.sha256(" ".join(flags).encode())
    for name in sources + HEADERS:
        h.update((CSRC_DIR / name).read_bytes())
    return BUILD_DIR / f"liblsc_kernels_{h.hexdigest()[:16]}.so"


def _compile(out: Path, sources=SOURCES, flags=NVCC_FLAGS) -> str:
    """Builds `sources` into the library `out`; returns nvcc's output."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [os.path.join(tmp, Path(src).stem + ".o") for src in sources]
        cmds = [[_nvcc(), *flags, "-c", "-o", obj, str(CSRC_DIR / src)]
                for src, obj in zip(sources, objs)]
        procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for cmd in cmds]
        logs = [proc.communicate()[0] for proc in procs]
        for cmd, proc, log in zip(cmds, procs, logs):
            if proc.returncode != 0:
                raise RuntimeError("nvcc failed:\n" + " ".join(cmd) + "\n" +
                                   log)
        lib = os.path.join(tmp, "lib.so")
        link = [_nvcc(), "-shared", "-o", lib, *objs]
        proc = subprocess.run(link, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError("nvcc failed:\n" + " ".join(link) + "\n" +
                               proc.stdout + proc.stderr)
        os.replace(lib, out)      # atomic: concurrent builders never race
    return "".join(logs)


@contextlib.contextmanager
def build_lock(path: Path):
    """An exclusive lock on `path`'s build across processes (flock on
    `path` + ".lock"; the system releases it when its holder exits)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(f"{path}.lock", "a") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def _load(path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        if hasattr(lib, name):
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = (ctypes.c_longlong if name in _LONG_RESULTS
                          else ctypes.c_int)
    return lib


def _need_cuda() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("the CUDA kernels need a CUDA device; "
                           "torch.cuda.is_available() is False")


def load_library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed.  Raises
    RuntimeError when there is no CUDA device or no nvcc: the CUDA path
    never falls back to the plain versions."""
    global _lib, build_log
    with _lock:
        if _lib is None:
            _need_cuda()
            path = library_path()
            with build_lock(path):
                if not path.exists():
                    with trace.setup_span("build.nvcc"):
                        build_log = _compile(path)
            with trace.setup_span("build.load"):
                lib = _load(path)
                for name in _SIGNATURES:
                    if "_stamped_" not in name:
                        getattr(lib, name)    # every entry point is there
            _lib = lib
    return _lib


def load_variant(sources, defines) -> tuple:
    """(library, nvcc's output or None when loaded as built before) of
    `sources` built with the preprocessor `defines` (such as
    "LSC_CHOL_STAMPS", "LSC_CHOL_MAX_G=0" or "LSC_CHOL_ONE_BLOCK") besides
    NVCC_FLAGS: a measurement build, apart from the package's own library
    (and built while it builds, from another thread).  Raises as
    load_library does."""
    flags = NVCC_FLAGS + tuple(f"-D{d}" for d in defines)
    key = (tuple(sources), flags)
    with _variant_lock:
        if key not in _variants:
            _need_cuda()
            path = library_path(tuple(sources), flags)
            log = None
            with build_lock(path):
                if not path.exists():
                    log = _compile(path, tuple(sources), flags)
            _variants[key] = (_load(path), log)
    return _variants[key]


def launch(entry, device: torch.device, *args) -> int:
    """entry(*args, stream) on `device`'s current stream with `device` the
    current one (a launch goes to the current device); returns entry's
    CUDA error code.  The device guard is entered only when needed and the
    stream read as a raw pointer: the guard and torch.cuda.current_stream
    take 7.5 us of host time a call against 0.2 us on an H100 machine
    (scripts/profile_forest20_torch.py --kernels), and the chol-path IPM
    makes 120 launches a cycle."""
    if device.index == torch.cuda.current_device():
        return entry(*args, torch._C._cuda_getCurrentRawStream(device.index))
    with torch.cuda.device(device):
        return entry(*args, torch._C._cuda_getCurrentRawStream(device.index))
