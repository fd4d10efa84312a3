"""Build the package's CUDA sources with nvcc and load them with ctypes.

The kernels in ``csrc/`` have a plain C interface, so nvcc builds them
without compiling PyTorch's headers: one ``nvcc -c`` a source, all started
together, then one ``nvcc -shared`` link.  The build happens at first
use, into ``lsc_planner_tpu_torch/_build/`` (listed in .gitignore), under
a file name keyed by the source and flag hash, so an edited source is
rebuilt and an unchanged one is loaded as it is.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
import time
from pathlib import Path

import torch

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
SOURCES = ("chol.cu", "ipm.cu", "wavefront.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_lib = None
# wall seconds of the nvcc build made by this process, and nvcc's output
# (ptxas: registers, shared memory, spills per kernel); None: loaded a
# library built earlier, or nothing loaded yet
build_seconds = None
build_log = None

_PTR = ctypes.c_void_p
_SIGNATURES = {
    "lsc_chol_factor_solve_f32": [_PTR, _PTR, _PTR, _PTR, ctypes.c_int,
                                  ctypes.c_int, _PTR],
    "lsc_chol_factor_solve_f64": [_PTR, _PTR, _PTR, _PTR, ctypes.c_int,
                                  ctypes.c_int, _PTR],
    "lsc_chol_resolve_f32": [_PTR, _PTR, _PTR, ctypes.c_int, ctypes.c_int,
                             _PTR],
    "lsc_chol_factor_f32": [_PTR, _PTR, ctypes.c_int, ctypes.c_int, _PTR],
    "lsc_chol_factor_f64": [_PTR, _PTR, ctypes.c_int, ctypes.c_int, _PTR],
    "lsc_chol_resolve_f64": [_PTR, _PTR, _PTR, ctypes.c_int, ctypes.c_int,
                             _PTR],
    # 10 inputs, 5 outputs; N, nf, Ru, C, M, n1, iters, correctors; reg,
    # s_min, tol_gap, tol_rp, tol_rd, tol_step; stream
    "lsc_ipm_fused_f32": [_PTR] * 15 + [ctypes.c_int] * 8 +
                         [ctypes.c_float] * 6 + [_PTR],
    # occ, goal, out, steps; N, Z, Y, X, max_iters; stream
    "lsc_wavefront_f32": [_PTR] * 4 + [ctypes.c_int] * 5 + [_PTR],
}


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


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update((CSRC_DIR / name).read_bytes())
    return BUILD_DIR / f"liblsc_kernels_{h.hexdigest()[:16]}.so"


def _compile(out: Path) -> None:
    global build_seconds, build_log
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [os.path.join(tmp, Path(src).stem + ".o") for src in SOURCES]
        cmds = [[_nvcc(), *NVCC_FLAGS, "-c", "-o", obj, str(CSRC_DIR / src)]
                for src, obj in zip(SOURCES, objs)]
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
    build_seconds = time.perf_counter() - t0
    build_log = "".join(logs)


def load_library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed.  Raises
    RuntimeError when there is no CUDA device or no nvcc: the CUDA path
    never falls back to the plain versions."""
    global _lib
    with _lock:
        if _lib is None:
            if not torch.cuda.is_available():
                raise RuntimeError("the CUDA kernels need a CUDA device; "
                                   "torch.cuda.is_available() is False")
            path = library_path()
            if not path.exists():
                _compile(path)
            lib = ctypes.CDLL(str(path))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
    return _lib
