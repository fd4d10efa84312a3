"""Build the package's CUDA sources with nvcc and load them with ctypes.

The kernels in ``csrc/`` have a plain C interface, so one ``nvcc -shared``
call builds them without compiling PyTorch's headers.  The build happens at
first use, into ``lsc_planner_tpu_torch/_build/`` (listed in .gitignore),
under a file name keyed by the source and flag hash, so an edited source
is rebuilt and an unchanged one is loaded as it is.
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
SOURCES = ("chol.cu",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_lib = None
# wall seconds of the nvcc call made by this process (None: loaded a
# library built earlier, or nothing loaded yet)
build_seconds = None

_PTR = ctypes.c_void_p
_SIGNATURES = {
    "lsc_chol_factor_solve_f32": [_PTR, _PTR, _PTR, _PTR, ctypes.c_int,
                                  ctypes.c_int, _PTR],
    "lsc_chol_factor_solve_f64": [_PTR, _PTR, _PTR, _PTR, ctypes.c_int,
                                  ctypes.c_int, _PTR],
    "lsc_chol_resolve_f32": [_PTR, _PTR, _PTR, ctypes.c_int, ctypes.c_int,
                             _PTR],
    "lsc_chol_resolve_f64": [_PTR, _PTR, _PTR, ctypes.c_int, ctypes.c_int,
                             _PTR],
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
    global build_seconds
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
           *(str(CSRC_DIR / s) for s in SOURCES)]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError("nvcc failed:\n" + " ".join(cmd) + "\n" +
                               proc.stdout + proc.stderr)
        os.replace(tmp, out)      # atomic: concurrent builders never race
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    build_seconds = time.perf_counter() - t0


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
