"""CUDA counts-mode wrap-DP kernel (native/wrap_dp_counts.cu) as a JAX op.

The kernel runs one warp per job with the job's whole DP row in
registers, so a job costs its own rep_len rows and nothing else: no
row bucket, no per-row launch.  The shared library is built from the
committed source with nvcc at first use, into native/build/ (listed in
.gitignore), and registered through jax.ffi for the CUDA platform.
Nothing here is imported or built on other platforms.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading

import jax
import jax.numpy as jnp

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SRC = os.path.join(_REPO, "native", "wrap_dp_counts.cu")
LIB_PATH = os.path.join(_REPO, "native", "build", "libmtr_wrap_dp_cuda.so")
TARGET = "mtr_wrap_dp_counts"
OUT_COLS = 15

_LIB = None
_LOCK = threading.Lock()


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    return path if os.path.exists(path) else (shutil.which("nvcc") or path)


def build(verbose: bool = False) -> str:
    """Compile the kernel library if it is missing or older than its
    source; returns nvcc's diagnostics (ptxas register and spill
    counts when verbose)."""
    if (not verbose and os.path.exists(LIB_PATH)
            and os.path.getmtime(LIB_PATH) >= os.path.getmtime(SRC)):
        return ""
    os.makedirs(os.path.dirname(LIB_PATH), exist_ok=True)
    tmp = f"{LIB_PATH}.{os.getpid()}.tmp"
    cmd = [
        _nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
        "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
        "-I", jax.ffi.include_dir(), "-o", tmp, SRC,
    ]
    if verbose:
        cmd[1:1] = ["-Xptxas", "-v"]
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed ({r.returncode}):\n{r.stderr}")
    os.replace(tmp, LIB_PATH)  # atomic: a concurrent build never sees half a file
    return r.stderr


def load():
    """Build (if needed), load and register the FFI target once."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            build()
            lib = ctypes.CDLL(LIB_PATH)
            jax.ffi.register_ffi_target(
                TARGET, jax.ffi.pycapsule(lib.MtrWrapDpCounts),
                platform="CUDA")
            _LIB = lib
    return _LIB


def loaded() -> bool:
    return _LIB is not None


def counts_cuda(flat, starts, scal, unit):
    """flat (N,) int8 reads, starts (B,) int32 offsets into flat, scal
    (B, 8) int32 [rep_len, unit_len, mg, mp, ip, ...], unit (B, u_pad)
    int8 left-aligned with u_pad <= 512 -> (B, 15) int32 rows in the
    layout of ops/wrap_dp_xla.py."""
    load()
    return jax.ffi.ffi_call(
        TARGET, jax.ShapeDtypeStruct((unit.shape[0], OUT_COLS), jnp.int32),
    )(flat, starts, scal, unit)
