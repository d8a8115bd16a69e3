"""Build and load the port's hand-written CUDA kernels.

The sources under ``kernels/csrc/`` are compiled with ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface, loaded with
``ctypes``.  The build happens at first use, never at import, into
``build/repro_torch/`` at the root of the checkout (override with
``REPRO_TORCH_BUILD_DIR``); the library name carries a hash of the
source, so an edited source is rebuilt and a current one is reused.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCE = CSRC / "filter_agg.cu"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")

_P = ctypes.c_void_p
_LL = ctypes.c_longlong
_I = ctypes.c_int
# Every entry point: device, five plane pointers, ..., out, stream.
_PLANES = [_I] + [_P] * 5
SIGNATURES = {
    "batched_filter_agg_launch": _PLANES + [_I] * 3 + [_P] * 6 + [
        _I, _P, _P],
    "filter_agg_launch": _PLANES + [_LL] + [_I] * 8 + [_P, _P],
    "masked_filter_agg_launch": _PLANES + [_I] * 3 + [_P] * 5 + [
        _I, _P, _I, _P, _P, _P],
    "sharded_filter_agg_launch": _PLANES + [_I] * 4 + [_P] * 6 + [
        _I, _P, _P, _P],
    "masked_filter_agg_shape": [_I] * 3 + [_P],
}

_LIB = None
# Filled by the first build or load: library path, whether nvcc ran,
# the seconds it took, and nvcc's output (-Xptxas -v register report).
BUILD_INFO: dict = {}


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError(
        "nvcc not found: the CUDA kernels are built on a machine with "
        "the CUDA toolkit"
    )


def build(verbose_ptxas: bool = True) -> Path:
    """Compile the kernel library if no current build exists; return
    its path."""
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    out_dir = build_dir()
    lib_path = out_dir / f"libfilter_agg_{digest}.so"
    if lib_path.exists():
        BUILD_INFO.update(path=str(lib_path), built=False, seconds=0.0)
        return lib_path
    nvcc = _nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    cmd = [nvcc, *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
           "-Xcompiler", "-fPIC", "-o", tmp, str(SOURCE)]
    if verbose_ptxas:
        cmd[1:1] = ["-Xptxas", "-v"]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, lib_path)  # atomic: concurrent builders agree
    BUILD_INFO.update(path=str(lib_path), built=True, seconds=seconds,
                      log=proc.stdout + proc.stderr)
    return lib_path


def library():
    """The loaded kernel library (built on first call)."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB
