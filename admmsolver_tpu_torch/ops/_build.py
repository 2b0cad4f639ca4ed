"""Build and load the CUDA kernels of the port.

``nvcc`` compiles ``csrc/fused_two_block.cu`` at first use into a shared
library with a plain C interface under ``admmsolver_tpu_torch/_build/``,
named by a hash of the source and flags, and ``ctypes`` loads it.  Nothing
else is built or fetched; a missing compiler, a failed build or a failed
load raises.  Importing this module builds nothing.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "fused_two_block.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME")
    for cand in ((Path(home) / "bin" / "nvcc") if home else None,
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and Path(cand).is_file():
            return str(cand)
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels are built from source at first use")


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """The loaded kernel library, built first if this source has no build.

    The compiler's report (registers, shared memory, spills) is kept
    beside the library as ``<name>.log``.
    """
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode())
    lib_path = BUILD_DIR / f"fused_two_block_{digest.hexdigest()[:16]}.so"
    if not lib_path.exists():
        BUILD_DIR.mkdir(exist_ok=True)
        tmp = BUILD_DIR / f"{lib_path.name}.{os.getpid()}.tmp"
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
                              capture_output=True, text=True)
        lib_path.with_suffix(".log").write_text(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed with exit code {proc.returncode}:\n"
                               f"{proc.stderr}")
        os.replace(tmp, lib_path)
    lib = ctypes.CDLL(str(lib_path))
    ptr, cint = ctypes.c_void_p, ctypes.c_int
    lib.fused_two_block_chunk.argtypes = ([cint] + [ptr] * 13 + [cint] * 7 + [ptr])
    lib.fused_two_block_chunk.restype = cint
    lib.fused_two_block_smem_bytes.argtypes = [cint, cint, cint]
    lib.fused_two_block_smem_bytes.restype = ctypes.c_size_t
    lib.fused_two_block_max_smem.argtypes = [cint, ctypes.POINTER(cint)]
    lib.fused_two_block_max_smem.restype = cint
    lib.fused_two_block_error_string.argtypes = [cint]
    lib.fused_two_block_error_string.restype = ctypes.c_char_p
    return lib
