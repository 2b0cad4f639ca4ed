"""Build and load the CUDA kernels of the port.

Every ``csrc/*.cu`` of the package is one shared library with a plain C
interface.  At first use ``nvcc`` compiles all of them at once (one
process per source, started together) into ``admmsolver_tpu_torch/_build/``,
each named by a hash of its source and the flags, and ``ctypes`` loads
them.  Nothing else is built or fetched; a missing compiler, a failed
build or a failed load raises.  Importing this module builds nothing.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict

_PKG = Path(__file__).resolve().parent.parent
SOURCE_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_PTR, _INT = ctypes.c_void_p, ctypes.c_int
# C interface of each library <name>: its launch function <name>_launch ->
# argument types, result int.  Every library also has <name>_smem_bytes
# (arguments below), <name>_max_smem and <name>_error_string, declared in
# _declare.
_LAUNCH_ARGTYPES = {
    # device, 9 inputs, 4 outputs, B, N, R, n_iters, prox, thin, lanes per
    # block, k-tile depth, stages, cluster size, tensor cores, stream
    "fused_two_block": [_INT] + [_PTR] * 13 + [_INT] * 11 + [_PTR],
    # device, 10 inputs, 6 outputs, B, nl, nw, n_iters, lanes per warp,
    # warps per block, stream
    "fused_spm": [_INT] + [_PTR] * 16 + [_INT] * 6 + [_PTR],
    # device, input, scratch, 2 outputs, batch, n, sweeps, float64, mode,
    # threads, stream
    "jacobi_eigh": [_INT] + [_PTR] * 4 + [_INT] * 6 + [_PTR],
    # device, 8 inputs (AcA, W, C, D, alpha, mu1, mu2, acy), 3 outputs (M,
    # b2, info), B, nl, nc, the strides of alpha, mu1, mu2 and acy's rows,
    # block kernel, stream
    "spm_factor_refresh": [_INT] + [_PTR] * 11 + [_INT] * 8 + [_PTR],
}
# (lanes per block, N, R, k-tile depth, stages, tensor cores); (lanes per
# block, nl, nw); (n, float64, mode); (nl, nc, block kernel)
_SMEM_ARGTYPES = {"fused_two_block": [_INT] * 6, "fused_spm": [_INT] * 3,
                  "jacobi_eigh": [_INT] * 3, "spm_factor_refresh": [_INT] * 3}
# Other functions of a library: name -> argument types (result: int).
_OTHER_ARGTYPES = {
    # device, buffer, floats, passes, rotate, blocks, out, stream
    "fused_two_block": {"fused_two_block_l2_probe": [_INT, _PTR] + [_INT] * 4 + [_PTR] * 2},
    "fused_spm": {},
    "jacobi_eigh": {},
    "spm_factor_refresh": {},
}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME")
    for cand in ((Path(home) / "bin" / "nvcc") if home else None,
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and Path(cand).is_file():
            return str(cand)
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels are built from source at first use")


def _declare(lib: ctypes.CDLL, name: str) -> None:
    launch = getattr(lib, f"{name}_launch")
    launch.argtypes = _LAUNCH_ARGTYPES[name]
    launch.restype = _INT
    smem = getattr(lib, f"{name}_smem_bytes")
    smem.argtypes = _SMEM_ARGTYPES[name]
    smem.restype = ctypes.c_size_t
    limit = getattr(lib, f"{name}_max_smem")
    limit.argtypes = [_INT, ctypes.POINTER(_INT)]
    limit.restype = _INT
    err = getattr(lib, f"{name}_error_string")
    err.argtypes = [_INT]
    err.restype = ctypes.c_char_p
    for other, argtypes in _OTHER_ARGTYPES[name].items():
        fn = getattr(lib, other)
        fn.argtypes = argtypes
        fn.restype = _INT


def _lib_path(src: Path) -> Path:
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{src.stem}_{digest}.so"


def _start_build(src: Path, lib_path: Path):
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = BUILD_DIR / f"{lib_path.name}.{os.getpid()}.tmp"
    proc = subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    return proc, tmp, lib_path


def _finish_builds(running) -> None:
    failed = []
    for proc, tmp, lib_path in running:
        out, err = proc.communicate()
        lib_path.with_suffix(".log").write_text(out + err)
        if proc.returncode != 0:
            failed.append(f"nvcc failed with exit code {proc.returncode} on "
                          f"{lib_path.name}:\n{err}")
        else:
            os.replace(tmp, lib_path)
    if failed:
        raise RuntimeError("\n".join(failed))


@functools.lru_cache(maxsize=None)
def load_libraries() -> Dict[str, ctypes.CDLL]:
    """The loaded kernel libraries by source name (``fused_two_block``,
    ``fused_spm``, ``jacobi_eigh``, ``spm_factor_refresh``), each built
    first if its source has no build.

    The compiler's report (registers, shared memory, spills) is kept
    beside each library as ``<name>_<hash>.log``.
    """
    paths, running = {}, []
    for src in sorted(SOURCE_DIR.glob("*.cu")):
        if src.stem not in _LAUNCH_ARGTYPES:
            raise RuntimeError(f"{src} has no declared C interface")
        paths[src.stem] = _lib_path(src)
        if not paths[src.stem].exists():
            running.append(_start_build(src, paths[src.stem]))
    _finish_builds(running)
    missing = sorted(set(_LAUNCH_ARGTYPES) - set(paths))
    if missing:
        raise RuntimeError(f"no source under {SOURCE_DIR} for {missing}")
    libs = {}
    for name, lib_path in paths.items():
        libs[name] = ctypes.CDLL(str(lib_path))
        _declare(libs[name], name)
    return libs

