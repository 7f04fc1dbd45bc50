"""Build and load the port's CUDA sources at first use.

Each ``csrc/*.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``) into a
shared library with a plain C interface, loaded with :mod:`ctypes`.  The
library lands in ``gpyrn_tpu_torch/_build/`` (listed in ``.gitignore``),
named by a hash of the source and the flags, so an edited source is
rebuilt and an unchanged one is reused.  The build writes to a temporary
name and renames it into place, so concurrent first uses cannot load a
half-written file.

Nothing here runs at import: the CPU tests import every module, and the
machine they run on has no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

__all__ = ["NVCC_FLAGS", "BUILD_DIR", "source_path", "library_path",
           "build", "load"]

_PKG = Path(__file__).resolve().parents[1]
BUILD_DIR = _PKG / "_build"

# No --use_fast_math: the float32 path depends on the conditioning margin
# and the float64 path must round like the plain version.  -fmad=false
# keeps a*b+c as two rounded operations, as the plain version's separate
# tensor operations are.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC")

_LOADED: dict = {}


def source_path(name: str) -> Path:
    return _PKG / "csrc" / f"{name}.cu"


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin and on PATH): the "
            "CUDA kernels of gpyrn_tpu_torch are built from source at "
            "first use and need the CUDA toolkit")
    return found


def library_path(name: str) -> Path:
    src = source_path(name)
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless a library built from the same
    source and flags exists; return the library's path.  Raises with
    nvcc's messages if the build fails."""
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source_path(name))]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed to build {source_path(name)} "
            f"(exit {proc.returncode}):\n{proc.stderr}{proc.stdout}")
    os.replace(tmp, out)
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built if needed (once
    per process)."""
    lib = _LOADED.get(name)
    if lib is None:
        lib = _LOADED[name] = ctypes.CDLL(str(build(name)))
    return lib
