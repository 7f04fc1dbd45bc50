"""Build and load the port's CUDA sources at first use.

Each ``csrc/*.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``) into a
shared library with a plain C interface, loaded with :mod:`ctypes`.  The
library lands in ``gpyrn_tpu_torch/_build/`` (listed in ``.gitignore``),
named by a hash of the source and the flags, so an edited source is
rebuilt and an unchanged one is reused.  The build writes to a temporary
name and renames it into place, so concurrent first uses cannot load a
half-written file.  What nvcc printed (with ``-Xptxas -v``: each kernel
instance's registers, stack frame and spills) is kept beside the library;
:func:`build_log` hands it back and :func:`resource_usage` parses it.

Nothing here runs at import: the CPU tests import every module, and the
machine they run on has no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

__all__ = ["NVCC_FLAGS", "BUILD_DIR", "source_path", "library_path",
           "build", "build_log", "resource_usage", "load"]

_PKG = Path(__file__).resolve().parents[1]
BUILD_DIR = _PKG / "_build"

# No --use_fast_math: the float32 path depends on the conditioning margin
# and the float64 path must round like the plain version.  -fmad=false
# keeps a*b+c as two rounded operations, as the plain version's separate
# tensor operations are.  -Xptxas -v reports every kernel instance's
# resources; --split-compile 0 spreads the instances over the host's cores.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v", "--split-compile", "0")

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
    _log_path(out).write_text(proc.stderr + proc.stdout)
    os.replace(tmp, out)
    return out


def _log_path(library: Path) -> Path:
    return library.with_suffix(".log")


def build_log(name: str) -> str:
    """What nvcc printed when it built ``csrc/<name>.cu`` (built now if
    need be)."""
    return _log_path(build(name)).read_text()


_PTXAS_ENTRY = re.compile(r"Compiling entry function '(?P<entry>\w+)'")
_PTXAS_FRAME = re.compile(
    r"(?P<stack>\d+) bytes stack frame, (?P<stores>\d+) bytes spill stores, "
    r"(?P<loads>\d+) bytes spill loads")
_PTXAS_REGISTERS = re.compile(r"Used (?P<registers>\d+) registers")


def resource_usage(log: str) -> dict:
    """Per kernel of a ``-Xptxas -v`` log: ``{mangled entry name:
    {"registers", "stack_frame", "spill_stores", "spill_loads"}}``."""
    usage: dict = {}
    entry = None
    for line in log.splitlines():
        m = _PTXAS_ENTRY.search(line)
        if m:
            entry = usage.setdefault(m["entry"], {})
            continue
        if entry is None:
            continue
        m = _PTXAS_FRAME.search(line)
        if m:
            entry.update(stack_frame=int(m["stack"]),
                         spill_stores=int(m["stores"]),
                         spill_loads=int(m["loads"]))
        m = _PTXAS_REGISTERS.search(line)
        if m:
            entry["registers"] = int(m["registers"])
    return usage


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built if needed (once
    per process)."""
    lib = _LOADED.get(name)
    if lib is None:
        lib = _LOADED[name] = ctypes.CDLL(str(build(name)))
    return lib
