"""Dense kernel matrices: the hand-written CUDA kernel and its plain twin.

Replaces ``gpyrn_tpu/ops/pallas_kernels.py::_build`` (the tiled Pallas
kernel; public wrapper ``pallas_kernel_matrix``).  It computes, for one
stationary kernel structure on the (N,) time vector,

    K[i, j] = k(t_i - t_j; params) + (i == j) * jitter,
    jitter  = max(nugget, jitter_mult * eps * N * k(0)),

where ``tr K = N k(0)`` for a stationary kernel, so the jitter needs no
pass over K.  ``jitter_mult`` is ``linalg.F32_JITTER_MULT`` from
``kernel_matrix`` and 0 (the exact nugget) from ``kernel_matrix_plain``.

The kernel (``csrc/kernel_matrix.cu``) is bound by its stores: N² × 8
bytes in float64, 8 MB at N = 1000, with a few dozen FP64 operations per
element for the transcendentals.  Its design keeps the N × N lag matrix,
and the chain of N² temporaries that :func:`kernel_matrix_ref` writes
(one tensor per operation of the formula), out of device memory: each
element is formed in registers and stored once.  The structure tree is
lowered here to a postfix program (:func:`encode_program`) that the one
compiled kernel evaluates per element, so no structure needs its own
build.

:func:`kernel_matrix_cuda` launches the kernel on a CUDA tensor and
raises on anything else.  :func:`kernel_matrix_ref` is the plain PyTorch
version: the CPU path runs it, and on the card only the tests and
``chip_smoke.py`` call it, to compare.
"""
from __future__ import annotations

import ctypes

import torch

from gpyrn_tpu_torch.ops import _build
from gpyrn_tpu_torch.ops import kernels as _k

__all__ = ["OPCODES", "cuda_supported", "encode_program",
           "kernel_matrix_ref", "kernel_matrix_cuda", "LAUNCHES",
           "reset_launch_counts"]

# Op codes of the postfix program.  Must equal ``enum Op`` in
# csrc/kernel_matrix.cu (a CPU test compares the two tables).
OPCODES = {
    "+": 0, "*": 1, "C": 2, "SE": 3, "P": 4, "QP": 5, "RQ": 6, "RQP": 7,
    "COS": 8, "EXP": 9, "M32": 10, "M52": 11, "GammaExp": 12, "PW": 13,
    "PAC": 14, "NP": 15, "QNP": 16, "NRQP": 17, "CP": 18, "QCP": 19,
}
# Limits of the kernel's program and parameter buffers (csrc defines).
MAX_OPS = 32
MAX_STACK = 8
MAX_PARAMS = 64

# The stationary leaves the kernel evaluates: the Pallas kernel's set
# (``pallas_kernels.py::_SAFE_TAGS``).  WhiteNoise (it branches on the
# input's shape), the derivative kernels and the non-stationary kernels
# take the plain path on every device, as in the JAX package.
_LEAVES = frozenset(OPCODES) - {"+", "*"}

# Launches of each kernel, counted where the kernel is launched.
LAUNCHES = {"kernel_matrix": 0}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def cuda_supported(structure) -> bool:
    """Whether a kernel structure runs through the CUDA kernel."""
    tag = structure[0]
    if tag in ("+", "*"):
        return cuda_supported(structure[1]) and cuda_supported(structure[2])
    return tag in _LEAVES


def encode_program(structure):
    """Lower a supported structure tree to the kernel's postfix program.

    Returns ``(ops, offsets, depth)``: one op code and one parameter
    offset per entry (leaves push ``k(r)`` with their parameters at
    ``params[offset:]``; ``+`` / ``*`` combine the top two entries), and
    the deepest stack the program reaches."""
    if not cuda_supported(structure):
        raise ValueError(f"structure {structure!r} has no CUDA kernel")
    ops, offsets = [], []

    def walk(s, off, depth):
        tag = s[0]
        if tag in ("+", "*"):
            d1 = walk(s[1], off, depth)
            d2 = walk(s[2], off + _k.n_params(s[1]), depth + 1)
            ops.append(OPCODES[tag])
            offsets.append(0)
            return max(d1, d2)
        ops.append(OPCODES[tag])
        offsets.append(off)
        return depth + 1

    depth = walk(structure, 0, 0)
    if len(ops) > MAX_OPS or depth > MAX_STACK:
        raise ValueError(f"structure {structure!r} needs {len(ops)} ops and "
                         f"stack depth {depth}; the kernel takes at most "
                         f"{MAX_OPS} and {MAX_STACK}")
    return ops, offsets, depth


def _jitter(structure, params, t, nugget, jitter_mult):
    """max(nugget, jitter_mult·eps·N·k(0)) as a 0-d tensor on t's device
    (no host synchronisation)."""
    k0 = _k.evaluate(structure, params,
                     r=torch.zeros((), dtype=t.dtype, device=t.device))
    eps = torch.finfo(t.dtype).eps
    return torch.clamp_min(jitter_mult * eps * t.shape[0] * k0, nugget)


def kernel_matrix_ref(structure, params, t, nugget, jitter_mult):
    """Plain PyTorch version of the kernel: the dense lag matrix, the
    registry formula on it, and the same jitter on the diagonal."""
    r = t[:, None] - t[None, :]
    K = _k.evaluate(structure, params, r=r)
    jitter = _jitter(structure, params, t, nugget, jitter_mult)
    return K + jitter * torch.eye(t.shape[0], dtype=t.dtype, device=t.device)


_SYMBOLS = {torch.float64: "gpyrn_kernel_matrix_f64",
            torch.float32: "gpyrn_kernel_matrix_f32"}


def _function(dtype):
    lib = _build.load("kernel_matrix")
    fn = getattr(lib, _SYMBOLS[dtype])
    p = ctypes.c_void_p
    fn.argtypes = [ctypes.c_int, p, p, p, p, ctypes.c_int, ctypes.c_int,
                   p, p, ctypes.c_int, p]
    fn.restype = ctypes.c_int
    return fn


def _check(structure, params, t):
    if not isinstance(t, torch.Tensor) or not t.is_cuda:
        raise ValueError("kernel_matrix_cuda takes CUDA tensors; "
                         "kernel_matrix_ref is the CPU version")
    if t.dtype not in _SYMBOLS:
        raise ValueError(f"kernel_matrix_cuda takes float32 or float64, "
                         f"got {t.dtype}")
    if t.ndim != 1 or t.shape[0] < 1 or not t.is_contiguous():
        raise ValueError(f"t must be a non-empty contiguous 1-D tensor, got "
                         f"shape {tuple(t.shape)}")
    if (params.device != t.device or params.dtype != t.dtype
            or params.ndim != 1 or not params.is_contiguous()):
        raise ValueError("params must be a contiguous 1-D tensor on t's "
                         "device and in t's dtype")
    if not cuda_supported(structure):
        raise ValueError(f"structure {structure!r} has no CUDA kernel")
    n_par = _k.n_params(structure)
    if params.shape[0] != n_par:
        raise ValueError(f"structure {structure!r} takes {n_par} parameters, "
                         f"got {params.shape[0]}")
    if n_par > MAX_PARAMS:
        raise ValueError(f"structure {structure!r} has {n_par} parameters; "
                         f"the kernel takes at most {MAX_PARAMS}")


class _KernelMatrix(torch.autograd.Function):
    """Forward-only for now: the gradient needs B1's backward kernel (the
    dK/dθ contraction), which comes with the gradient path."""

    @staticmethod
    def forward(ctx, params, t, structure, nugget, jitter_mult):
        ops, offsets, _ = encode_program(structure)
        n = t.shape[0]
        jitter = _jitter(structure, params, t, nugget, jitter_mult)
        out = torch.empty((n, n), dtype=t.dtype, device=t.device)
        fn = _function(t.dtype)
        err = fn(t.device.index, t.data_ptr(), params.data_ptr(),
                 jitter.data_ptr(), out.data_ptr(), n, params.shape[0],
                 (ctypes.c_int * len(ops))(*ops),
                 (ctypes.c_int * len(offsets))(*offsets), len(ops),
                 torch.cuda.current_stream(t.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"kernel_matrix launch failed with CUDA "
                               f"error {err} (N={n}, {t.dtype})")
        LAUNCHES["kernel_matrix"] += 1
        return out

    @staticmethod
    def backward(ctx, grad_out):
        raise NotImplementedError(
            "kernel_matrix_cuda has no backward kernel yet: gradients "
            "through the CUDA kernel-matrix kernel come with the "
            "elbo_value_and_grad port")


def kernel_matrix_cuda(structure, params, t, nugget, jitter_mult):
    """Dense K(t, t) + jitter·I on the card, by the CUDA kernel.

    ``t`` is a contiguous (N,) float32/float64 CUDA tensor, ``params`` the
    structure's (n_params,) core parameters on the same device in the same
    dtype.  Launches on the current stream and does not synchronise."""
    _check(structure, params, t)
    return _KernelMatrix.apply(params, t, structure, float(nugget),
                               float(jitter_mult))
