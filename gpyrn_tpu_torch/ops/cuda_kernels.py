"""Dense kernel matrices: the hand-written CUDA kernels and their plain twins.

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

Its gradient with respect to ``params`` is a second kernel of the same
source (B1′, :func:`kernel_matrix_grad_cuda`): the contraction
``g[m] = Σᵢⱼ G[i, j] ∂k(t_i − t_j)/∂params[m]`` of the adjoint G with the
kernel's parameter derivatives, where the JAX package takes the gradient
by autodiff through the Pallas kernel.  ``_KernelMatrix`` joins the two
for autograd; the jitter is computed outside it by differentiable tensor
ops, so its gradient is ``trace(G)`` chained through ``k(0)``.  ``t``
takes no gradient (the JAX package differentiates θ only).

:func:`kernel_matrix_cuda` launches the kernel on a CUDA tensor and
raises on anything else.  :func:`kernel_matrix_ref` and
:func:`kernel_matrix_grad_ref` are the plain PyTorch versions: the CPU
path runs the first (and autograd through it), and on the card only the
tests and ``chip_smoke.py`` call them, to compare.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from gpyrn_tpu_torch.ops import _build
from gpyrn_tpu_torch.ops import kernels as _k

__all__ = ["OPCODES", "Program", "cuda_supported", "encode_program",
           "kernel_matrix_ref", "kernel_matrix_cuda",
           "kernel_matrix_grad_ref", "kernel_matrix_grad_cuda", "LAUNCHES",
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
# Tile of both kernels (csrc TILE_X / TILE_Y): B1′ writes one partial row
# per tile.
TILE = 32

# The stationary leaves the kernel evaluates: the Pallas kernel's set
# (``pallas_kernels.py::_SAFE_TAGS``).  WhiteNoise (it branches on the
# input's shape), the derivative kernels and the non-stationary kernels
# take the plain path on every device, as in the JAX package.
_LEAVES = frozenset(OPCODES) - {"+", "*"}

# Launches of each kernel, counted where the kernel is launched.
LAUNCHES = {"kernel_matrix": 0, "kernel_matrix_grad": 0}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def cuda_supported(structure) -> bool:
    """Whether a kernel structure runs through the CUDA kernel."""
    tag = structure[0]
    if tag in ("+", "*"):
        return cuda_supported(structure[1]) and cuda_supported(structure[2])
    return tag in _LEAVES


class Program(NamedTuple):
    """The kernels' postfix program: per entry an op code, a parameter
    offset (leaves read ``params[offset:]``) and, for ``+`` / ``*``, the
    indices of the two entries it combines (−1 at a leaf), which the
    backward kernel walks in reverse; ``depth`` is the deepest stack the
    forward evaluation reaches."""
    ops: list
    offsets: list
    lhs: list
    rhs: list
    depth: int


def encode_program(structure) -> Program:
    """Lower a supported structure tree to the kernels' postfix program."""
    if not cuda_supported(structure):
        raise ValueError(f"structure {structure!r} has no CUDA kernel")
    ops, offsets, lhs, rhs = [], [], [], []

    def emit(op, off, left, right):
        ops.append(op)
        offsets.append(off)
        lhs.append(left)
        rhs.append(right)
        return len(ops) - 1

    def walk(s, off, depth):
        """Emit ``s``; return (its entry's index, the deepest stack)."""
        tag = s[0]
        if tag in ("+", "*"):
            i1, d1 = walk(s[1], off, depth)
            i2, d2 = walk(s[2], off + _k.n_params(s[1]), depth + 1)
            return emit(OPCODES[tag], 0, i1, i2), max(d1, d2)
        return emit(OPCODES[tag], off, -1, -1), depth + 1

    _, depth = walk(structure, 0, 0)
    if len(ops) > MAX_OPS or depth > MAX_STACK:
        raise ValueError(f"structure {structure!r} needs {len(ops)} ops and "
                         f"stack depth {depth}; the kernel takes at most "
                         f"{MAX_OPS} and {MAX_STACK}")
    return Program(ops, offsets, lhs, rhs, depth)


def _jitter(structure, params, t, nugget, jitter_mult):
    """max(nugget, jitter_mult·eps·N·k(0)) as a 0-d tensor on t's device
    (no host synchronisation)."""
    k0 = _k.evaluate(structure, params,
                     r=torch.zeros((), dtype=t.dtype, device=t.device))
    eps = torch.finfo(t.dtype).eps
    # maximum, not clamp_min: at a tie the gradient splits as in JAX
    return torch.maximum(jitter_mult * eps * t.shape[0] * k0,
                         k0.new_full((), nugget))


def kernel_matrix_ref(structure, params, t, nugget, jitter_mult):
    """Plain PyTorch version of the kernel: the dense lag matrix, the
    registry formula on it, and the same jitter on the diagonal."""
    r = t[:, None] - t[None, :]
    K = _k.evaluate(structure, params, r=r)
    jitter = _jitter(structure, params, t, nugget, jitter_mult)
    return K + jitter * torch.eye(t.shape[0], dtype=t.dtype, device=t.device)


def kernel_matrix_grad_ref(structure, params, t, G):
    """Plain PyTorch version of B1′: ``Σᵢⱼ G[i, j] ∂k(t_i − t_j)/∂params``
    (the kernel matrix without its jitter), by autograd through the
    registry formula."""
    p = params.detach().requires_grad_(True)
    with torch.enable_grad():
        K = _k.evaluate(structure, p, r=t[:, None] - t[None, :])
        (g,) = torch.autograd.grad(K, p, grad_outputs=G)
    return g


# the library's entry points per dtype: (B1, B1′)
_SYMBOLS = {torch.float64: ("gpyrn_kernel_matrix_f64",
                            "gpyrn_kernel_matrix_grad_f64"),
            torch.float32: ("gpyrn_kernel_matrix_f32",
                            "gpyrn_kernel_matrix_grad_f32")}


def _function(dtype, grad=False):
    fn = getattr(_build.load("kernel_matrix"), _SYMBOLS[dtype][int(grad)])
    p = ctypes.c_void_p
    if grad:
        fn.argtypes = [ctypes.c_int, p, p, p, p, p, ctypes.c_int,
                       ctypes.c_int, p, p, p, p, ctypes.c_int, p]
    else:
        fn.argtypes = [ctypes.c_int, p, p, p, p, ctypes.c_int, ctypes.c_int,
                       p, p, ctypes.c_int, p]
    fn.restype = ctypes.c_int
    return fn


def _ints(values):
    return (ctypes.c_int * len(values))(*values)


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


def _launch_grad(structure, params, t, G):
    """B1′ on the card: the (n_params,) contraction of G with dK/dparams."""
    prog = encode_program(structure)
    n, n_par = t.shape[0], params.shape[0]
    tiles = -(-n // TILE)
    partial = torch.empty((tiles * tiles, n_par), dtype=t.dtype,
                          device=t.device)
    out = torch.empty((n_par,), dtype=t.dtype, device=t.device)
    err = _function(t.dtype, grad=True)(
        t.device.index, t.data_ptr(), params.data_ptr(), G.data_ptr(),
        partial.data_ptr(), out.data_ptr(), n, n_par, _ints(prog.ops),
        _ints(prog.offsets), _ints(prog.lhs), _ints(prog.rhs), len(prog.ops),
        torch.cuda.current_stream(t.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"kernel_matrix_grad launch failed with CUDA "
                           f"error {err} (N={n}, {t.dtype})")
    LAUNCHES["kernel_matrix_grad"] += 1
    return out


class _KernelMatrix(torch.autograd.Function):
    """K = kernel(t; params) + jitter·I by B1, its backward by B1′; the
    jitter (a 0-d tensor) gets trace(G)."""

    @staticmethod
    def forward(ctx, params, jitter, t, structure):
        prog = encode_program(structure)
        n = t.shape[0]
        out = torch.empty((n, n), dtype=t.dtype, device=t.device)
        err = _function(t.dtype)(
            t.device.index, t.data_ptr(), params.data_ptr(),
            jitter.data_ptr(), out.data_ptr(), n, params.shape[0],
            _ints(prog.ops), _ints(prog.offsets), len(prog.ops),
            torch.cuda.current_stream(t.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"kernel_matrix launch failed with CUDA "
                               f"error {err} (N={n}, {t.dtype})")
        LAUNCHES["kernel_matrix"] += 1
        ctx.save_for_backward(params, t)
        ctx.structure = structure
        return out

    @staticmethod
    def backward(ctx, G):
        params, t = ctx.saved_tensors
        g_params = g_jitter = None
        if ctx.needs_input_grad[0]:
            g_params = _launch_grad(ctx.structure, params, t, G.contiguous())
        if ctx.needs_input_grad[1]:
            g_jitter = torch.diagonal(G).sum()
        return g_params, g_jitter, None, None


def kernel_matrix_cuda(structure, params, t, nugget, jitter_mult):
    """Dense K(t, t) + jitter·I on the card, by the CUDA kernel;
    differentiable with respect to ``params`` (B1′ in the backward).

    ``t`` is a contiguous (N,) float32/float64 CUDA tensor that takes no
    gradient, ``params`` the structure's (n_params,) core parameters on the
    same device in the same dtype.  Launches on the current stream and does
    not synchronise."""
    _check(structure, params, t)
    if t.requires_grad:
        raise ValueError("kernel_matrix_cuda differentiates params only; "
                         "t must not require grad")
    jitter = _jitter(structure, params, t, float(nugget), float(jitter_mult))
    return _KernelMatrix.apply(params, jitter, t, structure)


def kernel_matrix_grad_cuda(structure, params, t, G):
    """B1′ on the card: ``Σᵢⱼ G[i, j] ∂k(t_i − t_j)/∂params`` as an
    (n_params,) tensor (the jitter excluded), for the same arguments as
    :func:`kernel_matrix_cuda` and an (N, N) adjoint ``G`` in t's dtype on
    t's device.  Launches two kernels on the current stream (the
    per-tile partial sums and their fixed-order total) and does not
    synchronise."""
    _check(structure, params, t)
    n = t.shape[0]
    if (not isinstance(G, torch.Tensor) or G.device != t.device
            or G.dtype != t.dtype or tuple(G.shape) != (n, n)):
        raise ValueError(f"G must be an ({n}, {n}) tensor on t's device and "
                         f"in t's dtype")
    return _launch_grad(structure, params, t, G.contiguous())
