"""Dense kernel matrices: the hand-written CUDA kernels and their plain twins.

Replaces ``gpyrn_tpu/ops/pallas_kernels.py::_build`` (the tiled Pallas
kernel; public wrapper ``pallas_kernel_matrix``).  It computes, for one
stationary kernel structure on the (N,) time vector,

    K[i, j] = k(t_i - t_j; params) + (i == j) * jitter,
    jitter  = max(nugget, jitter_mult * eps * N * k(0)),

where ``tr K = N k(0)`` for a stationary kernel, so the jitter needs no
pass over K.  ``jitter_mult`` is ``linalg.F32_JITTER_MULT`` from
``kernel_matrix`` and 0 (the exact nugget) from ``kernel_matrix_plain``.

Neither kernel (``csrc/kernel_matrix.cu``) is bound by its bytes (N² × 8
in float64, 8 MB at N = 1000): an element costs an exp, a sin or a pow and
some divisions in IEEE arithmetic, hundreds of FP64 operations.  So the
design computes each lag once: every leaf is even in r, K and ∂k/∂θ are
symmetric to the bit, and both kernels walk the 32 × 32 tile pairs I ≥ J
only, handing the mirrored tile across through shared memory.  The N × N
lag matrix and the chain of N² temporaries that :func:`kernel_matrix_ref`
writes (one tensor per operation of the formula) never reach device
memory.  The structure tree is lowered here to a postfix program
(:func:`encode_program`); a program that is one leaf, or two leaves joined
by ``+`` or ``*``, runs a kernel instance with everything in registers,
and a longer one an interpreter, so no structure needs its own build.

Its gradient with respect to ``params`` is a second kernel of the same
source (B1′, :func:`kernel_matrix_grad_cuda`): the contraction
``g[m] = Σᵢⱼ G[i, j] ∂k(t_i − t_j)/∂params[m]`` of the adjoint G with the
kernel's parameter derivatives, where the JAX package takes the gradient
by autodiff through the Pallas kernel.  A few persistent blocks per SM
(:func:`grad_blocks`) each write one row of partial sums, and a second
kernel adds the rows in a fixed order: no atomics, the same bits from run
to run.  ``_KernelMatrixStack`` joins the two for autograd; the jitter is
computed outside it by differentiable tensor ops, so its gradient is
``trace(G)`` chained through ``k(0)``.  ``t`` takes no gradient (the JAX
package differentiates θ only).

:func:`kernel_matrix_rows_cuda` builds a lattice, W rows of a list of S
structures, straight into one ``(W, S, N, N)`` tensor (one B1 launch per
slice, one B1′ launch per slice of the adjoint in the backward), which
saves the copy of ``torch.stack``; each structure is checked, and its
jitters computed, once for all W rows.  :func:`kernel_matrix_stack_cuda`
is its one-row case, a ``(B, N, N)`` stack, and :func:`kernel_matrix_cuda`
the one-matrix case.  All three launch on a CUDA tensor and raise on
anything else.  :func:`kernel_matrix_ref`, :func:`kernel_matrix_stack_ref`,
:func:`kernel_matrix_rows_ref` and :func:`kernel_matrix_grad_ref` are the
plain PyTorch versions: the CPU path runs the first three (and autograd
through them), and on the card only the tests and ``chip_smoke.py`` call
them, to compare.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from gpyrn_tpu_torch.ops import _build
from gpyrn_tpu_torch.ops import kernels as _k

__all__ = ["OPCODES", "Program", "cuda_supported", "encode_program",
           "kernel_matrix_ref", "kernel_matrix_cuda",
           "kernel_matrix_stack_ref", "kernel_matrix_stack_cuda",
           "kernel_matrix_rows_ref", "kernel_matrix_rows_cuda",
           "kernel_matrix_grad_ref", "kernel_matrix_grad_cuda",
           "grad_blocks", "LAUNCHES",
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
# Tile of both kernels (csrc TILE), and the cap of B1′'s grid of persistent
# blocks: 8 per SM, twice what an SM holds at once (4 blocks of 256 threads
# at 64 registers); at N = 1000 that is every tile pair.
TILE = 32
GRAD_BLOCKS_PER_SM = 8

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


def tile_pairs(n: int) -> int:
    """The tile pairs (I, J), I ≥ J, both kernels walk for an n × n
    matrix: B1's grid, and the most blocks B1′ takes."""
    tiles = -(-n // TILE)
    return tiles * (tiles + 1) // 2


def grad_blocks(n: int, sm_count: int) -> int:
    """B1′'s grid, and the rows of its partial buffer: persistent blocks,
    ``GRAD_BLOCKS_PER_SM`` per SM, never more than the tile pairs.  It
    depends on n and the card only."""
    return min(tile_pairs(n), GRAD_BLOCKS_PER_SM * sm_count)


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
    (no host synchronisation); for ``params`` of shape (n_params, W), the
    W jitters of its columns."""
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


# The three lookups below are the same on every launch of a fit or a
# gradient call, so each is made once per process and argument.

def _argtypes(grad):
    """The C entry points' arguments (a CPU test reads them off the
    source): device, t, params, jitter | G, [partial,] out, n, n_params,
    [n_blocks,] ops, offs, lhs, rhs, n_ops, stream."""
    p, i = ctypes.c_void_p, ctypes.c_int
    return ([i, p, p, p] + [p] * (1 + int(grad)) + [i, i] + [i] * int(grad)
            + [p, p, p, p, i, p])


@functools.lru_cache(maxsize=None)
def _function(dtype, grad=False):
    fn = getattr(_build.load("kernel_matrix"), _SYMBOLS[dtype][int(grad)])
    fn.argtypes = _argtypes(grad)
    fn.restype = ctypes.c_int
    return fn


def _ints(values):
    return (ctypes.c_int * len(values))(*values)


@functools.lru_cache(maxsize=256)
def _program_args(structure):
    prog = encode_program(structure)
    return (_ints(prog.ops), _ints(prog.offsets), _ints(prog.lhs),
            _ints(prog.rhs), len(prog.ops))


@functools.lru_cache(maxsize=None)
def _sm_count(device_index):
    return torch.cuda.get_device_properties(
        device_index).multi_processor_count


def _check(structure, params, t, rows=False):
    """Refuse what B1 does not take: ``params`` is the structure's 1-D
    parameter tensor, or with ``rows`` a (W, n_params) tensor of them."""
    if not isinstance(t, torch.Tensor) or not t.is_cuda:
        raise ValueError("kernel_matrix_cuda takes CUDA tensors; "
                         "kernel_matrix_ref is the CPU version")
    if t.dtype not in _SYMBOLS:
        raise ValueError(f"kernel_matrix_cuda takes float32 or float64, "
                         f"got {t.dtype}")
    if t.ndim != 1 or t.shape[0] < 1 or not t.is_contiguous():
        raise ValueError(f"t must be a non-empty contiguous 1-D tensor, got "
                         f"shape {tuple(t.shape)}")
    shape = "(W, n_params)" if rows else "1-D"
    if (params.device != t.device or params.dtype != t.dtype
            or params.ndim != 1 + int(rows) or not params.is_contiguous()
            or (rows and params.shape[0] < 1)):
        raise ValueError(f"params must be a contiguous {shape} tensor on "
                         f"t's device and in t's dtype")
    if not cuda_supported(structure):
        raise ValueError(f"structure {structure!r} has no CUDA kernel")
    n_par = _k.n_params(structure)
    if params.shape[-1] != n_par:
        raise ValueError(f"structure {structure!r} takes {n_par} parameters, "
                         f"got {params.shape[-1]}")
    if n_par > MAX_PARAMS:
        raise ValueError(f"structure {structure!r} has {n_par} parameters; "
                         f"the kernel takes at most {MAX_PARAMS}")


def _launch(fn, t, params, jitter, out, n_par, program, stream):
    """B1 on the card: K + jitter·I into ``out``.  ``params``, ``jitter``
    and ``out`` are data pointers (the structure's parameters, its 0-d
    jitter, a contiguous (N, N) slice); ``fn``, ``program`` and ``stream``
    the launch lookups, made once per lattice."""
    n = t.shape[0]
    err = fn(t.device.index, t.data_ptr(), params, jitter, out, n, n_par,
             *program, stream)
    if err != 0:
        raise RuntimeError(f"kernel_matrix launch failed with CUDA "
                           f"error {err} (N={n}, {t.dtype})")
    LAUNCHES["kernel_matrix"] += 1


def _launch_grad(structure, params, t, G):
    """B1′ on the card: the (n_params,) contraction of a contiguous (N, N)
    adjoint G with dK/dparams."""
    n, n_par = t.shape[0], params.shape[0]
    n_blocks = grad_blocks(n, _sm_count(t.device.index))
    partial = torch.empty((n_blocks, n_par), dtype=t.dtype, device=t.device)
    out = torch.empty((n_par,), dtype=t.dtype, device=t.device)
    err = _function(t.dtype, grad=True)(
        t.device.index, t.data_ptr(), params.data_ptr(), G.data_ptr(),
        partial.data_ptr(), out.data_ptr(), n, n_par, n_blocks,
        *_program_args(structure),
        torch.cuda.current_stream(t.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"kernel_matrix_grad launch failed with CUDA "
                           f"error {err} (N={n}, {t.dtype})")
    LAUNCHES["kernel_matrix_grad"] += 1
    return out


class _KernelMatrixStack(torch.autograd.Function):
    """The (W, S, N, N) lattice of K_ws = kernel_s(t; params_s[w]) +
    jitter_s[w]·I: one B1 launch per slice of one buffer; in the backward
    one B1′ launch per slice of G, and trace(G_ws) for each jitter.
    Inputs after ``structures`` are the S contiguous parameter tensors
    (W, n_params_s), then the S contiguous jitter tensors (W,)."""

    @staticmethod
    def forward(ctx, t, structures, *inputs):
        S, n = len(structures), t.shape[0]
        params, jitters = inputs[:S], inputs[S:]
        W = params[0].shape[0]
        out = torch.empty((W, S, n, n), dtype=t.dtype, device=t.device)
        fn = _function(t.dtype)
        stream = torch.cuda.current_stream(t.device).cuda_stream
        size = t.element_size()
        for s, structure in enumerate(structures):
            program = _program_args(structure)
            n_par = params[s].shape[1]
            p0, j0 = params[s].data_ptr(), jitters[s].data_ptr()
            for w in range(W):
                _launch(fn, t, p0 + w * n_par * size, j0 + w * size,
                        out.data_ptr() + (w * S + s) * n * n * size, n_par,
                        program, stream)
        ctx.save_for_backward(t, *params)
        ctx.structures = structures
        return out

    @staticmethod
    def backward(ctx, G):
        t, *params = ctx.saved_tensors
        S, W = len(params), params[0].shape[0]
        G = G.contiguous()
        grads = [None] * (2 * S)
        for s in range(S):
            if ctx.needs_input_grad[2 + s]:
                grads[s] = torch.stack([
                    _launch_grad(ctx.structures[s], params[s][w], t, G[w, s])
                    for w in range(W)])
        if any(ctx.needs_input_grad[2 + S:]):
            traces = torch.diagonal(G, dim1=-2, dim2=-1).sum(-1)   # (W, S)
            for s in range(S):
                if ctx.needs_input_grad[2 + S + s]:
                    grads[S + s] = traces[:, s]
        return (None, None, *grads)


def _check_no_grad(t):
    if t.requires_grad:
        raise ValueError("kernel_matrix_cuda differentiates params only; "
                         "t must not require grad")


def kernel_matrix_cuda(structure, params, t, nugget, jitter_mult):
    """Dense K(t, t) + jitter·I on the card, by the CUDA kernel;
    differentiable with respect to ``params`` (B1′ in the backward).

    ``t`` is a contiguous (N,) float32/float64 CUDA tensor that takes no
    gradient, ``params`` the structure's (n_params,) core parameters on the
    same device in the same dtype.  Launches on the current stream and does
    not synchronise."""
    _check(structure, params, t)
    n = t.shape[0]
    return kernel_matrix_rows_cuda((structure,), (params[None],), t, nugget,
                                   jitter_mult).view(n, n)


def kernel_matrix_stack_ref(structures, params, t, nugget, jitter_mult):
    """Plain PyTorch version of :func:`kernel_matrix_stack_cuda`: the
    per-structure plain versions, stacked."""
    return torch.stack([kernel_matrix_ref(s, p, t, nugget, jitter_mult)
                        for s, p in zip(structures, params)])


def kernel_matrix_rows_ref(structures, params, t, nugget, jitter_mult):
    """Plain PyTorch version of :func:`kernel_matrix_rows_cuda`: the plain
    stack of every row, stacked."""
    return torch.stack([
        kernel_matrix_stack_ref(structures, [p[w] for p in params], t,
                                nugget, jitter_mult)
        for w in range(params[0].shape[0])])


def _count_check(structures, params):
    if not structures or len(structures) != len(params):
        raise ValueError(f"need one parameter tensor per structure and at "
                         f"least one, got {len(structures)} structures and "
                         f"{len(params)} parameter tensors")


def kernel_matrix_stack_cuda(structures, params, t, nugget, jitter_mult):
    """The ``(B, N, N)`` stack of dense K_b(t, t) + jitter_b·I for B kernel
    structures on the card, each built by the CUDA kernel straight into its
    slice of one tensor; differentiable with respect to every ``params[b]``
    (B1′ on the matching slice of the adjoint).  Arguments as
    :func:`kernel_matrix_cuda`, with a sequence of structures and one
    parameter tensor for each: the one-row case of
    :func:`kernel_matrix_rows_cuda`."""
    structures, params = tuple(structures), tuple(params)
    _count_check(structures, params)
    for s, p in zip(structures, params):
        _check(s, p, t)
    return kernel_matrix_rows_cuda(structures, [p[None] for p in params], t,
                                   nugget, jitter_mult)[0]


def kernel_matrix_rows_cuda(structures, params, t, nugget, jitter_mult):
    """The ``(W, S, N, N)`` lattice of dense K_ws(t, t) + jitter_ws·I on
    the card: W rows of the S kernel structures ``structures``, where
    ``params[s]`` is the contiguous (W, n_params_s) tensor of structure s's
    core parameters, one row per lattice row.  One B1 launch per matrix,
    straight into its slice of one tensor; each structure is checked, and
    its W jitters computed, once (no host read).  Differentiable with
    respect to every ``params[s]``; ``t`` as in :func:`kernel_matrix_cuda`.
    """
    structures, params = tuple(structures), tuple(params)
    _count_check(structures, params)
    for s, p in zip(structures, params):
        _check(s, p, t, rows=True)
    if len({p.shape[0] for p in params}) != 1:
        raise ValueError(f"every parameter tensor needs the same rows, got "
                         f"{[p.shape[0] for p in params]}")
    _check_no_grad(t)
    jitters = [_jitter(s, p.T, t, float(nugget), float(jitter_mult))
               .contiguous() for s, p in zip(structures, params)]
    return _KernelMatrixStack.apply(t, structures, *params, *jitters)


def kernel_matrix_grad_cuda(structure, params, t, G):
    """B1′ on the card: ``Σᵢⱼ G[i, j] ∂k(t_i − t_j)/∂params`` as an
    (n_params,) tensor (the jitter excluded), for the same arguments as
    :func:`kernel_matrix_cuda` and an (N, N) adjoint ``G`` in t's dtype on
    t's device.  Launches two kernels on the current stream (the
    per-block partial sums and their fixed-order total) and does not
    synchronise; the same input gives the same bits on one card."""
    _check(structure, params, t)
    n = t.shape[0]
    if (not isinstance(G, torch.Tensor) or G.device != t.device
            or G.dtype != t.dtype or tuple(G.shape) != (n, n)):
        raise ValueError(f"G must be an ({n}, {n}) tensor on t's device and "
                         f"in t's dtype")
    return _launch_grad(structure, params, t, G.contiguous())
